"""The port's ``obs_top`` and ``obs_report`` (``dmlc_tpu_torch/tools``) print
the JAX package's tables for the same inputs: exported metrics text and
worker views, flight-recorder dumps, merged traces and their diff, and a
live status server (the port's plane, fed the same payloads)."""

import json

import pytest

from dmlc_tpu.tools import obs_report as ref_report
from dmlc_tpu.tools import obs_top as ref_top
from dmlc_tpu_torch.obs import flight
from dmlc_tpu_torch.obs.plane import StatusPlane, StatusServer
from dmlc_tpu_torch.tools import obs_report, obs_top

METRICS = "\n".join([
    "# HELP dmlc_feed_consume_ns stage time",
    'dmlc_feed_consume_ns_sum{rank="0"} 4.2e7',
    'dmlc_feed_consume_ns_count{rank="0"} 3',
    'dmlc_feed_consume_ns_sum{rank="1"} 9e7',
    'dmlc_feed_consume_ns_count{rank="1"} 3',
    'dmlc_feed_h2d_bytes_total{rank="0"} 5e8',
    'dmlc_feed_h2d_bytes_total{rank="1"} 2.5e8',
    'dmlc_feed_h2d_mbps_sum{rank="0"} 1600',
    'dmlc_feed_h2d_mbps_count{rank="0"} 2',
    'dmlc_device_hbm_bytes{device="cuda:0",rank="0"} 1.5e8',
    'dmlc_device_live_bytes{device="cuda:0",rank="1"} 7e7',
    'dmlc_xla_compiles_total{fn="linear.step",rank="0"} 2',
    'dmlc_xla_compiles_total{fn="linear.step",rank="1"} 3',
    'dmlc_xla_recompiles_total{fn="linear.step",rank="1"} 1',
    'dmlc_w_esc_total{path="a\\"b",rank="1"} 1',
    "not a metric line",
])

WORKERS = {"world_version": 2, "events": [], "workers": {
    "0": {"info": "epoch=3 job=tenant-b", "epoch": 3, "lag_s": 0.21,
          "straggler": False, "spans": 4, "spans_dropped": 0},
    "1": {"info": "epoch=3", "epoch": 3, "lag_s": 61.02, "straggler": True,
          "spans": 2, "spans_dropped": 1},
    "2": {"info": "epoch=2 job=tenant-a", "epoch": 2, "lag_s": None,
          "straggler": False, "spans": 0, "spans_dropped": 0}}}

GOODPUT = {"ranks": {"0": {"goodput": {"ratio": 0.42}, "binding": "parse",
                           "mfu": 0.031}}}
AUDIT = {"ranks": {"0": {"chains": {"parse": {"n": 5}, "batch": {"n": 2}}},
                   "1": {"chains": {"parse": {"n": 4}}, "diverged": True}}}


def test_parse_metrics_matches_reference():
    assert obs_top.parse_metrics(METRICS) == ref_top.parse_metrics(METRICS)
    assert len(obs_top.parse_metrics(METRICS)) == 14


@pytest.mark.parametrize("extra", [
    {}, {"goodput_obj": GOODPUT}, {"audit_obj": AUDIT},
    {"goodput_obj": GOODPUT, "audit_obj": AUDIT,
     "prev_h2d": {0: 1e8, 1: 2.5e8}, "dt_s": 2.0}])
def test_build_rows_and_table_match_reference(extra):
    rows, h2d = obs_top.build_rows(METRICS, WORKERS, **extra)
    want_rows, want_h2d = ref_top.build_rows(METRICS, WORKERS, **extra)
    assert rows == want_rows and h2d == want_h2d
    assert [r["rank"] for r in rows] == [1, 2, 0]  # unlabeled, then jobs
    for wv in (None, 2):
        assert obs_top.render_table(rows, world_version=wv) \
            == ref_top.render_table(want_rows, world_version=wv)
    assert obs_top.render_table([]) == ref_top.render_table([])


def _dumps(tmp_path):
    """Two ranks' flight dumps written by the port's recorder, with the
    data service's requeue and death events."""
    out = tmp_path / "rec"
    for rank in (0, 2):
        rec = flight.FlightRecorder(str(out), capacity=32, rank=rank)
        rec.note_span({"name": "parse", "ph": "X", "ts": 1.0, "dur": 2.0,
                       "tid": 1})
        rec.note("fault.injected", site="io.read", n=1)
        rec.note("service.worker_dead", worker=1, addr="127.0.0.1:4242")
        rec.note("service.requeue", seq=5, state="leased", worker=1,
                 client=-1, requeues=1, job="tenant-a" if rank else None)
        rec.note("uncaught", error="RuntimeError", message="boom")
        rec.dump("uncaught:RuntimeError" if rank else "manual")
    return out


def _trace(path, scale):
    doc = {"traceEvents": [
        {"name": "step", "ph": "X", "ts": 0, "dur": 4000 * scale, "pid": 0},
        {"name": "step", "ph": "X", "ts": 10, "dur": 1000, "pid": 1},
        {"name": "parse", "ph": "X", "ts": 20, "dur": 300 * scale, "pid": 1},
        {"name": "chunk", "ph": "t", "ts": 30, "id": 4, "pid": 0},
    ]}
    path.write_text(json.dumps(doc))
    return str(path)


def _both(capsys, argv):
    """(port rc, port stdout), (reference rc, reference stdout); the
    source paths in the flight dump lines are the same files."""
    rc = obs_report.main(argv)
    got = capsys.readouterr().out
    ref_rc = ref_report.main(argv)
    want = capsys.readouterr().out
    return (rc, got), (ref_rc, want)


def test_obs_report_files_match_reference(tmp_path, capsys):
    dumps = _dumps(tmp_path)
    a = _trace(tmp_path / "a.json", 1)
    b = _trace(tmp_path / "b.json", 3)
    for argv in (["--flightrec", str(dumps)], ["--trace", a],
                 ["--diff", a, b], ["--flightrec", str(dumps), "--trace", b,
                                    "--diff", b, a]):
        got, want = _both(capsys, argv)
        assert got == want and got[0] == 0, argv
    rc, out = _both(capsys, ["--flightrec", str(dumps)])[0]
    assert "rank 2: reason=uncaught:RuntimeError" in out
    assert "== data service reassignments ==" in out and "job=tenant-a" in out
    rc, out = _both(capsys, ["--diff", a, b])[0]
    assert out.splitlines()[2].startswith("step")  # the biggest eater


def test_obs_report_exit_codes_match_reference(tmp_path, capsys):
    for argv in ([], ["--trace", str(tmp_path / "missing.json")],
                 ["--flightrec", str(tmp_path / "empty")],
                 ["--top"], ["--diff", str(tmp_path / "x"),
                             str(tmp_path / "y")]):
        got, want = _both(capsys, argv)
        assert got == want and got[0] == 2, argv


def _serve_plane(monkeypatch, tmp_path):
    monkeypatch.setenv("DMLC_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DMLC_TPU_PEAK_HBM_GBPS", "100")
    sp = StatusPlane(num_workers=2, heartbeat_gap=60.0)
    sp.audit._out_dir = str(tmp_path)
    base = 1_700_000_000_000_000_000
    for rank in (0, 1):
        for k in range(2):
            sp.note_payload(rank, {
                "epoch": k + 1, "sent_unix_ns": base + k * 10 ** 9,
                "anchor_unix_ns": base, "rtt_ns": 1000,
                "metrics": {
                    "dmlc_fit_steps_total": 8.0 * (k + 1),
                    'dmlc_feed_consume_ns:sum': 4e7 * (k + 1),
                    'dmlc_feed_consume_ns:count': 4.0 * (k + 1),
                    'dmlc_xla_compiles_total{fn="linear.step"}': 1.0,
                    'dmlc_xla_flops{fn="linear.step"}': 1e6,
                    'dmlc_device_hbm_bytes{device="cuda:0"}': 1e8},
                "spans": [{"name": "parse", "ph": "X", "ts": 5.0 + k,
                           "dur": 100.0 * (rank + 1), "pid": 0, "tid": 1}],
                "audit": {"shard": "s", "epoch": 0, "chains": {
                    "parse": {"n": 1, "head": "h", "d": [[k, "ab"]]}}},
            }, base + k * 10 ** 9 + 500)
    sp.set_data_provider(lambda: {
        "chunks": {"total": 2, "queued": 0, "leased": 1, "delivered": 0,
                   "acked": 1},
        "requeued": 1, "rejects": 0, "duplicate_acks": 0,
        "workers": {"0": {"addr": "127.0.0.1:1", "live": True,
                          "lag_s": 0.01, "leased": 1}},
        "lease_table": [{"seq": 1, "state": "leased", "worker": 0,
                         "client": -1, "requeues": 1}],
        "jobs": {"a": {"jid": 0, "chunks": {}}, "b": {"jid": 1,
                                                        "chunks": {}}}})
    srv = StatusServer(sp, port=0)
    srv.start()
    return srv


def test_live_server_reports_match_reference(monkeypatch, tmp_path, capsys):
    srv = _serve_plane(monkeypatch, tmp_path)
    status = "127.0.0.1:%d" % srv.port
    try:
        for argv in (["--once", "--status", status],):
            assert obs_top.main(argv) == 0
            got = capsys.readouterr().out
            assert ref_top.main(argv) == 0
            assert got == capsys.readouterr().out
            assert got.splitlines()[0] == "world_version=0"
        for argv in (["--status", status],
                     ["--status", status, "--top", "--attribution",
                      "--xla", "--audit"]):
            got, want = _both(capsys, argv)
            assert got == want and got[0] == 0, argv
        out = got[1]
        for section in ("== workers ==", "== device telemetry ==",
                        "== obs-top (one frame) ==", "== goodput attribution",
                        "== xla cost attribution ==", "== determinism audit",
                        "== data service ==", "== data service jobs ==",
                        "== critical path"):
            assert section in out, section
    finally:
        srv.close()
    assert obs_top.main(["--once", "--status", status]) == 2
    assert obs_report.main(["--status", status]) == 2
    capsys.readouterr()

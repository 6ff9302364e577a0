"""The port's status plane (``dmlc_tpu_torch/obs/plane.py`` and the
tracker's half in ``tracker/rendezvous.py``) held against the JAX
package's (``dmlc_tpu.obs.plane``) on the CPU:

- ``build_payload`` writes the reference's JSON for the same spans,
  registry and cap (the clock stamps aside);
- the ``/profile`` word round-trips and encodes as the reference's;
- a port ``StatusPlane`` and a reference one fed the same payload dicts
  give equal ``/workers``, merged traces, stage slack, merged metrics,
  goodput, audit and xla views;
- the nine endpoints, their content types, a bad ``/profile`` and the 404;
- an armed and an unarmed tracker;
- a port publisher publishing to the JAX package's tracker and a
  reference publisher to the port's: the wire is the same both ways, the
  profile word included;
- a ``/profile`` request reaching a publisher captures one
  ``torch.profiler`` window;
- ``submit --cluster local --status-port 0``: two port workers publish and
  rank 0 reads every endpoint of the live server.

Trackers bind ports 21900-21919.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import pytest

from dmlc_tpu.obs import plane as ref_plane
from dmlc_tpu.obs.metrics import Registry as RefRegistry
from dmlc_tpu_torch import obs
from dmlc_tpu_torch.obs import plane
from dmlc_tpu_torch.obs.metrics import Registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORTS = dict(port=21900, port_end=21920)


def _get(port, path, timeout=10):
    url = "http://127.0.0.1:%d%s" % (port, path)
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def _span(name, ts_us, dur_us=5.0, tid=1):
    return {"name": name, "ph": "X", "ts": float(ts_us),
            "dur": float(dur_us), "pid": 0, "tid": tid}


def _registries():
    """A port and a reference registry holding the same families."""
    regs = (Registry(), RefRegistry())
    for reg in regs:
        reg.counter("dmlc_t_pl_total", "t").inc(3)
        reg.counter("dmlc_t_lab_total", "t", stage="parse").inc(2)
        reg.gauge("dmlc_t_g_bytes", "t").set(7.5)
        h = reg.histogram("dmlc_t_h_ns", "t")
        for v in (10.0, 20.0, 40.0):
            h.observe(v)
        for i in range(24):
            reg.counter("dmlc_t_fat_%02d_total" % i, "t").inc(i)
    return regs


@pytest.mark.parametrize("cap,nspans", [(1 << 20, 16), (4096, 128),
                                        (2048, 128), (256, 8)])
def test_build_payload_matches_reference(cap, nspans):
    spans = [_span("stage_%03d" % i, i) for i in range(nspans)]
    reg, ref_reg = _registries()
    blob, dropped = plane.build_payload(rank=2, epoch=7, spans=spans,
                                        reg=reg, max_bytes=cap, rtt_ns=11)
    ref_blob, ref_dropped = ref_plane.build_payload(
        rank=2, epoch=7, spans=spans, reg=ref_reg, max_bytes=cap,
        rtt_ns=11)
    got, want = json.loads(blob), json.loads(ref_blob)
    for obj in (got, want):
        assert obj["sent_unix_ns"] > 0 and obj["anchor_unix_ns"] > 0
        obj["sent_unix_ns"] = obj["anchor_unix_ns"] = 0
    assert got == want
    assert dropped == ref_dropped
    assert len(blob) == len(ref_blob)
    assert len(blob) <= cap or (got["spans"] == [] and got["metrics"] == {})


@pytest.mark.parametrize("req,seconds", [(0, 0), (1, 5), (3, 1), (7, 4095),
                                         (9, 9000), (2, -4)])
def test_profile_word_round_trips(req, seconds):
    word = plane.encode_profile_word(req, seconds)
    assert word == ref_plane.encode_profile_word(req, seconds)
    assert plane.decode_profile_word(word) \
        == ref_plane.decode_profile_word(word)
    if req > 0:
        assert plane.decode_profile_word(word) == (
            req, max(0, min(seconds, plane.PROFILE_MAX_S)))
    assert plane.decode_profile_word(-5) == (0, 0)
    assert plane.PAYLOAD_MARK == ref_plane.PAYLOAD_MARK


def _payloads():
    """rank -> [(payload, recv_unix_ns)]: skewed clocks, an RTT, two
    metric snapshots a rank (a goodput window), labeled and histogram
    metrics, a flow pair across ranks, audit chains that fork on rank 1,
    and an xla cost gauge."""
    anchor = 1_700_000_000_000_000_000
    skews = {0: 0, 1: 5_000_000_000, 2: -3_000_000_000}
    out = {}
    for rank, skew in skews.items():
        rows = []
        for k in range(2):
            true_send = anchor + (k + 1) * 10 ** 9
            spans = [_span("stage_a", k * 900 + i * 300 + rank * 100,
                           dur_us=10 * (rank + 1)) for i in range(3)]
            spans.append(_span("step", k * 900 + 50, dur_us=1000 * (rank + 1)))
            if rank == 1 and k == 0:
                spans.append({"name": "chunk", "cat": "dataflow", "ph": "t",
                              "id": 99, "ts": 110.0, "pid": 0, "tid": 7})
            metrics = {
                "dmlc_fit_steps_total": 10.0 * (k + 1),
                'dmlc_w_x_total{k="v"}': 3.0 + k,
                "dmlc_w_h_ns:sum": 5.0 * (k + 1),
                "dmlc_w_h_ns:count": 2.0 * (k + 1),
                'dmlc_xla_flops{fn="linear.step"}': 1e6,
                'dmlc_xla_bytes_accessed{fn="linear.step"}': 2e6,
            }
            payload = {
                "v": 1, "rank": rank, "epoch": k + 1,
                "anchor_unix_ns": anchor + skew,
                "sent_unix_ns": true_send + skew,
                "rtt_ns": 400_000 * k,
                "metrics": metrics, "spans": spans, "spans_dropped": k,
            }
            if k == 1:
                digest = "ab" if rank != 1 else "cd"
                payload["audit"] = {
                    "shard": "s", "epoch": 0, "divergences": 0,
                    "chains": {"parse": {"n": 2, "head": "h%d" % rank,
                                         "d": [[0, "00"], [1, digest]]}}}
            rows.append((payload, true_send))
        out[rank] = rows
    return out


def _feed(sp, now):
    for rank, rows in _payloads().items():
        sp.note_live(rank, now - 1.0, "epoch=2 rank=%d" % rank)
        for payload, recv in rows:
            sp.note_payload(rank, json.loads(json.dumps(payload)), recv)
    sp.note_membership("rebuild", world_version=1, world=3)
    sp.note_membership("join", jobid="7", spare=True)


def test_plane_views_match_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("DMLC_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DMLC_TPU_PEAK_HBM_GBPS", "100")
    monkeypatch.setenv("DMLC_TPU_FLIGHTREC", str(tmp_path))
    now = time.time()
    sp = plane.StatusPlane(num_workers=3, heartbeat_gap=60.0)
    ref = ref_plane.StatusPlane(num_workers=3, heartbeat_gap=60.0)
    sp.audit._out_dir = ref.audit._out_dir = str(tmp_path)
    _feed(sp, now)
    _feed(ref, now)

    def no_clock(workers):
        for v in workers.values():
            assert v["lag_s"] is not None and v["lag_s"] >= 1.0
            v.pop("lag_s")
        return workers

    assert no_clock(sp.workers()) == no_clock(ref.workers())
    assert set(sp.workers()) == {"0", "1", "2"}
    got_m, want_m = sp.membership(), ref.membership()
    for events in (got_m["events"], want_m["events"]):
        for e in events:
            e.pop("unix")
    assert got_m == want_m and got_m["world_version"] == 1
    trace = sp.merged_trace()
    assert trace == ref.merged_trace()
    ts = [e["ts"] for e in trace["traceEvents"]]
    assert ts == sorted(ts) and ts[0] == 0
    assert {e["pid"] for e in trace["traceEvents"]} == {0, 1, 2}
    assert sp.stage_slack() == ref.stage_slack()
    assert sp.stage_slack()["step"]["max_rank"] == 2
    assert sp.merged_metrics_text(Registry()) \
        == ref.merged_metrics_text(RefRegistry())
    assert 'dmlc_w_x_total{k="v",rank="1"} 4' in sp.merged_metrics_text(
        Registry())
    assert sp.goodput_view() == ref.goodput_view()
    assert set(sp.goodput_view()["ranks"]) == {"0", "1", "2"}
    audit_view = sp.audit_view()
    assert audit_view == ref.audit_view()
    assert [(d["stage"], d["rank"], d["seq"])
            for d in audit_view["divergences"]] == [("parse", 1, 1)]
    assert sp.xla_view()["ranks"] == ref.xla_view()["ranks"]
    assert sp.xla_view()["ranks"]["0"]["linear.step"]["flops"] == 1e6
    assert sp.data_view() == ref.data_view() == {"attached": False}
    assert sp.health()["workers_seen"] == ref.health()["workers_seen"] == 3


def test_malformed_payload_ignored():
    sp = plane.StatusPlane(num_workers=1)
    sp.note_payload(0, "not a dict", recv_unix_ns=time.time_ns())
    sp.note_payload(0, {"spans": "nope", "metrics": 3, "sent_unix_ns": 0},
                    time.time_ns())
    assert sp.merged_trace()["traceEvents"] == []


ENDPOINTS = {
    "/healthz": "application/json", "/workers": "application/json",
    "/metrics": "text/plain; version=0.0.4", "/trace": "application/json",
    "/data": "application/json", "/goodput": "application/json",
    "/audit": "application/json", "/xla": "application/json",
    "/profile?seconds=2": "application/json",
}


def test_endpoints_and_404():
    sp = plane.StatusPlane(num_workers=1, heartbeat_gap=60.0)
    sp.note_live(0, time.time(), "epoch=1")
    sp.note_payload(0, {
        "epoch": 1, "sent_unix_ns": time.time_ns(),
        "anchor_unix_ns": time.time_ns(),
        "metrics": {"dmlc_w_e_total": 1.0},
        "spans": [_span("srv_stage", 10)],
    }, recv_unix_ns=time.time_ns())
    sp.set_data_provider(lambda: {"chunks": {"total": 3}})
    srv = plane.StatusServer(sp, port=0)
    srv.start()
    try:
        bodies = {}
        for path, ctype in ENDPOINTS.items():
            status, got_ctype, body = _get(srv.port, path)
            assert status == 200 and got_ctype == ctype, path
            bodies[path] = body
        assert json.loads(bodies["/healthz"])["workers_seen"] == 1
        assert json.loads(bodies["/workers"])["workers"]["0"]["epoch"] == 1
        assert 'dmlc_w_e_total{rank="0"} 1' in bodies["/metrics"].decode()
        assert [e["name"] for e in json.loads(bodies["/trace"])[
            "traceEvents"]] == ["srv_stage"]
        assert json.loads(bodies["/data"]) == {"chunks": {"total": 3},
                                               "attached": True}
        assert json.loads(bodies["/profile?seconds=2"]) == {
            "profile_req": 1, "seconds": 2}
        assert sp.profile_word() == plane.encode_profile_word(1, 2)
        for bad, code in (("/nope", 404), ("/profile?seconds=x", 400),
                          ("/profile?seconds=0", 400)):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(srv.port, bad)
            assert err.value.code == code, bad
    finally:
        srv.close()
    assert not any(t.name == "dmlc-status-http" and t.is_alive()
                   for t in threading.enumerate())


def test_armed_tracker_serves_worker_payloads(monkeypatch):
    from dmlc_tpu_torch.tracker.rendezvous import RabitTracker, send_heartbeat

    monkeypatch.setenv("DMLC_TPU_STATUS_PORT", "0")
    tracker = RabitTracker("127.0.0.1", num_workers=2, **PORTS)
    try:
        assert tracker.status is not None
        envs = tracker.worker_envs()
        assert envs["DMLC_TPU_OBS_PUBLISH"] == 1
        assert envs["DMLC_TPU_STATUS_URI"] == (
            "127.0.0.1:%d" % tracker.status.port)
        tracker.start(2)
        for rank in (0, 1):
            reg = Registry()
            reg.counter("dmlc_w_hb_total", "t").inc(rank + 1)
            blob, _ = plane.build_payload(
                rank=rank, epoch=1, spans=[_span("hb_stage", 100 * rank)],
                reg=reg)
            ack = send_heartbeat("127.0.0.1", tracker.port, rank=rank,
                                 epoch=1, metrics="loss=0.5", obs_json=blob)
            assert ack == 0
        tracker.plane.request_profile(3)
        ack, word = send_heartbeat("127.0.0.1", tracker.port, rank=1,
                                   epoch=1, want_profile=True)
        assert (ack, plane.decode_profile_word(word)) == (0, (1, 3))
        deadline = time.time() + 10
        workers = {}
        while time.time() < deadline:
            workers = json.loads(_get(tracker.status.port,
                                      "/workers")[2])["workers"]
            if len(workers) == 2 and all(v["spans"] >= 1
                                         for v in workers.values()):
                break
            time.sleep(0.02)
        assert set(workers) == {"0", "1"}
        for v in workers.values():
            assert v["payloads"] >= 1 and v["epoch"] == 1
        assert "loss=0.5" in workers["0"]["info"]
        doc = json.loads(_get(tracker.status.port, "/trace")[2])
        assert {e["pid"] for e in doc["traceEvents"]} == {0, 1}
        text = _get(tracker.status.port, "/metrics")[2].decode()
        assert "dmlc_tracker_heartbeats_total" in text
        assert 'dmlc_w_hb_total{rank="1"} 2' in text
    finally:
        tracker.close()
    assert not any(t.name == "dmlc-status-http" and t.is_alive()
                   for t in threading.enumerate())


def test_unarmed_tracker_has_no_plane(monkeypatch):
    from dmlc_tpu_torch.tracker.rendezvous import RabitTracker, send_heartbeat

    monkeypatch.delenv("DMLC_TPU_STATUS_PORT", raising=False)
    tracker = RabitTracker("127.0.0.1", num_workers=1, **PORTS)
    try:
        assert tracker.status is None
        assert tracker.plane is plane.NOOP_PLANE
        envs = tracker.worker_envs()
        assert "DMLC_TPU_OBS_PUBLISH" not in envs
        assert "DMLC_TPU_STATUS_URI" not in envs
        assert not any(t.name == "dmlc-status-http"
                       for t in threading.enumerate())
        tracker.start(1)
        # an unarmed tracker drops a payload and answers word 0
        blob, _ = plane.build_payload(rank=0, reg=Registry())
        assert send_heartbeat("127.0.0.1", tracker.port, 0, obs_json=blob,
                              want_profile=True) == (0, 0)
        deadline = time.time() + 10
        while 0 not in tracker.heartbeats() and time.time() < deadline:
            time.sleep(0.02)
        assert tracker.heartbeats()[0][1] == "epoch=-1"
    finally:
        tracker.close()


def _publish_across(monkeypatch, tracker_pkg, publisher_pkg):
    """A publisher of ``publisher_pkg`` ("port" or "ref") publishing twice
    to an armed tracker of ``tracker_pkg``, with a /profile request
    between: (the tracker's /workers entry, the publisher's captures)."""
    if tracker_pkg == "port":
        from dmlc_tpu_torch.tracker.rendezvous import RabitTracker
    else:
        from dmlc_tpu.tracker.rendezvous import RabitTracker
    if publisher_pkg == "port":
        pub_plane, span, reg = plane, obs.span, Registry()
        from dmlc_tpu_torch.obs import device_telemetry
    else:
        from dmlc_tpu import obs as ref_obs
        from dmlc_tpu.obs import device_telemetry

        pub_plane, span, reg = ref_plane, ref_obs.span, RefRegistry()
    captures = []
    monkeypatch.setattr(device_telemetry, "capture_profile",
                        lambda seconds, req_id=0, **kw: captures.append(
                            (seconds, req_id)))
    monkeypatch.setenv("DMLC_TPU_STATUS_PORT", "0")
    tracker = RabitTracker("127.0.0.1", 1, **PORTS)
    pub = None
    try:
        tracker.start(1)
        pub = pub_plane.ObsPublisher("127.0.0.1", tracker.port, rank=0,
                                     reg=reg, job="tenant-a")
        with span("cross_stage"):
            time.sleep(0.001)
        assert pub.publish(epoch=4) is True
        assert captures == []
        tracker.plane.request_profile(2)
        assert pub.publish(epoch=5) is True
        assert pub._rtt_ns > 0
        deadline = time.time() + 10
        while time.time() < deadline:
            view = tracker.plane.workers().get("0", {})
            if view.get("payloads", 0) >= 2:
                break
            time.sleep(0.02)
        trace = tracker.plane.merged_trace()
        return view, captures, trace
    finally:
        if pub is not None:
            pub.close()
        tracker.close()


@pytest.mark.parametrize("tracker_pkg,publisher_pkg",
                         [("ref", "port"), ("port", "ref"),
                          ("port", "port")])
def test_the_wire_is_the_same_both_ways(monkeypatch, tracker_pkg,
                                        publisher_pkg):
    view, captures, trace = _publish_across(monkeypatch, tracker_pkg,
                                            publisher_pkg)
    assert view["payloads"] == 2 and view["epoch"] == 5
    assert view["info"] == "epoch=5 job=tenant-a"
    assert view["spans"] >= 1
    assert "cross_stage" in [e["name"] for e in trace["traceEvents"]]
    assert captures == [(2, 1)]


def test_default_publisher_follows_the_env(monkeypatch):
    monkeypatch.delenv("DMLC_TPU_OBS_PUBLISH", raising=False)
    monkeypatch.delenv("DMLC_TRACKER_URI", raising=False)
    plane.reset_default_publisher()
    try:
        assert plane.default_publisher() is None
        assert plane.publish_epoch() is False
        # the uri alone is not enough: the tracker must advertise
        monkeypatch.setenv("DMLC_TRACKER_URI", "127.0.0.1")
        plane.reset_default_publisher()
        assert plane.default_publisher() is None
        monkeypatch.setenv("DMLC_TRACKER_PORT", "1")  # nothing listens
        monkeypatch.setenv("DMLC_TASK_ID", "5")
        monkeypatch.setenv("DMLC_TPU_OBS_PUBLISH", "1")
        plane.reset_default_publisher()
        pub = plane.default_publisher()
        assert pub is not None and pub.rank == 5
        # telemetry never wedges the loop: a failed publish is False
        assert pub.publish(epoch=1, timeout=2) is False
    finally:
        plane.reset_default_publisher()


def test_export_epoch_publishes_to_an_armed_tracker(monkeypatch):
    from dmlc_tpu_torch.tracker.rendezvous import RabitTracker

    monkeypatch.setenv("DMLC_TPU_STATUS_PORT", "0")
    tracker = RabitTracker("127.0.0.1", 1, **PORTS)
    try:
        tracker.start(1)
        for key, value in tracker.worker_envs().items():
            monkeypatch.setenv(key, str(value))
        monkeypatch.setenv("DMLC_TASK_ID", "0")
        plane.reset_default_publisher()
        obs.export_epoch()
        obs.export_epoch()
        deadline = time.time() + 10
        while time.time() < deadline:
            view = tracker.plane.workers().get("0", {})
            if view.get("payloads", 0) >= 2:
                break
            time.sleep(0.02)
        # a lost publish shows its cause: retries, give-ups and drops
        assert view["epoch"] == 2 and view["payloads"] == 2, (
            view, _publish_counts(plane.default_publisher()))
        assert any(k.startswith("dmlc_obs_publishes_total")
                   for k in tracker.plane._views[0].metrics)
    finally:
        plane.reset_default_publisher()
        tracker.close()


def _wait_payloads(tracker, want):
    deadline = time.time() + 10
    view = {}
    while time.time() < deadline:
        view = tracker.plane.workers().get("0", {})
        if view.get("payloads", 0) >= want:
            break
        time.sleep(0.02)
    return view


def _publish_counts(pub):
    """(retries, give-ups) at the ``obs.publish`` site, and ``pub``'s
    dropped publishes."""
    from dmlc_tpu_torch.resilience import retry

    st = retry.stats()
    return (st["attempts"].get("obs.publish", 0),
            st["giveups"].get("obs.publish", 0),
            None if pub is None else pub.dropped)


def test_a_failed_heartbeat_is_retried_and_counted(monkeypatch):
    """A heartbeat whose dial is refused once (a loaded host) dials again
    within the publish's timeout, so the epoch's payload reaches the
    tracker once; the retry counts at the ``obs.publish`` retry site. A
    publish whose every dial fails drops its batch and counts it."""
    from dmlc_tpu_torch.tracker import rendezvous
    from dmlc_tpu_torch.tracker.rendezvous import RabitTracker

    monkeypatch.setenv("DMLC_TPU_STATUS_PORT", "0")
    tracker = RabitTracker("127.0.0.1", 1, **PORTS)
    real = rendezvous.socket.create_connection
    dials = []
    refuse = {"first": 1, "all": False}

    def flaky(*args, **kwargs):
        dials.append(1)
        if refuse["all"] or len(dials) <= refuse["first"]:
            raise ConnectionRefusedError("refused under load")
        return real(*args, **kwargs)

    monkeypatch.setattr(rendezvous.socket, "create_connection", flaky)
    pub = None
    try:
        tracker.start(1)
        pub = plane.ObsPublisher("127.0.0.1", tracker.port, 0)
        before = _publish_counts(pub)
        assert pub.publish(epoch=1, timeout=10) is True
        view = _wait_payloads(tracker, 1)
        assert view["payloads"] == 1 and view["epoch"] == 1
        # one retry, no give-up, nothing dropped
        assert len(dials) == 2
        assert _publish_counts(pub) == (before[0] + 1, before[1], before[2])
        # every dial failing drops the batch: the retries, then one
        # give-up and one drop
        refuse["all"] = True
        assert pub.publish(epoch=2, timeout=10) is False
        assert _publish_counts(pub) == (before[0] + plane.PUBLISH_ATTEMPTS,
                                     before[1] + 1, before[2] + 1)
        assert tracker.plane.workers()["0"]["payloads"] == 1
    finally:
        if pub is not None:
            pub.close()
        tracker.close()


def test_a_heartbeat_failing_after_its_send_is_not_sent_again(monkeypatch):
    """A heartbeat that fails once its payload is on the wire (the ack's
    read timing out under load) is not sent again: the tracker has noted
    the payload once, and the publish counts as dropped."""
    from dmlc_tpu_torch.tracker import rendezvous
    from dmlc_tpu_torch.tracker.rendezvous import RabitTracker

    monkeypatch.setenv("DMLC_TPU_STATUS_PORT", "0")
    tracker = RabitTracker("127.0.0.1", 1, **PORTS)
    real = rendezvous.FramedSocket.send_str
    sends = []

    def send_then_time_out(self, text):
        real(self, text)
        if plane.PAYLOAD_MARK in text:
            # the worker gives up on the ack only once the tracker noted
            # the payload, as a slow tracker's late ack does
            sends.append(1)
            _wait_payloads(tracker, len(sends))
            raise socket.timeout("timed out reading the ack")

    monkeypatch.setattr(rendezvous.FramedSocket, "send_str",
                        send_then_time_out)
    pub = None
    try:
        tracker.start(1)
        pub = plane.ObsPublisher("127.0.0.1", tracker.port, 0)
        before = _publish_counts(pub)
        assert pub.publish(epoch=1, timeout=10) is False
        view = _wait_payloads(tracker, 1)
        assert view["payloads"] == 1 and view["epoch"] == 1
        time.sleep(0.3)  # a resend would have reached the tracker by now
        assert tracker.plane.workers()["0"]["payloads"] == 1
        assert len(sends) == 1
        assert _publish_counts(pub) == (before[0], before[1], before[2] + 1)
    finally:
        if pub is not None:
            pub.close()
        tracker.close()


def test_profile_request_captures_torch_profiler(monkeypatch, tmp_path):
    """A /profile?seconds=1 request reaches the publisher on its next
    heartbeat ack and runs one ``torch.profiler`` window, written beside
    the flight-recorder dump as profile-rank0-req1/trace.json."""
    from dmlc_tpu_torch.obs import device_telemetry, flight
    from dmlc_tpu_torch.tracker.rendezvous import RabitTracker

    monkeypatch.setenv("DMLC_TPU_STATUS_PORT", "0")
    monkeypatch.delenv("DMLC_TASK_ID", raising=False)
    flight.configure(str(tmp_path), install=False)
    tracker = RabitTracker("127.0.0.1", 1, **PORTS)
    pub = None
    try:
        tracker.start(1)
        pub = plane.ObsPublisher("127.0.0.1", tracker.port, rank=0)
        status, _, body = _get(tracker.status.port, "/profile?seconds=1")
        assert json.loads(body) == {"profile_req": 1, "seconds": 1}
        assert pub.publish(epoch=1) is True
        out = tmp_path / "profile-rank0-req1" / "trace.json"
        deadline = time.time() + 30
        while not out.exists() and time.time() < deadline:
            time.sleep(0.1)
        # the window itself (on the CPU the capture thread's profiler
        # records no other thread's ops; on the card CUPTI records every
        # kernel: tests/test_torch_cuda.py)
        events = json.loads(out.read_text())["traceEvents"]
        assert any(str(e.get("name", "")).startswith("PyTorch Profiler")
                   for e in events)
        # the same request id is served once
        assert pub.publish(epoch=2) is True
        assert not (tmp_path / "profile-rank0-req2").exists()
    finally:
        if pub is not None:
            pub.close()
        tracker.close()
        deadline = time.time() + 10
        while device_telemetry._capturing and time.time() < deadline:
            time.sleep(0.05)
        flight.reset()


WORKER = textwrap.dedent("""
    import json, os, sys, time, urllib.request
    sys.path.insert(0, {root!r})
    import numpy as np
    from dmlc_tpu_torch import collective, obs
    from dmlc_tpu_torch.obs import plane

    collective.init()
    rank = collective.rank()
    assert plane.default_publisher() is not None, "no obs publish advertised"
    with obs.span("e2e_stage"):
        time.sleep(0.01 * (rank + 1))
    assert plane.publish_epoch(), "obs publish failed"
    collective.allreduce(np.ones(1, dtype=np.float32))  # all published
    if rank == 0:
        status = os.environ["DMLC_TPU_STATUS_URI"]
        def get(path):
            return urllib.request.urlopen("http://%s%s" % (status, path),
                                          timeout=5).read().decode()
        deadline = time.time() + 30
        while time.time() < deadline:
            workers = json.loads(get("/workers"))["workers"]
            if len(workers) == 2 and all(v["spans"] >= 1
                                         for v in workers.values()):
                break
            time.sleep(0.1)
        out = {{"workers": workers}}
        for path in ("/healthz", "/trace", "/goodput", "/audit", "/xla",
                     "/data"):
            out[path] = json.loads(get(path))
        out["/metrics"] = get("/metrics")
        with open({outfile!r}, "w") as fh:
            json.dump(out, fh)
    collective.finalize()
""")


def test_submit_with_status_port_serves_the_job(tmp_path):
    outfile = tmp_path / "endpoints.json"
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(root=str(ROOT), outfile=str(outfile)))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("DMLC_TPU_STATUS_PORT", None)
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit", "--cluster",
         "local", "-n", "2", "--host-ip", "127.0.0.1", "--status-port", "0",
         sys.executable, str(script)],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "status server on http://127.0.0.1:" in proc.stderr
    got = json.loads(outfile.read_text())
    assert got["/healthz"]["status"] == "ok"
    assert got["/healthz"]["workers_seen"] == 2
    assert set(got["workers"]) == {"0", "1"}
    events = got["/trace"]["traceEvents"]
    assert {e["pid"] for e in events if e["name"] == "e2e_stage"} == {0, 1}
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts) and min(ts) == 0
    assert got["/trace"]["metadata"]["merged"] is True
    assert 'rank="1"' in got["/metrics"]
    assert got["/data"] == {"attached": False}

"""The port's metrics registry, exporters, tracer and cross-host snapshot
(``dmlc_tpu_torch/obs``) against the JAX package's ``dmlc_tpu.obs``.

- The same sequence of registry operations on both packages gives
  byte-identical ``prometheus_lines()``, ``summary_line()``, snapshots and
  JSONL lines (apart from the ``ts_unix`` stamp).
- Histogram buckets, cumulative counts and quantiles are exact.
- ``DMLC_TPU_METRICS=0`` hands out the shared no-op child and the
  disabled span/flow path allocates nothing.
- Span and flow events carry the reference's keys, phases and metadata;
  ``flush`` round-trips the buffer through the ``DMLC_TPU_TRACE`` file.
- ``cross_host_snapshot`` over a 2-rank gloo ``DeviceEngine`` (one
  ``python -c`` process a rank) equals the reference's min, median, max,
  sum and mean for the same per-rank values.
"""

import gc
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from dmlc_tpu.obs import aggregate as ref_aggregate
from dmlc_tpu.obs import exporters as ref_exporters
from dmlc_tpu.obs import trace as ref_trace
from dmlc_tpu.obs.metrics import DEFAULT_BUCKETS as REF_BUCKETS
from dmlc_tpu.obs.metrics import Registry as RefRegistry
from dmlc_tpu_torch import obs
from dmlc_tpu_torch.obs import exporters, trace
from dmlc_tpu_torch.obs.metrics import (DEFAULT_BUCKETS, NOOP, Histogram,
                                        Registry)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _drive(reg):
    """One fixed sequence of registry operations (labels with characters
    Prometheus escapes included)."""
    reg.counter("dmlc_feed_batches_total", "batches", feed="f0").inc(3)
    reg.counter("dmlc_feed_batches_total", "batches", feed="f1").add(7)
    reg.counter("dmlc_io_read_bytes_total", "bytes",
                source='in"put\\split\n').inc(12345)
    g = reg.gauge("dmlc_fit_loss_value", "loss", model="linear")
    g.set(0.6931)
    g.inc(0.25)
    g.dec(0.125)
    h = reg.histogram("dmlc_feed_consume_ns", "consume", feed="f0")
    for v in (0, 1, 3, 17, 1000, 65536, 2.5e6, 7e12):
        h.observe(v)
    reg.histogram("dmlc_step_device_ms", "ms", buckets=(0.5, 1, 2, 4.5),
                  model="fm").observe(1.5)
    reg.gauge("dmlc_goodput_ratio_value").set(0.25)


def test_prometheus_summary_and_snapshot_equal_the_reference():
    port, ref = Registry(), RefRegistry()
    _drive(port)
    _drive(ref)
    assert exporters.prometheus_lines(port) == \
        ref_exporters.prometheus_lines(ref)
    assert exporters.summary_line(reg=port) == \
        ref_exporters.summary_line(reg=ref)
    assert exporters.summary_line("dmlc_feed", port) == \
        ref_exporters.summary_line("dmlc_feed", ref)
    assert port.snapshot() == ref.snapshot()
    assert port.flat_values() == ref.flat_values()


def test_jsonl_and_prometheus_files_equal_the_reference(tmp_path):
    port, ref = Registry(), RefRegistry()
    _drive(port)
    _drive(ref)
    for pkg, reg in (("port", port), ("ref", ref)):
        mod = exporters if pkg == "port" else ref_exporters
        for _ in range(2):
            mod.export_jsonl(str(tmp_path / f"{pkg}.jsonl"), reg)
        mod.export_prometheus(str(tmp_path / f"{pkg}.prom"), reg)
    lines = {pkg: [json.loads(line) for line in
                   (tmp_path / f"{pkg}.jsonl").read_text().splitlines()]
             for pkg in ("port", "ref")}
    assert len(lines["port"]) == len(lines["ref"]) == 2
    for got, want in zip(lines["port"], lines["ref"]):
        assert set(got) == set(want) == {"ts_unix", "metrics"}
        assert got["metrics"] == want["metrics"]
    assert (tmp_path / "port.prom").read_bytes() == \
        (tmp_path / "ref.prom").read_bytes()


def test_export_epoch_writes_the_configured_file(tmp_path, monkeypatch):
    reg = Registry()
    _drive(reg)
    monkeypatch.setenv("DMLC_TPU_METRICS_EXPORT", str(tmp_path / "m.prom"))
    line = exporters.export_epoch(reg, log_prefix="dmlc_fit")
    assert line == exporters.summary_line("dmlc_fit", reg)
    text = (tmp_path / "m.prom").read_text()
    assert "# TYPE dmlc_feed_consume_ns histogram" in text
    monkeypatch.setenv("DMLC_TPU_METRICS_EXPORT", str(tmp_path / "m.jsonl"))
    exporters.export_epoch(reg)
    obj = json.loads((tmp_path / "m.jsonl").read_text())
    assert obj["metrics"] == reg.snapshot()


@pytest.mark.parametrize("values", [
    [], [0], [1, 1, 1], [2, 3, 5, 7, 11, 13], [0.5, 1e3, 4 ** 20, 4 ** 21],
    list(np.random.RandomState(0).exponential(1e6, 200)),
])
def test_histogram_buckets_equal_the_reference(values):
    assert DEFAULT_BUCKETS == REF_BUCKETS == tuple(4 ** k for k in range(21))
    port, ref = Registry(), RefRegistry()
    hp = port.histogram("dmlc_x_ns")
    hr = ref.histogram("dmlc_x_ns")
    for v in values:
        hp.observe(v)
        hr.observe(v)
    assert hp.buckets() == hr.buckets()
    assert hp.cumulative() == hr.cumulative()
    assert (hp.count, hp.sum) == (hr.count, hr.sum)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0, 1.5):
        assert hp.quantile(q) == hr.quantile(q)


def test_histogram_rejects_unsorted_buckets():
    from dmlc_tpu_torch.utils import DMLCError

    with pytest.raises(DMLCError, match="sorted"):
        Histogram((3, 1))


def test_disabled_registry_hands_out_the_shared_noop(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_METRICS", "0")
    reg = Registry()
    assert reg.counter("dmlc_a_total") is NOOP
    assert reg.histogram("dmlc_b_ns", feed="x") is NOOP
    assert reg.families() == {}


def test_disabled_hot_path_is_allocation_free(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_METRICS", "0")
    monkeypatch.delenv("DMLC_TPU_TRACE", raising=False)
    reg = Registry()
    c = reg.counter("dmlc_a_total")
    h = reg.histogram("dmlc_b_ns")
    assert obs.span("x") is trace.NOOP_SPAN and obs.new_flow() == 0

    def burst(n=2000):
        for i in range(n):
            c.inc()
            h.observe(i)
            fid = obs.new_flow()
            with obs.span("parse"):
                obs.flow_step(fid, "chunk")
            obs.flow_end(obs.current_flow(), "chunk")

    burst()
    deltas = []
    for _ in range(5):
        gc.collect()
        before = sys.getallocatedblocks()
        burst()
        gc.collect()
        deltas.append(sys.getallocatedblocks() - before)
    assert min(deltas) <= 0


def _trace_events(mod, path):
    """One span holding a flow start, a step span on another flow step,
    and the flow's end, under ``mod``'s tracer writing to ``path``."""
    mod.clear()
    os.environ["DMLC_TPU_TRACE"] = path
    try:
        fid = mod.new_flow()
        with mod.span("io_read", chunk=0, flow=fid):
            mod.flow_start(fid, "chunk")
        with mod.step_span(3, "epoch", model="m"):
            mod.set_current_flow(fid)
            with mod.span("train_step", step=0):
                mod.flow_step(mod.current_flow(), "chunk")
            mod.set_current_flow(0)
        with mod.span("consume", batch=0):
            mod.flow_end(fid, "chunk")
        assert mod.flush() == path
        return mod.events(), fid
    finally:
        del os.environ["DMLC_TPU_TRACE"]
        mod.clear()


def test_span_and_flow_events_have_the_reference_keys(tmp_path):
    got, fid = _trace_events(trace, str(tmp_path / "port.json"))
    want, ref_fid = _trace_events(ref_trace, str(tmp_path / "ref.json"))
    assert fid != 0 and ref_fid != 0
    assert fid & ((1 << 24) - 1) != 0

    def shape(events):
        return [(e["name"], e["ph"], sorted(e), sorted(e.get("args", {})))
                for e in events]

    assert shape(got) == shape(want)
    assert [e["ph"] for e in got if e.get("cat") == "dataflow"] == \
        ["s", "t", "f"]
    assert {e["id"] for e in got if "id" in e} == {fid}
    assert [e for e in got if e["ph"] == "f"][0]["bp"] == "e"
    epoch = [e for e in got if e["name"] == "epoch"][0]
    assert epoch["args"] == {"model": "m", "step": 3}
    port_file = json.loads((tmp_path / "port.json").read_text())
    ref_file = json.loads((tmp_path / "ref.json").read_text())
    assert sorted(port_file) == sorted(ref_file)
    assert port_file["displayTimeUnit"] == ref_file["displayTimeUnit"]
    assert sorted(port_file["metadata"]) == sorted(ref_file["metadata"])


def test_flush_round_trips_the_buffer(tmp_path, monkeypatch):
    path = str(tmp_path / "trace.json")
    monkeypatch.setenv("DMLC_TPU_TRACE", path)
    trace.clear()
    try:
        for i in range(5):
            with obs.span("parse", chunk=i):
                pass
        buffered = trace.events()
        assert trace.flush() == path
        loaded = json.loads(pathlib.Path(path).read_text())
        assert loaded["traceEvents"] == buffered
        assert loaded["metadata"]["anchor_unix_ns"] == trace.anchor_unix_ns()
        # the buffer is kept: a second flush rewrites the whole history
        with obs.span("parse", chunk=5):
            pass
        trace.flush()
        loaded = json.loads(pathlib.Path(path).read_text())
        assert [e["args"]["chunk"] for e in loaded["traceEvents"]] == \
            list(range(6))
    finally:
        trace.clear()


def test_listener_records_without_a_trace_file(monkeypatch):
    monkeypatch.delenv("DMLC_TPU_TRACE", raising=False)
    seen = []
    trace.add_listener(seen.append)
    try:
        with obs.span("stage", rows=3):
            pass
    finally:
        trace.remove_listener(seen.append)
    assert [e["name"] for e in seen] == ["stage"]
    assert trace.events() == []


_RANK = r"""
import json, sys
import numpy as np
import torch.distributed as dist
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from dmlc_tpu_torch.collective import DeviceEngine
from dmlc_tpu_torch.obs import cross_host_snapshot
from dmlc_tpu_torch.obs.metrics import Registry
values = json.loads(sys.argv[4])[rank]
reg = Registry()
for name, v in sorted(values.items()):
    reg.counter(name).inc(v)
reg.histogram("dmlc_feed_consume_ns", feed="f0").observe(100 * (rank + 1))
snap = cross_host_snapshot(DeviceEngine(), reg=reg)
print(json.dumps(snap))
dist.destroy_process_group()
"""

PER_RANK = [{"dmlc_feed_batches_total": 3, "dmlc_io_read_bytes_total": 10},
            {"dmlc_feed_batches_total": 9, "dmlc_io_read_bytes_total": 4}]


class _Replay:
    """A reference engine whose allreduce returns a fixed sum (what a
    real allreduce of every rank's matrix gives)."""

    def __init__(self, rank, world, total=None):
        self.rank, self.world_size, self.total = rank, world, total
        self.seen = None

    def allreduce(self, mat, op="sum"):
        self.seen = np.array(mat)
        if self.total is not None:
            return self.total
        out = np.array(mat)  # capture only: every row carries the crc
        out[:, 0] = mat[self.rank, 0]
        return out


def _reference_snapshot(rank):
    mats = []
    for r in range(2):
        reg = RefRegistry()
        for name, v in sorted(PER_RANK[r].items()):
            reg.counter(name).inc(v)
        reg.histogram("dmlc_feed_consume_ns", feed="f0").observe(
            100 * (r + 1))
        eng = _Replay(r, 2)
        ref_aggregate.cross_host_snapshot(eng, reg=reg)
        mats.append(eng.seen)
    reg = RefRegistry()
    for name, v in sorted(PER_RANK[rank].items()):
        reg.counter(name).inc(v)
    reg.histogram("dmlc_feed_consume_ns", feed="f0").observe(
        100 * (rank + 1))
    return ref_aggregate.cross_host_snapshot(
        _Replay(rank, 2, mats[0] + mats[1]), reg=reg)


def test_cross_host_snapshot_over_gloo_equals_the_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    store = str(tmp_path / "pg")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "2", store,
         json.dumps(PER_RANK)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env, text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    for rank, (out, _err) in enumerate(outs):
        got = json.loads(out.strip().splitlines()[-1])
        want = _reference_snapshot(rank)
        assert got == want
        stats = got["metrics"]["dmlc_feed_batches_total"]
        assert (stats["min"], stats["median"], stats["max"]) == (3, 6, 9)

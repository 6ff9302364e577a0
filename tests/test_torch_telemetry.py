"""The port's device telemetry, step cost records and flight recorder
(``dmlc_tpu_torch/obs/{device_telemetry,xla_cost,flight}.py``,
``models/fitloop.py``) on the CPU.

- ``instrumented_step``: one compile for one bucket however many calls, a
  new signature after the warmup window counted as a recompile (with its
  ``xla.recompile`` flight event), and ``fn`` itself when
  ``DMLC_TPU_DEVICE_TELEMETRY=0``.
- ``xla_cost``: one record a (site, signature), never re-recorded;
  ``bucket_signature`` gives the JAX package's string for the same shapes;
  the CPU dense step's ``flops`` and ``bytes_accessed`` equal a count by
  hand (the ``fused_linear_grads`` formula + each apply op's operand and
  output bytes); the recording changes no output bit.
- ``sample()`` reports no device gauges on the CPU.
- ``FitLoopObs.sample_latency`` does nothing on N−1 of N steps.
- The flight ring keeps the newest records, dumps the reference's layout,
  and an injected fault in a fit leaves ``fault.injected`` in
  ``flightrec-rank0.json``.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dmlc_tpu.obs import flight as ref_flight
from dmlc_tpu.obs import xla_cost as ref_xla_cost
from dmlc_tpu_torch.models.fitloop import FitLoopObs
from dmlc_tpu_torch.models.linear import (make_linear_train_step,
                                          params_from_numpy)
from dmlc_tpu_torch.obs import device_telemetry, flight, xla_cost
from dmlc_tpu_torch.obs.metrics import Registry, registry

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh():
    device_telemetry.reset()
    yield
    device_telemetry.reset()
    flight.reset()


def test_one_compile_per_bucket_and_a_recompile_after_warmup(tmp_path):
    rec = flight.configure(str(tmp_path), capacity=32, rank=0,
                           install=False)
    step = device_telemetry.InstrumentedStep(
        lambda x: x * 2, "t.step", warmup_calls=4, reg=Registry())
    for _ in range(6):
        step(torch.ones(3))
    assert (step.compiles, step.calls) == (1, 6)
    assert step._m_recompiles.value == 0
    step(torch.ones(5))  # a new shape after the warmup window
    assert step.compiles == 2 and step._m_compiles.value == 2
    assert step._m_recompiles.value == 1
    events = [r for r in rec.records() if r["kind"] == "xla.recompile"]
    assert [(e["fn"], e["compiles"], e["calls"]) for e in events] == \
        [("t.step", 2, 7)]
    assert step._h_compile_ns.count == 2


def test_new_signatures_inside_warmup_are_not_anomalies():
    step = device_telemetry.InstrumentedStep(
        lambda x, y=None: x, "t.warm", reg=Registry())
    for n in range(1, 5):
        step(torch.ones(n), y=torch.zeros(2, dtype=torch.int32))
    assert step.compiles == 4 and step._m_recompiles.value == 0


def test_disabled_telemetry_returns_fn_itself(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_DEVICE_TELEMETRY", "0")

    def fn(x):
        return x

    assert device_telemetry.instrumented_step(fn, "t.off") is fn
    assert device_telemetry.h2d_meter(feed="f") is None
    assert device_telemetry.sample() == {"hbm": {}, "live": {}}


@pytest.mark.parametrize("shapes", [
    ((4, 3), (5,)), ((), (7, 2, 1)), ((0,),),
])
def test_bucket_signature_is_the_reference_string(shapes):
    dtypes = (np.float32, np.int32, np.int64)
    arrays = [np.zeros(s, dtypes[i % 3]) for i, s in enumerate(shapes)]
    tensors = [torch.from_numpy(a) for a in arrays]
    got = xla_cost.bucket_signature(({"b": tensors, "a": 3}, None),
                                    {"k": tensors[0]})
    want = ref_xla_cost.bucket_signature(({"b": arrays, "a": 3}, None),
                                         {"k": arrays[0]})
    assert got == want


def _dense_case(rows=64, features=17, seed=0):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(features).astype(np.float32),
              "b": np.float32(0.5)}
    batch = {"x": torch.from_numpy(rng.randn(rows, features).astype(
                 np.float32)),
             "label": torch.from_numpy((rng.rand(rows) > 0.5).astype(
                 np.float32)),
             "weight": torch.ones(rows)}
    return params, batch


def test_dense_step_record_equals_a_count_by_hand():
    rows, features = 64, 17
    params, batch = _dense_case(rows, features)
    step = make_linear_train_step(None, objective="squared",
                                  learning_rate=0.125, layout="dense",
                                  num_features=features, donate_batch=True)
    assert isinstance(step, device_telemetry.InstrumentedStep)
    before = xla_cost.extraction_count()
    p = params_from_numpy(params, "cpu")
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    for _ in range(3):
        p, v, _m = step(p, v, batch)
    assert xla_cost.extraction_count() == before + 1
    rec = xla_cost.per_fn()["linear.step"]
    # fused_linear_grads: 4 operations an element of x; x, label, weight,
    # w, b read and gw + 3 scalars written once
    fused_bytes = 4 * (rows * features + 2 * rows + 2 * features + 4)
    # the apply, op by op (f32; Python scalars carry no bytes):
    # clamp_min(wsum) 4+4, gw/denom 4F+4+4F, 0.0*w 4F+4F, gw+l2w 8F+4F,
    # gb/denom 4+4+4, lr*gw 4F+4F, w.sub_ 8F+4F, lr*gb 4+4, b.sub_ 8+4
    apply_bytes = 48 * features + 44
    assert rec["flops"] == 4 * rows * features
    assert rec["bytes_accessed"] == fused_bytes + apply_bytes
    assert rec["peak_bytes"] == 0 and rec["collective_bytes"] == 0
    assert rec["bucket"] == xla_cost.bucket_signature((p, v, batch))
    flat = registry().flat_values()
    assert flat['dmlc_xla_flops{fn="linear.step"}'] == rec["flops"]
    # the registry is process-wide: other tests' *.step gauges stay out
    own = {k: v for k, v in flat.items() if 'fn="linear.step"' in k}
    assert xla_cost.step_costs(own)["bytes"] == rec["bytes_accessed"]


def test_recording_changes_no_bit():
    params, batch = _dense_case()
    outs = []
    for telemetry in ("1", "0"):
        os.environ["DMLC_TPU_DEVICE_TELEMETRY"] = telemetry
        try:
            step = make_linear_train_step(None, objective="logistic",
                                          layout="dense", num_features=17)
        finally:
            del os.environ["DMLC_TPU_DEVICE_TELEMETRY"]
        p = params_from_numpy(params, "cpu")
        v = {k: torch.zeros_like(t) for k, t in p.items()}
        p, v, m = step(p, v, batch)
        outs.append([p["w"], p["b"], m["loss_sum"]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_collective_bytes_of_a_bucketed_all_reduce(tmp_path):
    import torch.distributed as dist

    from dmlc_tpu_torch.collective.device import bucketed_all_reduce

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        site = device_telemetry.InstrumentedStep(
            lambda a, b: bucketed_all_reduce([a, b]), "t.reduce",
            reg=Registry())
        site(torch.ones(10), torch.ones(3))
    finally:
        dist.destroy_process_group()
    assert xla_cost.per_fn()["t.reduce"]["collective_bytes"] == 13 * 4


def test_cpu_sample_reports_no_device_gauges():
    reg = Registry()
    assert device_telemetry.sample(reg) == {"hbm": {}, "live": {}}
    assert not any(name.startswith("dmlc_device_")
                   for name in reg.families())
    assert device_telemetry.peak_hbm_bytes() == 0


def test_cpu_probes_measure_a_rate():
    assert xla_cost.probed_peak_flops() > 0
    assert xla_cost.probed_hbm_gbps() > 0


def test_sample_latency_skips_n_minus_one_steps(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_STEP_SAMPLE_N", "4")
    fl = FitLoopObs("t", reg=Registry())
    out = {"loss_sum": torch.zeros(())}
    for k in range(1, 12):
        fl.sample_latency(out)
        assert fl._h_step_ms.count == k // 4
    monkeypatch.setenv("DMLC_TPU_STEP_SAMPLE_N", "0")
    off = FitLoopObs("t", reg=Registry())
    assert off._sample_n == 0 and off._h_step_ms is None
    off.sample_latency(out)


def test_flight_ring_keeps_the_newest_and_dumps_the_reference_layout(
        tmp_path):
    rec = flight.configure(str(tmp_path / "a"), capacity=16, rank=3,
                           install=False)
    ref = ref_flight.FlightRecorder(str(tmp_path / "b"), capacity=16,
                                    rank=3)
    for i in range(40):
        rec.note("retry.giveup", site="s", n=i)
        ref.note("retry.giveup", site="s", n=i)
    assert [r["n"] for r in rec.records()] == list(range(24, 40))
    got = json.loads(pathlib.Path(rec.dump("manual")).read_text())
    want = json.loads(pathlib.Path(ref.dump("manual")).read_text())
    assert sorted(got) == sorted(want)
    assert got["records"][0].keys() == want["records"][0].keys()
    assert pathlib.Path(rec.path()).name == "flightrec-rank3.json"
    assert got["reason"] == "manual" and got["capacity"] == 16
    # the first reason wins
    rec.dump("later")
    assert json.loads(pathlib.Path(rec.path()).read_text())["reason"] == \
        "manual"


def test_span_listener_and_metric_deltas_feed_the_ring(tmp_path):
    from dmlc_tpu_torch import obs

    rec = flight.configure(str(tmp_path), capacity=32, rank=0)
    try:
        with obs.span("consume", batch=1, flow=7):
            pass
        reg = Registry()
        reg.counter("dmlc_feed_batches_total").inc(2)
        rec.note_metrics(reg)
        rec.note_metrics(reg)  # nothing moved: no second record
    finally:
        flight.reset()
    kinds = [r["kind"] for r in rec.records()]
    assert kinds == ["span", "metrics"]
    assert rec.records()[0]["flow"] == 7
    assert rec.records()[1]["delta"] == {"dmlc_feed_batches_total": 2.0}


_FAULTY_FIT = r"""
import sys
from dmlc_tpu_torch import collective
from dmlc_tpu_torch.models import LinearLearner
collective.init()
LinearLearner(device="cpu").fit_uri(sys.argv[1], batch_size=4, epochs=1,
                                    layout="csr", num_features=8)
"""


def test_injected_fault_in_a_fit_dumps_the_ring(tmp_path):
    data = tmp_path / "a.svm"
    data.write_text("".join("%d 1:0.5 3:%d\n" % (i % 2, i) for i in range(20)))
    out_dir = tmp_path / "rec"
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               DMLC_TPU_FLIGHTREC=str(out_dir),
               DMLC_TPU_FAULTS="parse.chunk:nth=1")
    proc = subprocess.run([sys.executable, "-c", _FAULTY_FIT, str(data)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and "InjectedFault" in proc.stderr
    dump = json.loads((out_dir / "flightrec-rank0.json").read_text())
    assert dump["reason"] == "uncaught:InjectedFault"
    fired = [r for r in dump["records"] if r["kind"] == "fault.injected"]
    assert [(r["site"], r["n"]) for r in fired] == [("parse.chunk", 1)]


def test_dump_if_injected_follows_the_cause_chain(tmp_path):
    from dmlc_tpu_torch.resilience import InjectedFault

    rec = flight.configure(str(tmp_path), capacity=16, rank=0,
                           install=False)
    assert flight.dump_if_injected(ValueError("x")) is None
    try:
        try:
            raise InjectedFault("at site")
        except InjectedFault as inner:
            raise RuntimeError("gave up") from inner
    except RuntimeError as err:
        path = flight.dump_if_injected(err)
    assert path == rec.path()
    assert json.loads(pathlib.Path(path).read_text())["reason"] == \
        "injected_giveup"


def test_forest_record_is_its_sites_records_summed():
    """``gbdt.forest`` is a composite site: its trees run outside the cost
    mode and its record is the sum of its site calls' records, one
    ``gbdt.grad``, ``gbdt.build_tree`` and ``gbdt.margin_update`` a tree.
    A body op outside those sites (the loss stack, the tree stack) would
    break the equality."""
    from dmlc_tpu_torch.models.gbdt import GBDTLearner

    trees = 3
    rng = np.random.RandomState(5)
    x = rng.rand(256, 4).astype(np.float32)
    y = (x[:, 0] > 0.5).astype(np.float32)
    GBDTLearner(device="cpu", num_trees=trees, max_depth=3, num_bins=16,
                objective="logistic").fit(x, y)
    sites = xla_cost.per_fn()
    inner = ("gbdt.grad", "gbdt.build_tree", "gbdt.margin_update")
    assert xla_cost.extraction_count() == len(inner) + 1
    forest = sites["gbdt.forest"]
    for field in ("flops", "bytes_accessed", "collective_bytes"):
        assert forest[field] == trees * sum(sites[s][field] for s in inner)
    assert forest["bytes_accessed"] > 0 and forest["peak_bytes"] == 0


def test_a_site_keeps_no_reference_to_its_arguments():
    """Reading a call's signature must not build a reference cycle around
    its argument tensors: they are freed when the caller drops them, not
    when the cyclic collector next runs (on the card such a cycle kept a
    GBDT fit's tensors allocated after the fit and raised its peak)."""
    import gc
    import weakref

    step = device_telemetry.InstrumentedStep(
        lambda t: t + 1, "t.refs", reg=Registry())
    gc.disable()
    try:
        x = torch.ones(16)
        ref = weakref.ref(x)
        step(x)  # the recorded first call
        step(x)  # a seen signature
        del x
        assert ref() is None
    finally:
        gc.enable()

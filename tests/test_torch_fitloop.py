"""The observability layer changes no result: the CPU dense, csr, FM and
GBDT fits with every observability setting off, then with all of them
on (metrics, device telemetry with a sample every step, the trace, the
metrics export, the flight recorder, the full audit), give bit-identical
params and losses and the same kernel launch counts. The armed fits leave
what the layer promises: ``dmlc_fit_steps_total`` equal to the steps
taken, a goodput window an epoch with its binding verdict, a trace
whose io_read → parse → stage → consume → train_step spans share flow
ids, parseable exports, and ``FitLoopObs.end_epoch``'s unified log line
(stall breakdown, goodput, binding)."""

import json
import logging

import numpy as np
import pytest
import torch

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.models import FMLearner, GBDTLearner, LinearLearner
from dmlc_tpu_torch.obs import audit, device_telemetry, flight, trace
from dmlc_tpu_torch.ops import kernels

OFF = {"DMLC_TPU_METRICS": "0", "DMLC_TPU_DEVICE_TELEMETRY": "0",
       "DMLC_TPU_AUDIT": "off", "DMLC_TPU_STEP_SAMPLE_N": "0"}
ARMED = ("DMLC_TPU_TRACE", "DMLC_TPU_METRICS_EXPORT", "DMLC_TPU_FLIGHTREC")


def _arm(monkeypatch, tmp_path, on):
    """Every observability setting off, or every one on (the files under
    ``tmp_path``); the cached auditor, recorder and cost records reset."""
    for key in ARMED:
        monkeypatch.delenv(key, raising=False)
    if on:
        for key, val in {"DMLC_TPU_METRICS": "1",
                         "DMLC_TPU_DEVICE_TELEMETRY": "1",
                         "DMLC_TPU_AUDIT": "full",
                         "DMLC_TPU_STEP_SAMPLE_N": "1",
                         "DMLC_TPU_TRACE": str(tmp_path / "trace.json"),
                         "DMLC_TPU_METRICS_EXPORT":
                             str(tmp_path / "metrics.jsonl"),
                         "DMLC_TPU_FLIGHTREC": str(tmp_path / "rec")
                         }.items():
            monkeypatch.setenv(key, val)
    else:
        for key, val in OFF.items():
            monkeypatch.setenv(key, val)
    audit.reset_auditor()
    flight.reset()
    device_telemetry.reset()
    trace.clear()
    kernels.reset_launch_counts()


@pytest.fixture
def restore():
    yield
    audit.reset_auditor()
    flight.reset()
    device_telemetry.reset()
    trace.clear()


def _write_svm(path, rows=300, nf=12, seed=1):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        ids = np.sort(rng.choice(np.arange(1, nf), rng.randint(1, 6),
                                 replace=False))
        lines.append("%d %s" % (rng.randint(0, 2), " ".join(
            "%d:%.4f" % (j, rng.randn()) for j in ids)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _write_libfm(path, rows=300, seed=2):
    rng = np.random.RandomState(seed)
    path.write_text("".join("%d %s\n" % (rng.randint(0, 2), " ".join(
        "%d:%d:%.4f" % (rng.randint(0, 3), rng.randint(0, 40), rng.rand())
        for _ in range(rng.randint(1, 5)))) for _ in range(rows)))
    return str(path)


def _linear(layout):
    def run(path):
        learner = LinearLearner(device="cpu", momentum=0.5)
        history = learner.fit_uri(path, batch_size=32, epochs=2,
                                  layout=layout, num_features=12,
                                  log_every=1)
        return history, {k: v.clone() for k, v in learner.params.items()}
    return run


def _fm(path):
    learner = FMLearner(device="cpu", num_features=40, num_factors=4)
    feed = DeviceFeed(create_parser(path, 0, 1, "libfm", device="cpu"),
                      BatchSpec(batch_size=32, layout="csr",
                                num_features=40), device="cpu")
    try:
        history = learner.fit_feed(feed, epochs=2, log_every=1)
    finally:
        feed.close()
    return history, {k: v.clone() for k, v in learner.params.items()}


def _gbdt(path):
    learner = GBDTLearner(device="cpu", num_trees=3, max_depth=3,
                          num_bins=16, subsample=0.75)
    history = learner.fit_uri(path, num_features=12)
    return history, {k: v.clone() for k, v in learner.trees.items()}


FITS = {"dense": (_linear("dense"), "svm", 2),
        "csr": (_linear("csr"), "svm", 2),
        "fm": (_fm, "libfm", 2),
        "gbdt": (_gbdt, "svm", 1)}


def _steps(name, history):
    """Steps the fit took: batches of 32 over 300 rows an epoch, or
    trees."""
    return len(history) if name == "gbdt" else 10 * len(history)


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_bit_identical_with_the_layer_off_and_armed(
        tmp_path, monkeypatch, restore, caplog, name):
    run, fmt, epochs = FITS[name]
    path = (_write_libfm(tmp_path / "a.libfm") if fmt == "libfm"
            else _write_svm(tmp_path / "a.svm"))
    results = {}
    for on in (False, True):
        _arm(monkeypatch, tmp_path, on)
        before = obs.registry().flat_values()
        with caplog.at_level(logging.INFO):
            caplog.clear()
            history, params = run(path)
        launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
        results[on] = (history, params, launches)
        if on:
            obs.flush_trace()
            # the registry is process-wide: read this fit's deltas
            flat = {k: v - before.get(k, 0.0)
                    for k, v in obs.registry().flat_values().items()}
            messages = [r.getMessage() for r in caplog.records]
    (h_off, p_off, l_off), (h_on, p_on, l_on) = results[False], \
        results[True]
    assert h_off == h_on
    assert p_off.keys() == p_on.keys()
    for k in p_off:
        assert torch.equal(p_off[k], p_on[k]), k
    assert l_off == l_on

    model = "linear" if name in ("dense", "csr") else name
    assert flat['dmlc_fit_steps_total{model="%s"}' % model] == \
        _steps(name, h_on)
    assert flat['dmlc_fit_epochs_total{model="%s"}' % model] == epochs
    assert "dmlc_goodput_ratio_value" in flat  # a ledger window closed
    json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[-1])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"io_read", "parse"} <= names
    snap = audit.auditor().snapshot()
    assert snap["divergences"] == []
    if name == "gbdt":
        assert {"bin_block", "fit"} <= names
        return
    assert {"stage", "consume", "train_step", "epoch"} <= names
    # one chunk's flow links its io_read, parse, stage, consume and
    # train_step slices (flow points bind to the slice open on their
    # thread at their time)
    flows = {}
    for e in events:
        if e.get("cat") == "dataflow":
            flows.setdefault(e["id"], []).append(e)
    assert flows
    slices = [e for e in events if e["ph"] == "X"]

    def enclosing(point):
        return {s["name"] for s in slices
                if s["tid"] == point["tid"]
                and s["ts"] <= point["ts"] <= s["ts"] + s["dur"]}

    chain = set()
    for point in next(iter(flows.values())):
        chain |= enclosing(point)
    assert {"io_read", "parse", "stage", "consume", "train_step"} <= chain
    unified = [m for m in messages if " epoch 1 " in m + " "
               and "goodput" in m]
    assert unified, messages
    assert "feed[" in unified[0] and "host_batch" in unified[0]
    assert "binding=" in unified[0] and "parse[" in unified[0]
    assert snap["chains"]["model"] == epochs

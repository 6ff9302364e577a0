"""The tracer's capture gate and device spans, and the spans and epoch
times of the FM step, the GBDT fit and the feed (``dmlc_tpu_torch/obs/
trace.py``, ``models/fm.py``, ``models/gbdt.py``, ``device/feed.py``).

On the CPU a device span's time is its host duration, so its totals are
checked here; the CUDA events' reading is checked on the card in
``tests/test_torch_cuda.py``.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.models import (FMLearner, GBDTLearner,
                                   fm_params_from_numpy, fm_params_to_numpy,
                                   init_fm_params)
from dmlc_tpu_torch.obs import trace

FM_SPANS = ("fm.margin", "fm.scatter", "fm.update")
GBDT_PREP = ("gbdt.copy_x", "gbdt.edges", "gbdt.bin")


@pytest.fixture
def quiet(monkeypatch):
    """No trace file and no listener: only a capture can arm spans."""
    monkeypatch.delenv("DMLC_TPU_TRACE", raising=False)
    monkeypatch.setattr(trace, "_listeners", [])
    trace.clear()
    yield
    trace.clear()


@pytest.fixture
def armed(quiet):
    """Spans armed by a listener that keeps every event."""
    seen = []
    trace.add_listener(seen.append)
    return seen


def _capture(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events()]


def _write_libfm(path, rows, nf, seed):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        ids = np.sort(rng.choice(np.arange(1, nf), 6, replace=False))
        vals = rng.rand(6)
        label = int((ids[0] % 3 == ids[1] % 3) ^ (vals[0] > 0.8))
        lines.append("%d %s" % (label, " ".join(
            "%d:%d:%.5f" % (f, j, v)
            for f, (j, v) in enumerate(zip(ids, vals)))))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _feed(path, nf, batch_size=32):
    return DeviceFeed(create_parser(path, 0, 1, "libfm", device="cpu"),
                      BatchSpec(batch_size=batch_size, layout="csr",
                                num_features=nf), device="cpu")


def test_spans_are_the_shared_noop_when_nothing_arms_them(quiet):
    assert obs.span("x") is trace.NOOP_SPAN
    assert obs.step_span(3) is trace.NOOP_SPAN
    assert obs.device_span("x", torch.device("cpu")) is trace.NOOP_SPAN
    assert obs.device_span("x") is trace.NOOP_SPAN
    with obs.device_span("x", "cpu"):
        pass
    assert trace.resolve_device_spans() == 0
    assert trace.device_span_totals() == {}


def test_a_capture_alone_arms_bare_ranges(quiet):
    def run():
        with obs.span("probe.span", chunk=1):
            torch.ones(4).add_(1)
        with obs.step_span(7, "probe.step"):
            torch.ones(4).add_(1)
        with obs.device_span("probe.device", "cpu"):
            torch.ones(4).add_(1)

    _, names = _capture(run)
    for name in ("probe.span", "probe.step", "probe.device"):
        assert name in names
    # no event, no buffer: the capture holds the ranges alone
    assert trace.events() == []
    assert obs.span("probe.span") is trace.NOOP_SPAN
    trace.resolve_device_spans()
    assert trace.device_span_totals()["probe.device"]["count"] == 1


def test_device_span_totals_count_and_add_up_on_the_cpu(armed):
    t0 = time.perf_counter()
    for _ in range(3):
        with obs.device_span("a", "cpu"):
            time.sleep(0.002)
    with obs.device_span("b", "cpu", depth=2):
        pass
    wall_ms = (time.perf_counter() - t0) * 1e3
    assert trace.device_span_totals() == {}  # the pairs wait until resolved
    assert trace.resolve_device_spans() == 0
    totals = trace.device_span_totals()
    assert totals["a"]["count"] == 3 and totals["b"]["count"] == 1
    assert 6.0 <= totals["a"]["ms"] <= wall_ms
    assert totals["b"]["ms"] >= 0.0
    # each event went to the listener, under its name and args
    assert [e["name"] for e in armed] == ["a", "a", "a", "b"]
    assert armed[-1]["args"]["depth"] == 2
    # resolving again adds nothing
    trace.resolve_device_spans()
    assert trace.device_span_totals()["a"]["count"] == 3
    trace.clear()
    assert trace.device_span_totals() == {}


def test_the_bound_resolves_a_full_list_and_never_grows_past_it(
        armed, monkeypatch):
    monkeypatch.setattr(trace, "DEVICE_SPAN_CAP", 4)
    # finished pairs: the span that finds the list full resolves it
    for _ in range(6):
        with obs.device_span("a", "cpu"):
            pass
    assert trace.device_span_totals()["a"]["count"] == 4
    assert trace.resolve_device_spans() == 0
    assert trace.device_span_totals()["a"]["count"] == 6
    trace.clear()
    # pairs the stream has not finished: past the bound a device span is
    # the plain span, its event still recorded but with no pair
    with monkeypatch.context() as unfinished:
        unfinished.setattr(trace._HostMark, "query", lambda self: False)
        for _ in range(6):
            with obs.device_span("b", "cpu"):
                pass
        assert trace.resolve_device_spans() == 4
    assert [e["name"] for e in armed].count("b") == 6
    assert trace.resolve_device_spans() == 0
    assert trace.device_span_totals()["b"]["count"] == 4


def test_a_trace_file_gets_device_ms_in_the_span_args(quiet, monkeypatch,
                                                      tmp_path):
    path = str(tmp_path / "t.json")
    monkeypatch.setenv("DMLC_TPU_TRACE", path)
    with obs.device_span("a", "cpu", depth=1):
        time.sleep(0.001)
    with obs.device_span("b", "cpu"):
        pass
    trace.resolve_device_spans()
    got = {e["name"]: e["args"] for e in trace.events()}
    assert got["a"]["depth"] == 1 and got["a"]["device_ms"] >= 1.0
    assert got["b"]["device_ms"] >= 0.0
    assert trace.flush() == path


def test_fm_fit_under_a_capture_spans_each_step_and_keeps_its_bits(
        quiet, tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")
    nf, rows, batch_size, epochs = 120, 200, 32, 2
    path = _write_libfm(tmp_path / "train.libfm", rows, nf, 5)
    start = fm_params_to_numpy(init_fm_params(nf, 4, 0.1, seed=3,
                                              device="cpu"))

    def fit():
        learner = FMLearner(device="cpu", num_features=nf, num_factors=4,
                            learning_rate=0.2)
        learner.params = fm_params_from_numpy(start, "cpu")
        feed = _feed(path, nf, batch_size)
        try:
            learner.fit_feed(feed, epochs=epochs)
        finally:
            feed.close()
        return fm_params_to_numpy(learner.params)

    plain = fit()
    assert trace.device_span_totals() == {}
    captured, names = _capture(fit)
    steps = epochs * -(-rows // batch_size)
    trace.resolve_device_spans()
    totals = trace.device_span_totals()
    for name in FM_SPANS:
        assert totals[name]["count"] == steps, name
        assert names.count(name) == steps, name
    assert names.count("end_epoch") == epochs
    assert names.count("rewind") == epochs - 1
    for key in ("w", "b", "v"):
        assert np.array_equal(captured[key], plain[key]), key


def test_gbdt_fit_under_a_capture_spans_each_level_and_keeps_its_trees(
        quiet):
    rng = np.random.RandomState(4)
    x = rng.randn(600, 5).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    trees, depth = 3, 3

    def fit():
        learner = GBDTLearner(device="cpu", num_trees=trees,
                              max_depth=depth, num_bins=16)
        history = learner.fit(x, y)
        return history, {k: v.numpy() for k, v in learner.trees.items()}

    plain = fit()
    (history, forest), names = _capture(fit)
    totals = trace.device_span_totals()  # the fit's epoch resolved them
    assert totals["gbdt.histogram"]["count"] == trees * depth
    assert totals["gbdt.splits"]["count"] == trees * depth
    assert totals["gbdt.leaves"]["count"] == trees
    for name in GBDT_PREP:
        assert totals[name]["count"] == 1, name
    assert names.count("gbdt.tree") == trees
    assert names.count("end_epoch") == 1
    assert history == plain[0]
    for key, want in plain[1].items():
        assert np.array_equal(forest[key], want), key


def test_feed_times_its_epoch_restart(armed, tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")
    nf = 60
    path = _write_libfm(tmp_path / "t.libfm", 100, nf, 2)
    feed = _feed(path, nf, batch_size=16)
    try:
        assert sum(1 for _ in feed) == 7
        first = feed.stats()
        feed.before_first()
        assert feed.stats()["restart_ns"] == 0  # no batch handed out yet
        assert sum(1 for _ in feed) == 7
        second = feed.stats()
    finally:
        feed.close()
    assert first["restart_ns"] == 0
    assert isinstance(second["restart_ns"], int)
    # the restart holds the rewind span, then the prefetch window filling
    rewinds = [e for e in armed if e["name"] == "rewind"]
    assert len(rewinds) == 1
    assert 0 < rewinds[0]["dur"] * 1e3 <= second["restart_ns"]

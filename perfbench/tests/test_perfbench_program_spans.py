"""The readers of the program's own spans and feed counters: each on given
readings, each giving None where the program lacks what it reads, and a
small CPU ``--trace 1`` run of each cell that yields them as finite
numbers."""

import json
import math
import time

import pytest
import torch

from perfbench.lib import bench, devtime


def metric(name):
    return bench.load_module("metrics", name)


def test_program_span_and_epoch_readers(monkeypatch):
    from dmlc_tpu_torch.obs import trace

    restart = metric("epoch_restart_ms.fm")
    stats_ = [{"restart_ns": 20e6}, {"restart_ns": 0}, {"restart_ns": 40e6}]
    assert restart.read({"epoch_stats": stats_}) == pytest.approx(30.0)
    assert metric("epoch_restart_ms.fm.text").read(
        {"epoch_stats": stats_}) == pytest.approx(30.0)
    totals = {"fm.scatter": {"count": 4, "ms": 24.0},
              "gbdt.histogram": {"count": 120, "ms": 4800.0},
              "gbdt.copy_x": {"count": 1, "ms": 250.0},
              "gbdt.edges": {"count": 2, "ms": 60.0},
              "gbdt.bin": {"count": 1, "ms": 12.0}}
    resolved = []
    monkeypatch.setattr(trace, "resolve_device_spans",
                        lambda: resolved.append(1) or 0)
    monkeypatch.setattr(trace, "device_span_totals", lambda: dict(totals))
    assert metric("fm_scatter_ms.fm").read({}) == pytest.approx(6.0)
    assert metric("level_histogram_ms.gbdt").read({}) == pytest.approx(40.0)
    # the means, summed: 250 + 60 / 2 + 12
    assert metric("fit_prep_ms.gbdt").read({}) == pytest.approx(292.0)
    assert resolved  # each reader resolved the finished pairs first
    # nothing to read: nothing returned, never 0 (a program without the
    # span or the key)
    assert restart.read({"epoch_stats": [{"host_wait_ns": 1}]}) is None
    assert restart.read({"epoch_stats": [{"restart_ns": 0}]}) is None
    del totals["gbdt.bin"], totals["fm.scatter"]
    assert metric("fit_prep_ms.gbdt").read({}) is None
    assert metric("fm_scatter_ms.fm").read({}) is None
    monkeypatch.delattr(trace, "device_span_totals")
    assert metric("level_histogram_ms.gbdt").read({}) is None


#: each cell at a size the CPU runs in seconds, and the metrics that its
#: --trace 1 run reads from the program
TRACED = {"criteo_fm.recordio": ("epoch_restart_ms.fm", "fm_scatter_ms.fm"),
          "criteo_fm.text": ("epoch_restart_ms.fm.text",),
          "higgs_gbdt.train": ("level_histogram_ms.gbdt",
                               "fit_prep_ms.gbdt")}
SMALL = {"criteo-fm": {"rows": 32768, "num_ids": 100_000,
                       "batch_size": 8192},
         "higgs-gbdt": {"rows": 20_000}}


@pytest.mark.parametrize("cell", sorted(TRACED))
def test_a_traced_cpu_run_reads_the_program_spans(cell, tmp_path, capsys,
                                                  monkeypatch):
    """A --trace 1 run on the CPU: the card's synchronize is a no-op there
    and a kernel alone is timed on the host clock, so every reader runs;
    the program's spans and epoch times give finite numbers."""
    from perfbench import run

    def host_time_alone(fn, args, device, iters=20):
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*args[i % len(args)])
        return (time.perf_counter() - t0) * 1e3 / iters

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(devtime, "time_alone", host_time_alone)
    config = bench.cell(cell)["config"]
    overrides = dict(SMALL[config])
    if config == "criteo-fm":
        overrides["limits"] = dict(bench.config(config)["limits"],
                                   grad_gap=1e-4, change_gap=5e-5)
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 9),
                   "--seconds", "0.5", "--trace", "1"],
                  device=torch.device("cpu"), data_dir=str(tmp_path),
                  overrides=overrides)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in TRACED[cell]:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, name
        assert out["metrics"][name]["unit"] == "ms"

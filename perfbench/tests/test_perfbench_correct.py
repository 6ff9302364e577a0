"""What decides ``correct``, at sizes a test run holds, on the CPU: a
sound run of each cell is correct; the control (the reference in
bfloat16 put in the program's place) is not; and a run with the timed
path broken underneath is not, once for each fault the cell can have
(``perfbench/faults.py``): a step that leaves its state unchanged, half
of the batch left out (the mean taken over the rest), an answer altered
where it is produced, a batch of each epoch left out by the feed."""

import json

import numpy as np
import pytest
import torch

from perfbench import faults, run
from perfbench.gen import higgs
from perfbench.lib import bench
from perfbench.reference import compare
from perfbench.reference import fm as fm_reference
from perfbench.reference import gbdt as gbdt_reference

#: the cells at sizes a test run holds, four FM batches an epoch as the
#: faults need. On the CPU, at this size, a sound FM run's gradient and
#: change read gaps of 1e-7 to 2e-7 (the card's, at the cell's size, under
#: 1e-8), so the FM limits that the readings at this size give stand in
#: for the card's: the altered value reads there under ten times a sound
#: run and is left to ``rows_mismatch``.
SMALL = {"criteo-fm": {"rows": 32768, "num_ids": 100_000, "batch_size": 8192,
                       "limits": dict(bench.config("criteo-fm")["limits"],
                                      grad_gap=1e-4, change_gap=5e-5)},
         "higgs-gbdt": {"rows": 60_000}}
CELLS = ("criteo_fm.text", "criteo_fm.recordio", "higgs_gbdt.train")


def run_cell(cell, seed, tmp_path, capsys):
    config = bench.cell(cell)["config"]
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", "0"], device=torch.device("cpu"),
                  data_dir=str(tmp_path), overrides=SMALL[config])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def limits(config):
    return SMALL[config].get("limits", bench.config(config)["limits"])


def fails(checks: dict, config: str) -> bool:
    lim = limits(config)
    return any(not value <= lim[name] for name, value in checks.items())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, tmp_path, capsys):
    out = run_cell(cell, 2 ** 31 + 5, tmp_path, capsys)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    for entry in out["checks"].values():
        assert set(entry) == {"value", "limit"}


def test_fm_control_is_not_correct():
    cfg = dict(bench.config("criteo-fm"), **SMALL["criteo-fm"])
    for seed in (1, 2, 3):
        job = bench.load_module("jobs", "fm_fit")
        rows = job.make_rows(cfg, seed)
        start = job.start_params(cfg, seed, "cpu")
        args = (rows.labels, rows.ids, rows.values, start,
                cfg["batch_size"], 3, cfg["learning_rate"], cfg["l2"], "cpu")
        ref = fm_reference.sgd_steps(*args)
        control = fm_reference.sgd_steps(*args, dtype=torch.bfloat16)
        checks = compare.sgd_checks(control["loss"], control["params"], ref,
                                    cfg["learning_rate"])
        assert fails(checks, "criteo-fm"), checks


def test_gbdt_control_is_not_correct():
    cfg = dict(bench.config("higgs-gbdt"), **SMALL["higgs-gbdt"])
    job = bench.load_module("jobs", "gbdt_fit")
    for seed in (1, 2, 3):
        x, y = higgs.higgs_rows(cfg["rows"], cfg["features"], seed, "cpu",
                                cfg["data_seed"])
        edges = gbdt_reference.quantile_edges(x, cfg["num_bins"])
        bins = gbdt_reference.bin_rows(x, edges)
        ref = gbdt_reference.boost(bins, y, 3, cfg)
        ctrl = gbdt_reference.boost(bins, y, 3, cfg, dtype=torch.bfloat16)
        trees = {k: np.stack(ctrl[k]) for k in ("feature", "bin", "leaf")}
        # the control's numbers other than the edges: the boosting alone
        checks = job.gbdt_checks(edges, ctrl["loss"], trees, ref, edges,
                                 bins, cfg)
        assert fails(checks, "higgs-gbdt"), checks


def test_fm_digest_of_a_sound_feed_matches_the_rows():
    job = bench.load_module("jobs", "fm_fit")
    cfg = dict(bench.config("criteo-fm"), rows=3 * 1024 + 100,
               num_ids=5000)
    rows = job.make_rows(cfg, 2 ** 31 + 9)
    want = job.rows_digests(rows, 1024)
    fields = rows.ids.shape[1]

    def batch(p):
        lo, hi = p * 1024, min(rows.num_rows, (p + 1) * 1024)
        n, pad = hi - lo, 7  # the feed pads past the rows and entries
        return {"num_rows": n, "num_nonzero": n * fields,
                "label": torch.tensor(np.r_[rows.labels[lo:hi], [9] * pad]
                                      .astype(np.float32)),
                "weight": torch.ones(n + pad),
                "offsets": torch.arange(n + 1 + pad, dtype=torch.int32)
                * fields + 5,
                "indices": torch.tensor(np.r_[rows.ids[lo:hi].ravel(),
                                              [3] * pad]),
                "values": torch.tensor(np.r_[rows.values[lo:hi].ravel(),
                                             [0.5] * pad].astype(np.float32))}

    got = [job.batch_digest(batch(p), p).numpy() for p in range(4)]
    assert np.array_equal(np.stack(got), want)
    full = np.sum(got, axis=0)
    assert job.epoch_mismatch([(4, full), (2, got[0] + got[1])], want) == 0
    assert job.epoch_mismatch([(4, full), (0, None)], want) == 0
    # an epoch short before the last, a batch handed out twice, and two
    # batches swapped each fail
    assert job.epoch_mismatch([(3, full - got[3]), (4, full)], want) == 1
    twice = got[0] + job.batch_digest(batch(0), 1).numpy()
    assert job.epoch_mismatch([(2, twice)], want) == 1
    swapped = job.batch_digest(batch(1), 0).numpy() + \
        job.batch_digest(batch(0), 1).numpy()
    assert job.epoch_mismatch([(2, swapped)], want) == 1


def test_reference_edges_are_numpys_quantiles():
    x = torch.randn(4099, 5, generator=torch.Generator().manual_seed(3))
    x[:50, 1] = 0.25  # repeated values
    got = gbdt_reference.quantile_edges(x, 256)
    qs = np.linspace(0.0, 1.0, 257)[1:-1]
    want = np.quantile(x.numpy(), qs, axis=0).T.astype(np.float32)
    strict = np.all(np.diff(want.astype(np.float64), axis=1) > 0, axis=1)
    assert np.array_equal(got[strict], want[strict])
    assert np.all(np.diff(got.astype(np.float64), axis=1) > 0)


# ---- the timed path broken underneath --------------------------------


FAULTS = [(cell, fault) for cell in CELLS
          for fault in faults.BY_JOB[bench.cell(cell)["job"]]]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch,
                                            tmp_path, capsys):
    fault(monkeypatch)
    out = run_cell(cell, 11, tmp_path, capsys)
    assert not out["correct"], out["checks"]

"""The port's GBDT over a gloo group at worlds 2 and 4, one process a rank,
against the JAX package's ``GBDTLearner(mesh=...)`` on 2 and 4 of
conftest's virtual CPU devices.

Each rank fits its contiguous block of the rows, the block the mesh's
``P("dp")`` sharding gives its shard, with the edges fitted on all rows
(``edges=``, as a multi-process fit requires). The port sums each level's
histogram over the group with one ``bucketed_all_reduce``; the reference
psums it over the mesh axis.

- Every rank must end with rank 0's bits.
- Integer-valued data with the squared loss (integer features and labels,
  instance weights 1 or 2): at world 2 each histogram cell is one addition
  of the two ranks' sums, the same on both sides, so trees, leaves and
  predictions must agree bit for bit. At world 4 gloo adds the four
  ranks' sums in another order than the mesh's psum, and after the first
  tree the (g, h) are no longer integers: the same structure, margins
  within 1e-5.
- Exact data (``_exact_arrays``: binary features in a full factorial
  design, integer labels that a depth-3 tree fits exactly, weights 1 or 2,
  reg_lambda 0, learning rate 0.5): every leaf is pure, every (g, h) a
  dyadic number, every partial sum exact in f32, so the order of the
  ranks' sums cannot matter: trees, leaves and predictions bit for bit at
  worlds 2 and 4.
- Float data with the logistic and softmax losses, and with subsample <
  1 and colsample < 1 (the port folds the rank in the group into the row
  draw where the reference folds in ``axis_index``): the same tree
  structure (features and bins), margins within 1e-5 absolute. The two
  packages' ``sigmoid``/``softmax`` round differently by an ulp, and
  gloo's all-reduce adds the ranks' histograms in another order than the
  mesh's psum; the margins are sums of ~30 leaf values of order 0.1-1.
- ``fit_uri`` at world 2, each rank parsing its byte-range part of one
  LibSVM file with ``drop_remainder=True``: the same bits as the port's
  ``fit`` at world 2 on the rows of those parts, and the reference mesh's
  on the same rows.

No tracker: the process groups meet at a ``file://`` store.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from dmlc_tpu.models import gbdt as ref
from dmlc_tpu_torch.data import create_parser

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
ROWS, FEATURES = 512, 6
COMMON = dict(num_trees=5, max_depth=3, num_bins=16)
EXACT = dict(objective="squared", reg_lambda=0.0, learning_rate=0.5)
# (name, hyper, data, weighted); data "exact", "int" or "float"
CASES = [
    ("squared-exact", EXACT, "exact", False),
    ("squared-exact-weighted", EXACT, "exact", True),
    ("squared-int", dict(objective="squared"), "int", False),
    ("squared-int-weighted", dict(objective="squared"), "int", True),
    ("squared-int-lambda0", dict(objective="squared", reg_lambda=0.0,
                                 min_child_weight=0.0), "int", False),
    ("logistic-float", dict(objective="logistic"), "float", False),
    ("softmax-float", dict(objective="softmax", num_class=3), "float",
     False),
    ("logistic-stochastic", dict(objective="logistic", subsample=0.7,
                                 colsample_bytree=0.6, seed=5), "float",
     False),
]
FLOAT_MARGIN_ATOL = 1e-5
URI_ROWS = 203


def _exact_arrays(rng):
    """x [ROWS, 9]: the bits of a shuffled row index (each cell of any
    split on them holds as many rows per bit value); y = 3·b0 − 2·b1 + b2
    and w = 1 + b3."""
    bits = (rng.permutation(ROWS)[:, None] >> np.arange(9)) & 1
    x = bits.astype(np.float32)
    y = (3 * bits[:, 0] - 2 * bits[:, 1] + bits[:, 2]).astype(np.float32)
    return x, y, (1 + bits[:, 3]).astype(np.float32)


def _case_arrays():
    arrays = {}
    for i, (name, hyper, data, weighted) in enumerate(CASES):
        rng = np.random.RandomState(50 + i)
        if data == "exact":
            x, y, w = _exact_arrays(rng)
        elif data == "int":
            x = rng.randint(-4, 5, (ROWS, FEATURES)).astype(np.float32)
            y = rng.randint(-3, 4, ROWS).astype(np.float32)
        else:
            x = rng.randn(ROWS, FEATURES).astype(np.float32)
            k = hyper.get("num_class", 2)
            y = rng.randint(0, k, ROWS).astype(np.float32)
        arrays[f"{name}/x"] = x
        arrays[f"{name}/y"] = y
        if data != "exact":
            w = rng.randint(1, 3, ROWS).astype(np.float32)
        arrays[f"{name}/w"] = w if weighted else np.ones(0, np.float32)
        arrays[f"{name}/edges"] = ref.fit_bins(x, COMMON["num_bins"])
    return arrays


def _write_libsvm(path):
    rng = np.random.RandomState(61)
    lines = []
    for _ in range(URI_ROWS):
        vals = rng.randint(-4, 5, FEATURES)
        label = int(vals[0] + vals[2] > 0) + int(vals[1] > 1)
        lines.append("%d %s" % (label, " ".join(
            "%d:%d" % (j, v) for j, v in enumerate(vals) if v)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


_PORT_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlc_tpu_torch.models.gbdt import GBDTLearner
from dmlc_tpu_torch.parallel import distributed


def main(rank, world, tmp):
    torch.set_num_threads(1)
    spec = json.load(open(f"{tmp}/spec.json"))
    arrays = np.load(f"{tmp}/data.npz")
    distributed.initialize(f"file://{tmp}/pg{world}", world, rank,
                           device="cpu")
    group = dist.group.WORLD
    out = {}
    for name, hyper in spec["cases"]:
        x, y, w = (arrays[f"{name}/{k}"] for k in ("x", "y", "w"))
        n = len(y) // world
        rows = slice(rank * n, (rank + 1) * n)
        learner = GBDTLearner(device="cpu", group=group, **spec["common"],
                              **hyper)
        history = learner.fit(x[rows], y[rows], edges=arrays[f"{name}/edges"],
                              weight=w[rows] if len(w) else None)
        for k, v in learner.trees.items():
            out[f"{name}/{k}"] = v.numpy()
        out[f"{name}/history"] = np.array(history)
        out[f"{name}/margin"] = learner.predict_margin(x)
    if world == 2:
        hyper = dict(objective="squared", **spec["common"])
        learner = GBDTLearner(device="cpu", group=group, **hyper)
        learner.fit_uri(spec["uri"], spec["features"], part_index=rank,
                        num_parts=world, edges=arrays["uri/edges"],
                        drop_remainder=True, nthread=1)
        for k, v in learner.trees.items():
            out[f"uri/{k}"] = v.numpy()
    distributed.shutdown()
    np.savez(f"{tmp}/port{world}_{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
'''


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' ranks at once: {world: [rank arrays]}."""
    tmp = tmp_path_factory.mktemp("gbdt_dist")
    arrays = _case_arrays()
    uri = _write_libsvm(tmp / "ints.svm")
    uri_rows = _uri_rows(uri)
    arrays["uri/edges"] = ref.fit_bins(
        np.concatenate([r[0] for r in uri_rows]), COMMON["num_bins"])
    np.savez(tmp / "data.npz", **arrays)
    spec = {"cases": [[name, hyper] for name, hyper, _, _ in CASES],
            "common": COMMON, "uri": uri, "features": FEATURES}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    try:
        for world in WORLDS:
            procs += [(world, subprocess.Popen(
                [sys.executable, "-c", _PORT_WORKER, str(r), str(world),
                 str(tmp)], cwd=tmp, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
                for r in range(world)]
        logs = [p.communicate(timeout=240)[0] for _, p in procs]
    finally:
        for _, p in procs:
            p.kill()
    for (_, p), log in zip(procs, logs):
        assert p.returncode == 0, log
    return {"arrays": arrays, "uri_rows": uri_rows,
            "port": {world: [dict(np.load(tmp / f"port{world}_{r}.npz"))
                             for r in range(world)] for world in WORLDS}}


def _uri_rows(uri):
    """Each world-2 part's (x, y), trimmed to the smaller part's rows as
    ``drop_remainder=True`` does."""
    parts = []
    for part in range(2):
        parser = create_parser(uri, part, 2, nthread=1, device="cpu")
        try:
            blocks = list(parser)
        finally:
            parser.close()
        parts.append((np.concatenate([b.to_dense(FEATURES) for b in blocks]),
                      np.concatenate([b.label for b in blocks])))
    n = min(len(y) for _, y in parts)
    return [(x[:n], y[:n].astype(np.float32)) for x, y in parts]


def _reference(world, name, hyper, arrays):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("dp",))
    learner = ref.GBDTLearner(mesh=mesh, **COMMON, **hyper)
    w = arrays[f"{name}/w"]
    learner.fit(arrays[f"{name}/x"], arrays[f"{name}/y"],
                edges=arrays[f"{name}/edges"], weight=w if len(w) else None)
    return learner


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_group_fit_matches_reference_mesh(worlds, world, case):
    name, hyper, data, _ = case
    arrays = worlds["arrays"]
    ranks = worlds["port"][world]
    for r in range(1, world):
        for k in ("feature", "bin", "gain", "leaf", "history", "margin"):
            assert ranks[r][f"{name}/{k}"].tobytes() == \
                ranks[0][f"{name}/{k}"].tobytes(), (r, k)
    learner = _reference(world, name, hyper, arrays)
    got = ranks[0]
    for k in ("feature", "bin"):
        np.testing.assert_array_equal(got[f"{name}/{k}"],
                                      np.asarray(learner.trees[k]))
    want_margin = learner.predict_margin(arrays[f"{name}/x"])
    if data == "exact" or (data == "int" and world == 2):
        for k in ("leaf", "gain"):
            want = np.asarray(learner.trees[k])
            assert got[f"{name}/{k}"].tobytes() == want.tobytes(), k
        assert got[f"{name}/margin"].tobytes() == want_margin.tobytes()
    else:
        np.testing.assert_allclose(got[f"{name}/margin"], want_margin,
                                   rtol=0, atol=FLOAT_MARGIN_ATOL)
    assert np.isfinite(got[f"{name}/history"]).all()


def test_fit_uri_world2_matches_fit_and_reference(worlds):
    """Each rank's part, trimmed to the smaller part: the port's fit_uri
    at world 2 gives the reference mesh's bits on those rows."""
    rows = worlds["uri_rows"]
    x = np.concatenate([r[0] for r in rows])
    y = np.concatenate([r[1] for r in rows])
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    learner = ref.GBDTLearner(mesh=mesh, objective="squared", **COMMON)
    learner.fit(x, y, edges=worlds["arrays"]["uri/edges"])
    for rank in range(2):
        got = worlds["port"][2][rank]
        for k in ("feature", "bin", "leaf", "gain"):
            assert got[f"uri/{k}"].tobytes() == \
                np.asarray(learner.trees[k]).tobytes(), (rank, k)

"""The rest of the port's data-parallel path against the JAX package's:
the sharded csr batch, the pad-in-place csr batch, the sharded SpMV, the
feature-sharded (dp × mp) step and ``LinearLearner.reshard``.

- ``pad_to_bucket_sharded`` and ``emit_to_bucket`` build their batches
  with integer bookkeeping and copies only: bit for bit against the
  reference's, and ``DeviceFeed``'s csr batches (now through
  ``emit_to_bucket``) bit for bit against ``pad_to_bucket`` of the same
  rows.
- The sharded SpMV and the feature-sharded step run at world 4 over gloo,
  one process a rank (the step at dp × mp = 2 × 2, groups from
  ``dist.new_group``), against the reference's shard_map programs on a 2 ×
  2 mesh of conftest's virtual CPU devices. On integer-valued data (unit
  weights over 64 rows, a power-of-two learning rate) every sum is exact,
  so the squared and hinge objectives agree bit for bit (all but the
  squared loss's loss sum after the first step: its squares of margins
  with a 2^-9 step need more than f32's 24 bits, and their sum is held to
  the float tolerance); the SpMV on float data and the logistic objective
  within rtol 1e-5 / atol 1e-6 (sums in another order, another library's
  exp).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dmlc_tpu.data.row_block import RowBlock as RefRowBlock
from dmlc_tpu.data.row_block import RowBlockContainer as RefContainer
from dmlc_tpu.device import csr as ref_csr
from dmlc_tpu.models.linear import \
    make_feature_sharded_train_step as ref_mp_step
from dmlc_tpu.ops.spmv import make_sharded_spmv as ref_sharded_spmv
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed, csr
from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
DP, MP = 2, 2
STEP_ROWS, STEP_NF, STEP_LR = 64, 12, 0.125
SPMV_BATCH, SPMV_NF = 64, 50
STEP_CASES = [("squared", "int"), ("hinge", "int"), ("logistic", "float")]


def _block(seed, rows, nf, weights=True, values=True, empty_rows=True):
    """A RowBlock of each package with the same arrays: ragged rows (some
    empty), sorted ids in [0, nf)."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0 if empty_rows else 1, 7, rows)
    offset = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    index = np.concatenate(
        [np.sort(rng.choice(nf, c, replace=False)) for c in counts]
        or [np.zeros(0)]).astype(np.uint32)
    value = (rng.randint(-3, 4, len(index)).astype(np.float32)
             if values else None)
    label = rng.randint(0, 2, rows).astype(np.float32)
    weight = rng.randint(1, 3, rows).astype(np.float32) if weights else None
    arrays = dict(offset=offset, label=label, index=index, value=value,
                  weight=weight)
    return RowBlock(**arrays), RefRowBlock(**arrays)


def _same_batch(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
        else:
            assert g == w, f


@pytest.mark.parametrize("rows,batch,shards", [(40, 48, 4), (48, 48, 2),
                                               (0, 16, 4), (5, 64, 8),
                                               (30, 32, 1)])
@pytest.mark.parametrize("flavor", ["weighted", "plain"])
def test_pad_to_bucket_sharded_matches_reference(rows, batch, shards,
                                                 flavor):
    full = flavor == "weighted"
    block, ref_block = _block(rows + shards, rows, 97, weights=full,
                              values=full)
    got = csr.pad_to_bucket_sharded(block, batch, shards)
    want = ref_csr.pad_to_bucket_sharded(ref_block, batch, shards)
    _same_batch(got, want, ("labels", "weights", "indices", "values",
                            "row_ids", "offsets", "num_rows", "num_nonzero",
                            "num_shards", "nnz_bucket"))
    # a section is the shard's rows and entries, with local offsets
    rows_per = batch // shards
    for s in range(shards):
        sec = got.section(s)
        assert sec["label"].shape == (rows_per,)
        assert sec["values"].shape == (got.nnz_bucket,)
        assert sec["offsets"][-1] == np.count_nonzero(
            (np.repeat(np.arange(rows), np.diff(block.offset))
             // rows_per) == s)


@pytest.mark.parametrize("parts", [[7], [3, 0, 9, 1], [16, 16]])
@pytest.mark.parametrize("batch", [32, 48])
def test_emit_to_bucket_matches_reference(parts, batch):
    port_rows, ref_rows = RowBlockContainer(), RefContainer()
    for i, n in enumerate(parts):
        block, ref_block = _block(10 + i, n, 300, weights=i % 2 == 0,
                                  values=i != 1)
        port_rows.push_block(block)
        ref_rows.push_block(ref_block)
    got = csr.emit_to_bucket(port_rows, batch)
    want = ref_csr.emit_to_bucket(ref_rows, batch)
    _same_batch(got, want, ("labels", "weights", "indices", "values",
                            "offsets", "num_rows", "num_nonzero"))
    # and what the old route gives: to_block, then pad_to_bucket
    _same_batch(got, csr.pad_to_bucket(port_rows.to_block(), batch),
                ("labels", "weights", "indices", "values", "offsets",
                 "num_rows", "num_nonzero"))


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_feed_csr_batches_unchanged_by_emit(tmp_path, drop_remainder):
    """DeviceFeed's csr batches (now ``emit_to_bucket`` over slices of the
    parser's blocks) equal ``pad_to_bucket`` of the same rows."""
    from dmlc_tpu_torch.data import create_parser

    rng = np.random.RandomState(3)
    lines = []
    for i in range(301):
        ids = np.sort(rng.choice(np.arange(1, 500), rng.randint(1, 9),
                                 replace=False))
        lines.append("%d %s" % (i % 2, " ".join(
            "%d:%d" % (j, rng.randint(1, 5)) for j in ids)))
    path = tmp_path / "f.svm"
    path.write_text("\n".join(lines) + "\n")
    spec = BatchSpec(batch_size=37, layout="csr", num_features=500,
                     drop_remainder=drop_remainder)
    feed = DeviceFeed(str(path), spec, device="cpu")
    parser = create_parser(str(path), device="cpu", nthread=1)
    try:
        whole = RowBlockContainer()
        for b in parser:
            whole.push_block(b)
        whole = whole.to_block()
        got = list(feed)
    finally:
        feed.close()
        parser.close()
    want_n = 301 // 37 if drop_remainder else -(-301 // 37)
    assert len(got) == want_n
    for k, batch in enumerate(got):
        want = csr.pad_to_bucket(
            whole.slice(k * 37, min((k + 1) * 37, 301)), 37)
        for key, field in (("label", "labels"), ("weight", "weights"),
                           ("indices", "indices"), ("values", "values"),
                           ("offsets", "offsets")):
            assert batch[key].numpy().tobytes() == \
                getattr(want, field).tobytes(), (k, key)
        assert batch["num_rows"] == want.num_rows


def test_reshard_round_trips_params_and_drops_step(tmp_path):
    data = tmp_path / "d.svm"
    data.write_text("".join(f"{i % 2} 1:{i % 5} 3:{i % 3}\n"
                            for i in range(40)))
    learner = LinearLearner(device="cpu", momentum=0.5)
    learner.fit_uri(str(data), batch_size=8, num_features=4)
    before = params_to_numpy(learner.params)
    velocity = params_to_numpy(learner.velocity)
    learner.reshard(device="cpu")
    assert learner._step is None and learner.group is None
    for k in ("w", "b"):
        assert params_to_numpy(learner.params)[k].tobytes() == \
            before[k].tobytes()
        assert params_to_numpy(learner.velocity)[k].tobytes() == \
            velocity[k].tobytes()
    history = learner.fit_uri(str(data), batch_size=8, num_features=4)
    assert np.isfinite(history).all()


# ---------------------------------------------------------------------------
# world 4 over gloo: the sharded SpMV and the dp × mp step
# ---------------------------------------------------------------------------

_RANK = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlc_tpu_torch.device import csr
from dmlc_tpu_torch.models import (feature_shard,
                                   make_feature_sharded_train_step)
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops.spmv import make_sharded_spmv
from dmlc_tpu_torch.parallel import distributed


def main(rank, tmp):
    torch.set_num_threads(1)
    spec = json.load(open(f"{tmp}/spec.json"))
    a = np.load(f"{tmp}/inputs.npz")
    dp, mp = spec["dp"], spec["mp"]
    distributed.initialize(f"file://{tmp}/pg", dp * mp, rank, device="cpu")
    # every rank makes every group, in one order
    dp_groups = [dist.new_group([i * mp + j for i in range(dp)])
                 for j in range(mp)]
    mp_groups = [dist.new_group([i * mp + j for j in range(mp)])
                 for i in range(dp)]
    i, j = divmod(rank, mp)
    out = {}
    # the sharded SpMV: this rank's section of the world-4 batch
    sharded = csr.ShardedCSRBatch(
        **{k: a["spmv/" + k] for k in ("labels", "weights", "indices",
                                       "values", "row_ids", "offsets")},
        num_rows=int(a["spmv/num_rows"]), num_nonzero=0,
        num_shards=dp * mp, nnz_bucket=int(a["spmv/nnz_bucket"]))
    sec = sharded.section(rank)
    spmv = make_sharded_spmv(spec["spmv_batch"], dist.group.WORLD)
    for name in ("int", "float"):
        out["spmv/" + name] = spmv(
            torch.from_numpy(sec["values"] * a["spmv/scale_" + name]),
            torch.from_numpy(sec["indices"]),
            torch.from_numpy(sec["offsets"]),
            torch.from_numpy(a["spmv/w_" + name])).numpy()
    # the dp x mp step: rows split over dp, features over mp
    rows = slice(i * spec["rows"] // dp, (i + 1) * spec["rows"] // dp)
    for objective, data in spec["step_cases"]:
        step = make_feature_sharded_train_step(
            dp_groups[j], mp_groups[i], objective=objective,
            learning_rate=spec["lr"])
        key = f"{objective}-{data}"
        params = {"w": torch.from_numpy(
                      feature_shard(a[key + "/w"], j, mp).copy()),
                  "b": torch.tensor(a[key + "/b"])}
        for s in range(2):
            x = feature_shard(a[f"{key}/x{s}"][rows], j, mp)
            params, metrics = step(
                params, torch.from_numpy(np.ascontiguousarray(x)),
                torch.from_numpy(a[f"{key}/y{s}"][rows]),
                torch.from_numpy(a[f"{key}/wt{s}"][rows]))
            for k in ("w", "b"):
                out[f"{key}/step{s}/{k}"] = params[k].numpy()
            for k, v in metrics.items():
                out[f"{key}/step{s}/{k}"] = v.numpy()
    distributed.shutdown()
    np.savez(f"{tmp}/rank{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
'''


def _inputs():
    arrays = {}
    block, _ = _block(5, SPMV_BATCH - 3, SPMV_NF)
    batch = csr.pad_to_bucket_sharded(block, SPMV_BATCH, DP * MP)
    for k in ("labels", "weights", "indices", "values", "row_ids",
              "offsets"):
        arrays["spmv/" + k] = getattr(batch, k)
    arrays["spmv/num_rows"] = np.int64(batch.num_rows)
    arrays["spmv/nnz_bucket"] = np.int64(batch.nnz_bucket)
    rng = np.random.RandomState(8)
    arrays["spmv/w_int"] = rng.randint(-3, 4, SPMV_NF).astype(np.float32)
    arrays["spmv/scale_int"] = np.float32(1.0)
    arrays["spmv/w_float"] = rng.randn(SPMV_NF).astype(np.float32)
    arrays["spmv/scale_float"] = np.float32(0.37)
    for objective, data in STEP_CASES:
        key = f"{objective}-{data}"
        arrays[key + "/w"] = rng.randint(-1, 2, STEP_NF).astype(np.float32)
        arrays[key + "/b"] = np.float32(1.0)
        for s in range(2):
            x = (rng.randint(-2, 3, (STEP_ROWS, STEP_NF)) if data == "int"
                 else rng.randn(STEP_ROWS, STEP_NF))
            arrays[f"{key}/x{s}"] = x.astype(np.float32)
            arrays[f"{key}/y{s}"] = rng.randint(0, 2, STEP_ROWS).astype(
                np.float32)
            # integer data keeps weight 1, so that the weight sum (64) and
            # with it every update stays a power-of-two fraction: exact
            arrays[f"{key}/wt{s}"] = (
                np.ones(STEP_ROWS, np.float32) if data == "int"
                else rng.randint(1, 3, STEP_ROWS).astype(np.float32))
    return arrays


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    arrays = _inputs()
    np.savez(tmp / "inputs.npz", **arrays)
    spec = {"dp": DP, "mp": MP, "rows": STEP_ROWS, "lr": STEP_LR,
            "spmv_batch": SPMV_BATCH, "step_cases": STEP_CASES}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK, str(r), str(tmp)], cwd=tmp,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(DP * MP)]
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return arrays, [dict(np.load(tmp / f"rank{r}.npz"))
                    for r in range(DP * MP)]


@pytest.mark.parametrize("data", ["int", "float"])
def test_sharded_spmv_world4_matches_reference(world4, data):
    arrays, ranks = world4
    mesh = Mesh(np.asarray(jax.devices()[:DP * MP]), ("dp",))
    fn = ref_sharded_spmv(mesh, SPMV_BATCH)
    want = np.asarray(fn(
        jnp.asarray(arrays["spmv/values"] * arrays["spmv/scale_" + data]),
        jnp.asarray(arrays["spmv/indices"]),
        jnp.asarray(arrays["spmv/row_ids"]),
        jnp.asarray(arrays["spmv/w_" + data])))
    got = np.concatenate([r["spmv/" + data] for r in ranks])
    assert got.shape == want.shape == (SPMV_BATCH,)
    if data == "int":
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_feature_sharded_step_2x2_matches_reference(world4, case):
    arrays, ranks = world4
    objective, data = case
    key = f"{objective}-{data}"
    mesh = Mesh(np.asarray(jax.devices()[:DP * MP]).reshape(DP, MP),
                ("dp", "mp"))
    step, shardings = ref_mp_step(mesh, objective=objective,
                                  learning_rate=STEP_LR)
    params = {k: jax.device_put(jnp.asarray(arrays[f"{key}/{k}"]),
                                shardings[k]) for k in ("w", "b")}
    per = STEP_NF // MP
    for s in range(2):
        params, metrics = step(
            params,
            jax.device_put(jnp.asarray(arrays[f"{key}/x{s}"]),
                           shardings["x"]),
            jax.device_put(jnp.asarray(arrays[f"{key}/y{s}"]),
                           shardings["label"]),
            jax.device_put(jnp.asarray(arrays[f"{key}/wt{s}"]),
                           shardings["weight"]))
        want = {"w": np.asarray(params["w"]), "b": np.asarray(params["b"]),
                "loss_sum": np.asarray(metrics["loss_sum"]),
                "weight_sum": np.asarray(metrics["weight_sum"])}
        for rank, got in enumerate(ranks):
            j = rank % MP
            for k, w in want.items():
                if k == "w":
                    w = w[j * per:(j + 1) * per]
                g = got[f"{key}/step{s}/{k}"]
                assert g.dtype == w.dtype and g.shape == w.shape, k
                if data == "int" and not (k == "loss_sum" and s and
                                          objective == "squared"):
                    assert g.tobytes() == w.tobytes(), (rank, s, k)
                else:
                    np.testing.assert_allclose(g, w, **TOL)

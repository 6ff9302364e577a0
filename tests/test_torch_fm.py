"""The port's factorization machines against the JAX package's
(``dmlc_tpu/models/fm.py``), on the same numpy inputs.

- ``_fm_forward_grads``: bit for bit on integer-valued ``values``, dyadic
  ``w`` and ``v`` (multiples of 2^-4, small enough that every sum and the
  squared loss are exact in f32) with the squared objective on 0/1 labels;
  within rtol 1e-5 / atol 1e-6 on float data with the logistic objective
  (one forward: the row and feature sums run in another f32 order, and
  exp/log1p come from two math libraries).
- ``test_models.py::TestFM``'s 30 steps, and ``FMLearner.fit_feed`` over a
  libfm file, from the same carried-over params: within the reference's
  own rtol 1e-4 / atol 1e-6 (the last-bit differences of one step compound
  over the steps).
- The data-parallel step at world 2 (one ``python -c`` process a rank over
  gloo, each rank its section of the sharded batch) against world 1,
  within the same limit (two half-sums against one sum per element).
- ``prng.normal`` against ``jax.random.normal`` within
  ``prng.NORMAL_MAX_ULP``; the column ``coo_segment_sum_plain`` and the
  [E, K] ``feature_segment_sum`` column by column against their [E] calls.
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

from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.data.row_block import RowBlockContainer as RefContainer
from dmlc_tpu.device import BatchSpec as RefBatchSpec
from dmlc_tpu.device import DeviceFeed as RefDeviceFeed
from dmlc_tpu.device.csr import pad_to_bucket as ref_pad_to_bucket
from dmlc_tpu.models import FMLearner as RefFMLearner
from dmlc_tpu.models import init_fm_params as ref_init_fm_params
from dmlc_tpu.models import make_fm_train_step as ref_make_fm_step
from dmlc_tpu.models.fm import _fm_forward_grads as ref_forward_grads
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.data.row_block import RowBlockContainer
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.device.csr import pad_to_bucket
from dmlc_tpu_torch.models import (FMLearner, fm_params_from_numpy,
                                   fm_params_to_numpy, init_fm_params,
                                   make_fm_train_step, step_batch)
from dmlc_tpu_torch.models.fm import _fm_forward_grads
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops.spmv import feature_segment_sum
from dmlc_tpu_torch.utils import DMLCError, prng

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAD_KEYS = ("gw", "gb", "gv", "loss_sum", "weight_sum")
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _csr_batch(rng, rows, nf, max_per_row, bucket, integer):
    """A padded csr batch as numpy: sorted distinct ids in [1, nf) a row,
    integer values in {1, 2} or floats, 0/1 labels."""
    counts = rng.randint(1, max_per_row + 1, rows)
    nnz = int(counts.sum())
    indices = np.zeros(bucket, np.int32)
    values = np.zeros(bucket, np.float32)
    indices[:nnz] = np.concatenate(
        [np.sort(rng.choice(np.arange(1, nf), c, replace=False))
         for c in counts])
    values[:nnz] = (rng.randint(1, 3, nnz) if integer
                    else rng.randn(nnz))
    return {"label": rng.randint(0, 2, rows).astype(np.float32),
            "weight": (np.ones(rows) if integer
                       else rng.rand(rows) + 0.5).astype(np.float32),
            "indices": indices, "values": values,
            "offsets": np.concatenate([[0], np.cumsum(counts)]).astype(
                np.int32)}


def _params(rng, nf, k, dyadic):
    if dyadic:  # multiples of 2^-4
        return {"w": rng.randint(-1, 2, nf).astype(np.float32) / 16,
                "b": np.float32(1 / 16),
                "v": rng.randint(-1, 2, (nf, k)).astype(np.float32) / 16}
    return {"w": (rng.randn(nf) * 0.1).astype(np.float32),
            "b": np.float32(0.05),
            "v": (rng.randn(nf, k) * 0.1).astype(np.float32)}


def _both_grads(params, batch, objective, nf):
    got = _fm_forward_grads(fm_params_from_numpy(params, "cpu"),
                            {k: torch.tensor(v) for k, v in batch.items()},
                            objective, nf)
    want = ref_forward_grads({k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             objective, nf)
    return ([t.numpy() for t in got], [np.asarray(a) for a in want])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 4])
def test_forward_grads_bit_equal_on_exact_data(seed, k):
    """16 rows of at most 3 entries, values in {1, 2}, |w|, |v| <= 2^-4:
    every product, row sum, feature sum and squared loss is exact in f32,
    so any summation order gives the reference's bits."""
    rng = np.random.RandomState(seed)
    nf = 40
    batch = _csr_batch(rng, 16, nf, 3, 64, integer=True)
    params = _params(rng, nf, k, dyadic=True)
    got, want = _both_grads(params, batch, "squared", nf)
    for name, g, w in zip(GRAD_KEYS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    assert got[2].shape == (nf, k) and np.any(got[2] != 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_grads_close_on_float_data(seed):
    rng = np.random.RandomState(10 + seed)
    nf = 300
    batch = _csr_batch(rng, 64, nf, 12, 768, integer=False)
    params = _params(rng, nf, 8, dyadic=False)
    got, want = _both_grads(params, batch, "logistic", nf)
    for name, g, w in zip(GRAD_KEYS, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)


def _testfm_batch():
    """test_models.py::TestFM's batch: 64 rows of 4 of 24 features, values
    1, the label the parity of the first feature, padded to 512 entries."""
    rng = np.random.RandomState(4)
    cont = RefContainer()
    for _ in range(64):
        feats = sorted(rng.choice(24, size=4, replace=False))
        cont.push_row(float((feats[0] % 2) == 0), feats,
                      value=np.ones(4, dtype=np.float32))
    dev = ref_pad_to_bucket(cont.to_block(), 64, nnz_bucket=512)
    return {"label": dev.labels, "weight": dev.weights,
            "indices": dev.indices, "values": dev.values,
            "offsets": dev.offsets}


def test_thirty_steps_match_reference():
    nf, k = 24, 4
    batch = {key: np.array(v) for key, v in _testfm_batch().items()}
    start = {key: np.asarray(a)
             for key, a in ref_init_fm_params(nf, k).items()}
    ref_step = ref_make_fm_step(None, nf, learning_rate=0.2)
    step = make_fm_train_step(None, nf, learning_rate=0.2)
    rp = {key: jnp.asarray(a) for key, a in start.items()}
    rb = {key: jnp.asarray(a) for key, a in batch.items()}
    p = fm_params_from_numpy(start, "cpu")
    b = {key: torch.tensor(v) for key, v in batch.items()}
    losses, ref_losses = [], []
    for _ in range(30):
        p, m = step(p, b)
        rp, rm = ref_step(rp, rb)
        losses.append(float(m["loss_sum"]) / float(m["weight_sum"]))
        ref_losses.append(float(rm["loss_sum"]) / float(rm["weight_sum"]))
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, ref_losses, **STEP_TOL)
    got = fm_params_to_numpy(p)
    for key in ("w", "b", "v"):
        np.testing.assert_allclose(got[key], np.asarray(rp[key]),
                                   err_msg=key, **STEP_TOL)


def test_step_leaves_inputs_untouched_unless_donated():
    batch = {key: torch.tensor(v) for key, v in _testfm_batch().items()}
    params = init_fm_params(24, 4, device="cpu")
    before = {key: t.clone() for key, t in params.items()}
    new, _ = make_fm_train_step(None, 24, l2=0.1)(params, batch)
    assert all(torch.equal(params[key], before[key]) for key in params)
    assert not torch.equal(new["v"], before["v"])
    out, _ = make_fm_train_step(None, 24, l2=0.1, donate_batch=True)(
        params, batch)
    assert out["v"] is params["v"]
    for key in ("w", "b", "v"):
        assert torch.equal(out[key], new[key]), key


def test_init_and_normal_match_jax_within_ulp_bound():
    for seed, shape in ((0, (1 << 15, 8)), (7, (1000, 3)), (3, (5,))):
        got = prng.normal(prng.PRNGKey(seed), shape).numpy()
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                            dtype=jnp.float32))
        assert got.shape == want.shape and got.dtype == np.float32
        ulp = np.abs(got.view(np.int32).astype(np.int64)
                     - want.view(np.int32).astype(np.int64))
        assert ulp.max() <= prng.NORMAL_MAX_ULP, (seed, ulp.max())
        assert (ulp == 0).mean() > 0.9
    got = fm_params_to_numpy(init_fm_params(300, 8, 0.01, device="cpu"))
    want = ref_init_fm_params(300, 8, 0.01)
    assert not got["w"].any() and got["b"] == 0 and got["b"].shape == ()
    np.testing.assert_allclose(got["v"], np.asarray(want["v"]), rtol=1e-6,
                               atol=0)


def test_erf_inv_ends_are_infinite():
    x = torch.tensor([-1.0, 1.0, 0.0])
    out = prng.erf_inv(x)
    assert out[0] == -float("inf") and out[1] == float("inf") and out[2] == 0


@pytest.mark.parametrize("cols", [1, 3, 17])
def test_column_segment_sum_plain_matches_1d_calls(cols):
    rng = np.random.RandomState(cols)
    entries, rows = 500, 37
    row_ids = np.sort(rng.randint(-1, rows + 2, entries)).astype(np.int32)
    contrib = torch.tensor(rng.randn(entries, cols).astype(np.float32))
    ids = torch.tensor(row_ids)
    got = kernels.coo_segment_sum(contrib, ids, rows)
    assert got.shape == (rows, cols)
    for c in range(cols):
        one = kernels.coo_segment_sum(contrib[:, c].contiguous(), ids, rows)
        assert torch.equal(got[:, c], one), c
    want = jax.ops.segment_sum(
        jnp.asarray(contrib.numpy()),
        jnp.asarray(np.where(row_ids < rows, row_ids, -1)),
        num_segments=rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_feature_sum_columns_match_1d_calls_and_reference():
    rng = np.random.RandomState(5)
    entries, nf, k = 4000, 97, 8
    indices = torch.tensor(rng.randint(0, 60, entries).astype(np.int32))
    contrib = torch.tensor(rng.randn(entries, k).astype(np.float32))
    got = feature_segment_sum(contrib, indices, nf)
    assert got.shape == (nf, k) and not got[60:].any()
    for c in range(k):
        assert torch.equal(
            got[:, c],
            feature_segment_sum(contrib[:, c].contiguous(), indices, nf)), c
    again = feature_segment_sum(contrib, indices, nf)
    assert torch.equal(got, again)
    want = jax.ops.segment_sum(jnp.asarray(contrib.numpy()),
                               jnp.asarray(indices.numpy()),
                               num_segments=nf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # integer contributions: every sum exact, the reference's bits
    ints = torch.tensor(rng.randint(-3, 4, (entries, k)).astype(np.float32))
    want = jax.ops.segment_sum(jnp.asarray(ints.numpy()),
                               jnp.asarray(indices.numpy()), num_segments=nf)
    assert np.array_equal(feature_segment_sum(ints, indices, nf).numpy(),
                          np.asarray(want))


# ---------------------------------------------------------------------------
# the learner over a libfm file, and predict_batch
# ---------------------------------------------------------------------------


def _write_libfm(path, rows, nf, seed):
    """field:index:value rows, field = the id's position in the row, the
    label from a planted pairwise rule so a factor model has something to
    learn."""
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


def _ref_fit(path, nf, start, hyper, epochs, batch_size):
    ref = RefFMLearner(None, num_features=nf, **hyper)
    ref.params = {k: jnp.asarray(a) for k, a in start.items()}
    feed = RefDeviceFeed(
        ref_create_parser(path, 0, 1, "libfm", threaded=False),
        RefBatchSpec(batch_size=batch_size, layout="csr", num_features=nf),
        host_prefetch=0)
    try:
        history = ref.fit_feed(feed, epochs=epochs)
    finally:
        feed.close()
    return ref, history


def test_fit_feed_over_libfm_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")
    nf, batch_size = 200, 32
    path = _write_libfm(tmp_path / "train.libfm", 256, nf, 3)
    hyper = dict(num_factors=4, learning_rate=0.2, l2=0.001)
    start = {k: np.asarray(a) for k, a in
             ref_init_fm_params(nf, 4, 0.1, seed=2).items()}
    learner = FMLearner(device="cpu", num_features=nf, **hyper)
    learner.params = fm_params_from_numpy(start, "cpu")
    feed = DeviceFeed(create_parser(path, 0, 1, "libfm", device="cpu"),
                      BatchSpec(batch_size=batch_size, layout="csr",
                                num_features=nf), device="cpu")
    try:
        history = learner.fit_feed(feed, epochs=3)
    finally:
        feed.close()
    ref, ref_history = _ref_fit(path, nf, start, hyper, 3, batch_size)
    assert len(history) == 3 and history[-1] < history[0]
    np.testing.assert_allclose(history, ref_history, **STEP_TOL)
    got = fm_params_to_numpy(learner.params)
    for key in ("w", "b", "v"):
        np.testing.assert_allclose(got[key], np.asarray(ref.params[key]),
                                   err_msg=key, **STEP_TOL)
    # predict_batch on the first batch of the file, from the same params
    feed = DeviceFeed(create_parser(path, 0, 1, "libfm", device="cpu"),
                      BatchSpec(batch_size=batch_size, layout="csr",
                                num_features=nf), device="cpu")
    try:
        batch = step_batch(next(iter(feed)), "csr")
    finally:
        feed.close()
    margins = learner.predict_batch(batch)
    want = ref.predict_batch({k: jnp.asarray(v.numpy())
                              for k, v in batch.items()})
    assert margins.shape == (batch_size,)
    np.testing.assert_allclose(margins, want, rtol=1e-5, atol=1e-6)


def test_fit_feed_checks_its_feed(tmp_path):
    path = _write_libfm(tmp_path / "t.libfm", 8, 20, 1)
    learner = FMLearner(device="cpu", num_features=20)
    dense = DeviceFeed(path, BatchSpec(batch_size=4, num_features=20),
                       device="cpu")
    with pytest.raises(DMLCError, match="csr"):
        learner.fit_feed(dense)
    dense.close()


def test_reshard_keeps_params_and_rebuilds_the_step(tmp_path):
    path = _write_libfm(tmp_path / "r.libfm", 64, 30, 2)
    learner = FMLearner(device="cpu", num_features=30, num_factors=2)
    feed = DeviceFeed(path + "?format=libfm",
                      BatchSpec(batch_size=16, layout="csr",
                                num_features=30), device="cpu")
    try:
        learner.fit_feed(feed, 1)
        before = fm_params_to_numpy(learner.params)
        learner.reshard(device="cpu")
        assert learner._step is None and learner.group is None
        after = fm_params_to_numpy(learner.params)
        for k in ("w", "b", "v"):
            assert before[k].tobytes() == after[k].tobytes(), k
        feed.before_first()
        assert len(learner.fit_feed(feed, 1)) == 1
    finally:
        feed.close()


def test_fm_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        FMLearner()
    with pytest.raises(DMLCError, match="no CUDA device"):
        init_fm_params(4, 2)
    with pytest.raises(DMLCError, match="no CUDA device"):
        fm_params_from_numpy({"w": np.zeros(2), "b": 0.0,
                              "v": np.zeros((2, 2))})
    assert FMLearner(device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# world 2 against world 1
# ---------------------------------------------------------------------------

WORLD_CASES = [("logistic", 0.0), ("logistic", 0.01), ("squared", 0.0)]

_RANK = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlc_tpu_torch.models import (fm_params_from_numpy, fm_params_to_numpy,
                                   make_fm_train_step)
from dmlc_tpu_torch.parallel import distributed

rank, tmp = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
spec = json.load(open(f"{tmp}/spec.json"))
arrays = np.load(f"{tmp}/world.npz")
distributed.initialize(f"file://{tmp}/pg", 2, rank, device="cpu")
out = {}
for objective, l2 in spec["cases"]:
    name = f"{objective}-{l2}"
    step = make_fm_train_step(dist.group.WORLD, spec["nf"],
                              objective=objective, learning_rate=0.2, l2=l2,
                              donate_batch=True)
    params = fm_params_from_numpy(
        {k: arrays[f"start/{k}"] for k in ("w", "b", "v")}, "cpu")
    batch = {k: torch.from_numpy(arrays[f"rank{rank}/{k}"].copy())
             for k in ("label", "weight", "indices", "values", "offsets")}
    for s in range(spec["steps"]):
        params, m = step(params, batch)
        out[f"{name}/loss{s}"] = m["loss_sum"].numpy()
    for k, v in fm_params_to_numpy(params).items():
        out[f"{name}/{k}"] = v
distributed.shutdown()
np.savez(f"{tmp}/rank{rank}.npz", **out)
'''


def test_world2_matches_world1(tmp_path):
    """Rows split over two gloo ranks (each its section of the sharded
    batch, local offsets); the step's one bucketed all_reduce makes both
    ranks apply the same sums."""
    from dmlc_tpu_torch.device.csr import pad_to_bucket_sharded

    rng = np.random.RandomState(8)
    nf, rows, steps = 500, 64, 3
    cont = RowBlockContainer()
    for _ in range(rows):
        n = rng.randint(1, 9)
        cont.push_row(float(rng.randint(0, 2)),
                      np.sort(rng.choice(np.arange(1, nf), n, replace=False)),
                      value=rng.randn(n).astype(np.float32))
    block = cont.to_block()
    sharded = pad_to_bucket_sharded(block, rows, 2)
    start = {k: np.asarray(a)
             for k, a in ref_init_fm_params(nf, 4, 0.1, seed=5).items()}
    arrays = {f"start/{k}": v for k, v in start.items()}
    for r in range(2):
        for k, v in sharded.section(r).items():
            arrays[f"rank{r}/{k}"] = v
    np.savez(tmp_path / "world.npz", **arrays)
    (tmp_path / "spec.json").write_text(json.dumps(
        {"cases": WORLD_CASES, "nf": nf, "steps": steps}))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path)], cwd=tmp_path,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    padded = pad_to_bucket(block, rows)
    batch = {"label": padded.labels, "weight": padded.weights,
             "indices": padded.indices, "values": padded.values,
             "offsets": padded.offsets}
    batch = {k: torch.tensor(v) for k, v in batch.items()}
    for objective, l2 in WORLD_CASES:
        name = f"{objective}-{l2}"
        step = make_fm_train_step(None, nf, objective=objective,
                                  learning_rate=0.2, l2=l2)
        params = fm_params_from_numpy(start, "cpu")
        for s in range(steps):
            params, m = step(params, batch)
            np.testing.assert_allclose(ranks[0][f"{name}/loss{s}"],
                                       m["loss_sum"].numpy(), **STEP_TOL)
        want = fm_params_to_numpy(params)
        for k in ("w", "b", "v"):
            assert ranks[0][f"{name}/{k}"].tobytes() == \
                ranks[1][f"{name}/{k}"].tobytes(), (name, k)
            np.testing.assert_allclose(ranks[0][f"{name}/{k}"], want[k],
                                       err_msg=f"{name}/{k}", **STEP_TOL)

"""The port's kernels (``dmlc_tpu_torch/ops/kernels.py``) against the JAX
package's Pallas kernels on the same numpy inputs.

On the CPU the wrappers run their plain PyTorch versions, which are held
against ``dmlc_tpu.ops.pallas_kernels`` run in interpret mode and against the
JAX dense step with no Pallas. The CUDA kernels themselves are held against
the plain versions on the card, in tests/test_torch_cuda.py.
"""

import concurrent.futures
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.models.linear import _build_local_grads as jax_build_local_grads
from chip_smoke import read_lost_tile
from dmlc_tpu.ops import pallas_kernels as jax_kernels
from dmlc_tpu_torch.ops import kernels

OBJECTIVES = ("logistic", "squared", "hinge")
# (rows, features): ragged in both, a single row, and a batch spanning many
# tiles of both the JAX kernel (tile_b=256) and the CUDA kernel (128 rows)
SHAPES = ((700, 28), (1, 5), (2048, 16), (300, 64))


def _dense(seed, rows, features, integer):
    rng = np.random.RandomState(seed)
    if integer:
        x = rng.randint(-2, 3, (rows, features))
        w = rng.randint(-1, 2, features)
        b = 1.0
        label = rng.randint(0, 2, rows)
        weight = rng.randint(0, 3, rows)
    else:
        x = rng.rand(rows, features)
        w = rng.randn(features) * 0.1
        b = 0.05
        label = rng.rand(rows) > 0.5
        weight = rng.rand(rows)
    f32 = np.float32
    return (x.astype(f32), label.astype(f32), weight.astype(f32),
            w.astype(f32), f32(b))


def _jax_local_grads(objective, x, label, weight, w, b):
    grads = jax_build_local_grads(objective, "dense", x.shape[1], False)
    return grads({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                 {"x": jnp.asarray(x), "label": jnp.asarray(label),
                  "weight": jnp.asarray(weight)})


def _port(objective, x, label, weight, w, b):
    out = kernels.fused_linear_grads(
        torch.from_numpy(x), torch.from_numpy(label),
        torch.from_numpy(weight), torch.from_numpy(w), torch.tensor(b),
        objective=objective)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("rows,features", SHAPES)
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_fused_linear_grads_plain_matches_jax(objective, rows, features):
    integer = objective != "logistic"
    args = _dense(rows + features, rows, features, integer)
    got = _port(objective, *args)
    pallas = jax_kernels.fused_linear_grads(
        *args, objective=objective, tile_b=256, interpret=True)
    xla = _jax_local_grads(objective, *args)
    assert got[0].shape == (features,)
    assert all(g.dtype == np.float32 for g in got)
    for want in (pallas, xla):
        for g, wnt in zip(got, want):
            if integer:
                # integer-valued f32: every product and sum is exact, so
                # any order of summation gives the same bits
                assert np.array_equal(g, np.asarray(wnt))
            else:
                # another order of f32 summation, and two math libraries'
                # exp/log1p: a few ulps on sums of hundreds of terms
                np.testing.assert_allclose(g, np.asarray(wnt), rtol=1e-5,
                                           atol=1e-6)


def test_fused_linear_grads_rejects_unknown_objective():
    args = [torch.from_numpy(a) for a in _dense(0, 8, 3, True)[:4]]
    with pytest.raises(Exception, match="unknown objective"):
        kernels.fused_linear_grads(*args, torch.tensor(0.0),
                                   objective="poisson")


def _segments(seed, entries, rows):
    """Integer-valued contributions over unsorted row ids, with a padded
    tail (contrib 0) and -1 pad ids as the JAX wrapper's alignment pad."""
    rng = np.random.RandomState(seed)
    rid = rng.randint(0, rows, size=entries).astype(np.int32)
    contrib = rng.randint(-5, 6, size=entries).astype(np.float32)
    contrib[-entries // 8:] = 0.0
    rid[-entries // 16:] = -1
    return contrib, rid


@pytest.mark.parametrize("entries,rows", [(256, 6), (2048, 4096), (777, 100)])
def test_coo_segment_sum_plain_matches_jax(entries, rows):
    contrib, rid = _segments(entries + rows, entries, rows)
    got = kernels.coo_segment_sum(torch.from_numpy(contrib),
                                  torch.from_numpy(rid), rows)
    want = jax_kernels.coo_segment_sum(jnp.asarray(contrib), jnp.asarray(rid),
                                       rows, interpret=True)
    assert got.shape == (rows,) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_coo_segment_sum_drops_out_of_range_ids():
    contrib = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0])
    rid = torch.tensor([0, -1, 2, 3, 7], dtype=torch.int32)
    got = kernels.coo_segment_sum(contrib, rid, 3)
    assert torch.equal(got, torch.tensor([1.0, 0.0, 4.0]))


def test_plain_route_counts_no_launch():
    kernels.reset_launch_counts()
    args = [torch.from_numpy(a) for a in _dense(1, 16, 4, True)[:4]]
    kernels.fused_linear_grads(*args, torch.tensor(0.0))
    kernels.coo_segment_sum(torch.ones(4), torch.zeros(4, dtype=torch.int32),
                            2)
    kernels.sorted_segment_sum(torch.ones(4, 2),
                               torch.tensor([1, 0, 1, 1]), 3)
    kernels.tokenize_boundaries(torch.tensor(list(b"1 2:3\n"),
                                             dtype=torch.uint8))
    assert {k: fn.launches for k, fn in kernels.KERNELS.items()} == {
        "fused_linear_grads": 0, "coo_segment_sum": 0,
        "sorted_segment_sum": 0, "flash_attention_fwd": 0,
        "flash_attention_bwd": 0, "tokenize_boundaries": 0}


def test_launch_counts_lose_nothing_under_threads():
    """8 threads x 10,000 increments through count_launch, with the
    interpreter switching threads every microsecond: a thread switch
    between the read and the write of a bare += loses an increment, the
    lock keeps them all. reset_launch_counts takes the same lock."""
    def counter():
        pass

    counter.launches = 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            futures = [pool.submit(lambda: [kernels.count_launch(counter)
                                            for _ in range(10_000)])
                       for _ in range(8)]
            for f in concurrent.futures.as_completed(futures, timeout=120):
                f.result()
    finally:
        sys.setswitchinterval(switch)
    assert counter.launches == 80_000
    kernels.count_launch(kernels.tokenize_boundaries)
    kernels.reset_launch_counts()
    assert kernels.tokenize_boundaries.launches == 0


def test_fused_tile_rows_matches_the_kernel_source():
    """FUSED_TILE_ROWS sizes the partial rows that the wrapper allocates
    for csrc/fused_linear_grads.cu, whose tile is kWarps x kRowsPerWarp
    rows (the kernel refuses any other tile_rows)."""
    src = (Path(kernels.__file__).parent / "csrc"
           / "fused_linear_grads.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in
              re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kWarps"] * consts["kRowsPerWarp"] == kernels.FUSED_TILE_ROWS


@pytest.mark.parametrize("rows", [1000, 129])
def test_lost_tile_fault_fails_the_fused_limit(rows):
    """chip_smoke.py's phase-3 fault on the plain route: the sums without
    the last tile's rows (a lost partial row) read outside FUSED_TOL."""
    args = [torch.from_numpy(np.asarray(a))
            for a in _dense(3, rows, 29, False)]
    assert read_lost_tile(kernels, args) > 1.0


def test_empty_launches_needs_a_cuda_device():
    """The launch floor's empty kernel is a measuring aid: it launches only
    on a CUDA device and is no entry of KERNELS."""
    with pytest.raises(Exception, match="CUDA"):
        kernels.empty_launches(1, "cpu")
    assert "empty_launches" not in kernels.KERNELS


def test_tokenize_boundaries_takes_uint8_vectors_only():
    with pytest.raises(Exception, match="uint8"):
        kernels.tokenize_boundaries(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(Exception, match="1-d"):
        kernels.tokenize_boundaries(torch.zeros(2, 2, dtype=torch.uint8))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bwd_cpu_route_is_the_plain_version(causal):
    """On CPU tensors the one backward wrapper returns (dq, dk, dv) of the
    plain version, after the same input checks as on the card (lse and
    delta as [B, H, T]), and counts no launch."""
    rng = np.random.RandomState(11)
    b, t, h, hk, d = 2, 37, 4, 2, 32
    q, k, v, dout = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                     for s in ((b, t, h, d), (b, t, hk, d), (b, t, hk, d),
                               (b, t, h, d)))
    lse = torch.zeros(b, h, t)
    kernels.reset_launch_counts()
    got = kernels.flash_attention_bwd(q, k, v, dout, lse, lse, causal)
    want = kernels.flash_attention_bwd_plain(q, k, v, dout, causal)
    assert len(got) == 3
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.flash_attention_bwd.launches == 0
    with pytest.raises(Exception, match="lse must have shape"):
        kernels.flash_attention_bwd(q, k, v, dout, lse[:, :, 1:], lse,
                                    causal)
    with pytest.raises(Exception, match="delta must have shape"):
        kernels.flash_attention_bwd(q, k, v, dout, lse, lse.transpose(1, 2),
                                    causal)

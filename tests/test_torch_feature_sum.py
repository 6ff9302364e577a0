"""FM's packed feature-direction sum, and the order of the card's route of
``feature_segment_sum``, on the CPU.

- ``models/fm._fm_forward_grads`` takes gw and gv in ONE
  ``feature_segment_sum`` of [E, 1 + K] entries (gw's values·wg[row] in
  column 0). gw and gv are bit-equal to the two calls the step made
  before: ``spmv_transpose`` for gw, an [E, K] ``feature_segment_sum`` for
  dv. So gw keeps the linear fit's bits.
- On the card, ``kernels.sorted_segment_sum`` stable-sorts the ids and
  sums the sorted entries in one kernel, each column in the order
  ``index_put_`` gave it: a vector ([E], or FM's gw apart) in 32 lane
  sums, a shuffle-down tree and the tail in order; the columns of [E, C]
  in entry order. ``chip_smoke.sorted_sum_order`` is that order on the
  CPU: at ``chip_smoke.feature_sum_cases`` it gives the CPU route's bits
  on integer data, its row columns give them on float data too, and its
  vector columns stay within rtol 1e-5 / atol 1e-5 of the float64 sum.
  tests/test_torch_cuda.py holds the kernel's bits to it on the card.
  The kernel's tile is ``kernels.SORTED_TILE``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (FM_PACKED_COLS, cell_feature_ids,
                        feature_sum_cases, sorted_sum_order)
from dmlc_tpu_torch.models.fm import _fm_forward_grads, _fm_margin
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops.objectives import margin_loss_grad
from dmlc_tpu_torch.ops.spmv import (expand_row_ids, feature_segment_sum,
                                     spmv_transpose)

CASES = {name: (ids, nf) for name, ids, nf in feature_sum_cases()}


def _zipf_batch(rng, rows, nf, per_row, bucket, integer):
    """A padded csr batch of tensors: ``per_row`` ids a row drawn ~1/(r+1)
    over [1, nf) (long runs of the commonest ids), sorted in each row;
    values in {1, 2} or floats, 0/1 labels, the tail padded with value 0
    at feature 0."""
    nnz = rows * per_row
    rank = np.floor(np.exp(rng.rand(nnz) * np.log(nf))).astype(np.int64)
    ids = np.sort(np.minimum(rank, nf - 1).reshape(rows, per_row), axis=1)
    indices = np.zeros(bucket, np.int32)
    values = np.zeros(bucket, np.float32)
    indices[:nnz] = ids.ravel()
    values[:nnz] = rng.randint(1, 3, nnz) if integer else rng.rand(nnz)
    batch = {"label": rng.randint(0, 2, rows).astype(np.float32),
             "weight": (rng.rand(rows) + 0.5).astype(np.float32),
             "indices": indices, "values": values,
             "offsets": (np.arange(rows + 1) * per_row).astype(np.int32)}
    return {k: torch.tensor(v) for k, v in batch.items()}


def _separate_calls(params, batch, objective, nf):
    """(gw, gv) as the step took them before the packed call: gw through
    ``spmv_transpose``, gv through an [E, K] ``feature_segment_sum``."""
    values, indices = batch["values"], batch["indices"]
    row_ids = expand_row_ids(batch["offsets"], values.shape[0])
    margin, s, xv = _fm_margin(params, values, indices, row_ids,
                               batch["label"].shape[0])
    _, gmargin = margin_loss_grad(objective, margin, batch["label"])
    wg = batch["weight"] * gmargin
    dv_entry = (wg.index_select(0, row_ids) * values)[:, None] * (
        s.index_select(0, row_ids) - xv)
    return (spmv_transpose(values, indices, row_ids, wg, nf),
            feature_segment_sum(dv_entry, indices, nf))


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("objective", ["logistic", "squared"])
@pytest.mark.parametrize("k", [1, 8])
def test_fm_packed_sum_keeps_the_separate_calls_bits(k, objective,
                                                     integer):
    rng = np.random.RandomState(k + 3 * integer)
    nf = 2000
    batch = _zipf_batch(rng, 256, nf, 39, 10_240, integer)
    params = {"w": torch.tensor((rng.randn(nf) * 0.1).astype(np.float32)),
              "b": torch.tensor(np.float32(0.05)),
              "v": torch.tensor((rng.randn(nf, k) * 0.1).astype(
                  np.float32))}
    gw, _, gv, _, _ = _fm_forward_grads(params, batch, objective, nf)
    want_gw, want_gv = _separate_calls(params, batch, objective, nf)
    assert gw.shape == (nf,) and gv.shape == (nf, k)
    assert torch.equal(gw, want_gw)
    assert torch.equal(gv, want_gv)
    assert gw.any() and gv.any()


@pytest.mark.parametrize("cols", [0, 8, FM_PACKED_COLS])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_order_gives_the_cpu_bits_on_integer_data(case, cols):
    ids, nf = CASES[case]
    rng = np.random.RandomState(len(ids) + cols)
    shape = (len(ids),) + ((cols,) if cols else ())
    contrib = torch.tensor(rng.randint(-5, 6, shape).astype(np.float32))
    apart = cols == FM_PACKED_COLS
    want = kernels.sorted_segment_sum_plain(contrib, torch.tensor(ids), nf)
    got = sorted_sum_order(contrib.numpy(), ids, nf,
                           kernels.vector_columns(contrib, apart))
    assert got.shape == tuple(want.shape)
    assert got.tobytes() == want.numpy().tobytes()
    assert torch.equal(feature_segment_sum(contrib, torch.tensor(ids), nf,
                                           apart), want)


def test_sorted_order_rows_are_the_cpu_route():
    """On float data, the row columns of FM's packed call (dv) are summed
    in entry order: the CPU route's bits."""
    ids = cell_feature_ids(6)
    rng = np.random.RandomState(6)
    contrib = (rng.rand(len(ids), 1) * 0.1
               * rng.randn(len(ids), FM_PACKED_COLS)).astype(np.float32)
    nf = int(ids.max()) + 1
    got = sorted_sum_order(contrib, ids, nf, 1)
    want = kernels.sorted_segment_sum_plain(torch.tensor(contrib),
                                            torch.tensor(ids), nf).numpy()
    assert got[:, 1:].tobytes() == np.ascontiguousarray(
        want[:, 1:]).tobytes()


@pytest.mark.parametrize("cols", [1, 9])
def test_vector_order_is_near_the_exact_sum(cols):
    """At the criteo-fm cell's step with FM-scale float contributions, the
    vector order stays within rtol 1e-5 / atol 1e-5 of the float64 sum,
    as the card test holds the kernel's gw, and column c of a 9-column
    vector sum is the 1-column sum of it."""
    ids = cell_feature_ids(7)
    rng = np.random.RandomState(cols)
    contrib = (rng.rand(len(ids), 1) * 0.1
               * rng.randn(len(ids), cols)).astype(np.float32)
    nf = int(ids.max()) + 1
    got = sorted_sum_order(contrib, ids, nf)
    exact = np.zeros((nf, cols))
    np.add.at(exact, ids, contrib.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)
    if cols > 1:
        assert np.ascontiguousarray(got[:, 2]).tobytes() == sorted_sum_order(
            np.ascontiguousarray(contrib[:, 2]), ids, nf).tobytes()


def test_sorted_tile_is_the_kernels():
    src = (Path(kernels.__file__).parent / "csrc"
           / "sorted_segment_sum.cu").read_text()
    got = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert got["kThreads"] * got["kPerThread"] == kernels.SORTED_TILE

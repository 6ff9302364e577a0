"""Sparse matrix-vector products for device csr batches (the port of
``dmlc_tpu/ops/spmv.py``).

Batches carry CSR ``offsets``; :func:`expand_row_ids` turns them into
per-entry row ids on the device. The forward SpMV is a gather plus a
row-direction segment sum (:func:`spmv`, or :func:`spmv_kernel` with the
reduce on the CUDA kernel ``coo_segment_sum``); the gradient
(:func:`spmv_transpose`) is a segment sum keyed by feature id. Padded
entries (value 0 at feature 0) are arithmetic no-ops in both directions.

Determinism: nothing here adds floats with atomics, and ``spmv_transpose``
repeats its bits on both routes. On CUDA it uses ``index_put_`` with
``accumulate=True``, which sorts the entries by feature id and reduces each
run of one id in a fixed order (PyTorch's ``index_put_with_sort`` path;
chip_smoke.py checks the same bits run after run). On the CPU, where
``index_put_`` adds over threads in an order that changes from run to run,
it sorts the entries by feature id (stably) and sums each feature's run
in entry order from 0, the order of the reference's CPU scatter
(``jax.ops.segment_sum``).
"""

from __future__ import annotations

import torch

from dmlc_tpu_torch.ops.kernels import coo_segment_sum, coo_segment_sum_plain


def expand_row_ids(offsets: torch.Tensor, nnz: int) -> torch.Tensor:
    """[rows + 1] CSR offsets → [nnz] int32 COO row ids, on the tensor's
    device.

    Entry e's row is #{r ≥ 1 : offsets[r] ≤ e}: a mark at every row
    boundary, then an inclusive cumsum. When the batch fills the bucket
    exactly (offsets[rows] == nnz) the tail boundary marks land past the
    end and are dropped (the reference's ``mode="drop"``); when the valid
    nnz is below the bucket, the padded rows' marks land at the valid-nnz
    index, the padded entries' cumsum overshoots, and the clamp to the LAST
    row absorbs them — harmless, since padded values are 0. The ids never
    decrease, which the ``coo_segment_sum`` kernel relies on.
    """
    marks = torch.zeros(nnz + 1, dtype=torch.int32, device=offsets.device)
    # slot nnz collects every mark at or past the end, and is dropped
    bounds = torch.clamp_max(offsets[1:].long(), nnz)
    marks.index_add_(0, bounds, torch.ones_like(bounds, dtype=torch.int32))
    # int32 in, int32 out: torch.cumsum would promote to int64 by default
    rows = torch.cumsum(marks[:nnz], dim=0, dtype=torch.int32)
    return torch.clamp_max(rows, offsets.shape[0] - 2)


def spmv(values, indices, row_ids, weight_vec, num_rows: int):
    """y[r] = Σ_{e: row_ids[e]==r} values[e] * weight_vec[indices[e]] in
    plain PyTorch ops. values/indices/row_ids: [nnz]; returns [num_rows]."""
    contrib = values * weight_vec.index_select(0, indices)
    return coo_segment_sum_plain(contrib, row_ids, num_rows)


def spmv_kernel(values, indices, row_ids, weight_vec, num_rows: int):
    """:func:`spmv` with the row-direction reduce on ``coo_segment_sum``
    (the CUDA kernel on a CUDA tensor, which needs non-decreasing
    ``row_ids``; its plain version on the CPU)."""
    contrib = values * weight_vec.index_select(0, indices)
    return coo_segment_sum(contrib, row_ids, num_rows)


def spmv_transpose(values, indices, row_ids, row_grads, num_features: int):
    """g[f] = Σ_{e: indices[e]==f} values[e] * row_grads[row_ids[e]]: the
    gradient of :func:`spmv` with respect to ``weight_vec``. Returns
    [num_features], the same bits on every run (module docstring)."""
    contrib = values * row_grads.index_select(0, row_ids)
    out = torch.zeros(num_features, dtype=contrib.dtype,
                      device=contrib.device)
    if contrib.device.type != "cpu":
        return out.index_put_((indices.long(),), contrib, accumulate=True)
    if contrib.numel() == 0:
        return out
    # the CPU route: each feature's run in entry order, summed from 0 one
    # run at a time (segment_reduce's CPU loop), whatever the thread count
    feature, order = torch.sort(indices, stable=True)
    ids, counts = torch.unique_consecutive(feature, return_counts=True)
    out[ids.long()] = torch.segment_reduce(contrib[order], "sum",
                                           lengths=counts)
    return out

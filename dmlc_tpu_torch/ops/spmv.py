"""Sparse matrix-vector products for device csr batches (the port of
``dmlc_tpu/ops/spmv.py``).

Batches carry CSR ``offsets``; :func:`expand_row_ids` turns them into
per-entry row ids on the device. The forward SpMV is a gather plus a
row-direction segment sum (:func:`spmv`, or :func:`spmv_kernel` with the
reduce on the CUDA kernel ``coo_segment_sum``); the gradient
(:func:`spmv_transpose`) is a segment sum keyed by feature id,
:func:`feature_segment_sum`, which FM's factor gradient also takes with a
trailing dimension. Padded entries (value 0 at feature 0) are arithmetic
no-ops in both directions.

:func:`make_sharded_spmv` is the forward SpMV over one rank's section of
a ``device/csr.ShardedCSRBatch``: the section's entries only, its local
offsets, its rows' slice of the output.

Determinism: nothing here adds floats with atomics, and
``feature_segment_sum`` repeats its bits on both routes
(``ops/kernels.sorted_segment_sum``). Both sort the entries by feature id
once (stably). On CUDA one kernel launch then sums the sorted entries,
read through the sort's permutation, a fixed number of entries a CTA
whatever the runs' lengths, each column in the order ``index_put_`` with
``accumulate=True`` gave it before (a vector's runs in 32 lane sums and a
tree, the columns of [E, C] in entry order), so the bits are the old
route's. On the CPU each feature's run is summed in entry order from 0,
the order of the reference's CPU scatter (``jax.ops.segment_sum``). On
integer-valued contributions the two routes give the same bits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dmlc_tpu_torch.ops.kernels import (coo_segment_sum,
                                        coo_segment_sum_plain,
                                        sorted_segment_sum)
from dmlc_tpu_torch.utils.logging import check


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


def feature_segment_sum(contrib, indices, num_features: int,
                        first_apart: bool = False):
    """g[f] = Σ_{e: indices[e]==f} contrib[e] for contrib [E] or [E, C];
    returns [num_features] or [num_features, C], the same bits on every run
    (module docstring): ``kernels.sorted_segment_sum``, one sort and one
    kernel launch on the card. ``first_apart`` sums column 0 of [E, 1 + K]
    as the [E] call on it would and the rest as the [E, K] call (FM's gw
    packed beside dv)."""
    return sorted_segment_sum(contrib, indices, num_features, first_apart)


def spmv_transpose(values, indices, row_ids, row_grads, num_features: int):
    """g[f] = Σ_{e: indices[e]==f} values[e] * row_grads[row_ids[e]]: the
    gradient of :func:`spmv` with respect to ``weight_vec``. Returns
    [num_features], the same bits on every run (module docstring)."""
    contrib = values * row_grads.index_select(0, row_ids)
    return feature_segment_sum(contrib, indices, num_features)


def make_sharded_spmv(num_rows: int, group=None):
    """SpMV with entries and output rows split over the ranks of ``group``
    (None: one rank), the counterpart of the reference's shard_map over a
    ``ShardedCSRBatch``. Returns f(values, indices, offsets, weight_vec) ->
    [num_rows / world]: this rank's section (``ShardedCSRBatch.section``)
    with its local CSR offsets, expanded to local row ids on the section's
    device and summed by ``coo_segment_sum``; ``weight_vec`` is the whole
    vector on every rank. Nothing crosses the group: each rank's rows need
    only its own entries."""
    world = 1 if group is None else dist.get_world_size(group)
    check(num_rows % world == 0,
          "num_rows %d must divide over the group's %d ranks", num_rows,
          world)
    rows_local = num_rows // world

    def local(values, indices, offsets, weight_vec):
        row_ids = expand_row_ids(offsets, values.shape[0])
        return spmv_kernel(values, indices, row_ids, weight_vec, rows_local)

    return local

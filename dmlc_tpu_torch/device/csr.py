"""Static-shape padding of host RowBlocks into device-ready batches, copied
from ``dmlc_tpu/device/csr.py``.

Invariants (the same as the reference's, and what makes padding free):

- the row count is fixed per feed (``batch_size``); a short final batch is
  padded with zero-weight rows, so their loss and gradient vanish;
- the csr nnz is rounded up to a bucket (:func:`round_up_bucket`); padded
  entries have value 0 at feature 0, so they are arithmetic no-ops in both
  directions of the SpMV;
- the csr row mapping ships as CSR ``offsets`` (padded rows repeat the
  valid nnz); the device expands them into per-entry row ids
  (ops/spmv.expand_row_ids).

:func:`emit_to_bucket` pads a ``RowBlockContainer`` in place, the feed's
csr route: the parsed parts' one copy lands in the staging arrays.
:class:`ShardedCSRBatch` (:func:`pad_to_bucket_sharded`) splits a batch by
row range into per-rank sections with local row ids, so that each rank of
a group receives only its own entries.

``pool`` (device/feed.PinnedPool on a CUDA feed) hands out the staging
arrays, so that the host copy lands straight in pinned memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.utils.logging import check


NNZ_FLOOR = 256  # the smallest bucket, and the step of small buckets


def round_up_bucket(n: int) -> int:
    """Static-shape nnz bucket ≥ n: the next multiple of a sixteenth of the
    enclosing power of two (at least :data:`NNZ_FLOOR`). The waste is
    bounded at ~12.5% of n while a steady feed sees one or two distinct
    shapes."""
    n = max(n, NNZ_FLOOR, 1)
    pow2 = 1 << (n - 1).bit_length()
    step = max(NNZ_FLOOR, pow2 >> 4)
    return ((n + step - 1) // step) * step


@dataclass
class DeviceCSRBatch:
    """A static-shape sparse batch (host numpy arrays).

    labels/weights are [batch]; indices/values are [bucket]; offsets is
    [batch + 1]. Padded entries have value 0 at feature 0.
    """

    labels: np.ndarray  # [batch] f32
    weights: np.ndarray  # [batch] f32 (0.0 for padded rows)
    indices: np.ndarray  # [bucket] i32 feature ids
    values: np.ndarray  # [bucket] f32 (0.0 for padded entries)
    offsets: np.ndarray  # [batch + 1] i32; padded rows repeat the valid nnz
    num_rows: int  # valid rows
    num_nonzero: int  # valid entries

    @property
    def batch_size(self) -> int:
        return len(self.labels)

    @property
    def nnz_bucket(self) -> int:
        return len(self.indices)


def _bucket(nnz: int, nnz_bucket: Optional[int]) -> int:
    """The nnz bucket: a fixed ``nnz_bucket`` (one static shape for a
    whole feed), else :func:`round_up_bucket`."""
    bucket = round_up_bucket(nnz) if nnz_bucket is None else int(nnz_bucket)
    check(nnz <= bucket, "nnz exceeds bucket")
    return bucket


def _staging(pool, shape, dtype):
    """A zeroed staging array: from ``pool`` when given, else np.zeros."""
    if pool is None:
        return np.zeros(shape, dtype=dtype)
    buf = pool.acquire(shape, dtype)
    buf.fill(0)
    return buf


def pad_to_bucket(
    block: RowBlock,
    batch_size: int,
    nnz_bucket: Optional[int] = None,
    pool=None,
) -> DeviceCSRBatch:
    """Pad a host RowBlock slice into a static-shape DeviceCSRBatch;
    ``nnz_bucket`` fixes the entry arrays' length (a bucket smaller than
    the slice's nnz raises)."""
    n = len(block)
    check(n <= batch_size, "block larger than batch_size")
    nnz = block.num_nonzero
    bucket = _bucket(nnz, nnz_bucket)

    labels = _staging(pool, batch_size, np.float32)
    labels[:n] = block.label
    weights = _staging(pool, batch_size, np.float32)
    weights[:n] = 1.0 if block.weight is None else block.weight

    indices = _staging(pool, bucket, np.int32)
    values = _staging(pool, bucket, np.float32)
    indices[:nnz] = block.index
    values[:nnz] = (
        np.ones(nnz, dtype=np.float32) if block.value is None else block.value
    )
    if pool is None:
        offsets = np.full(batch_size + 1, nnz, dtype=np.int32)
    else:
        offsets = pool.acquire(batch_size + 1, np.int32)
        offsets.fill(nnz)
    offsets[: n + 1] = np.asarray(block.offset[: n + 1], dtype=np.int32)
    return DeviceCSRBatch(
        labels=labels,
        weights=weights,
        indices=indices,
        values=values,
        offsets=offsets,
        num_rows=n,
        num_nonzero=nnz,
    )


def _staging_raw(pool, shape, dtype):
    """An uncleared staging array (pooled, or a fresh np.empty): the emit
    path overwrites the valid prefix and zeroes only the pad tail."""
    if pool is None:
        return np.empty(shape, dtype=dtype)
    return pool.acquire(shape, dtype)


def emit_to_bucket(
    container: RowBlockContainer,
    batch_size: int,
    nnz_bucket: Optional[int] = None,
    pool=None,
) -> DeviceCSRBatch:
    """Pad in place: emit a ``RowBlockContainer``'s rows straight into a
    static-shape DeviceCSRBatch's staging arrays
    (``RowBlockContainer.emit_csr_into``), the one copy of
    ``to_block()`` + :func:`pad_to_bucket`. Only the pad tails are zeroed:
    padded entries have value 0 at feature 0, padded rows weight 0.
    ``nnz_bucket`` as in :func:`pad_to_bucket`."""
    n = container.size
    check(n <= batch_size, "container larger than batch_size")
    nnz = container.num_nonzero
    bucket = _bucket(nnz, nnz_bucket)

    labels = _staging_raw(pool, batch_size, np.float32)
    weights = _staging_raw(pool, batch_size, np.float32)
    indices = _staging_raw(pool, bucket, np.int32)
    values = _staging_raw(pool, bucket, np.float32)
    offsets = _staging_raw(pool, batch_size + 1, np.int32)
    container.emit_csr_into(labels, weights, indices, values, offsets)
    labels[n:] = 0.0
    weights[n:] = 0.0
    indices[nnz:] = 0
    values[nnz:] = 0.0
    offsets[n + 1:] = nnz
    return DeviceCSRBatch(
        labels=labels,
        weights=weights,
        indices=indices,
        values=values,
        offsets=offsets,
        num_rows=n,
        num_nonzero=nnz,
    )


@dataclass
class ShardedCSRBatch:
    """A static-shape COO batch partitioned by destination rank.

    indices/values/row_ids are flat [num_shards * nnz_bucket] with one
    contiguous section a shard and LOCAL row ids (shard s owns rows
    [s*rows_per_shard, (s+1)*rows_per_shard)); offsets holds each section's
    local CSR offsets, [num_shards * (rows_per_shard + 1)]. Rank s of a
    group takes section s only, so that each rank receives ∝ nnz / world.
    """

    labels: np.ndarray  # [batch] f32
    weights: np.ndarray  # [batch] f32 (0.0 for padded rows)
    indices: np.ndarray  # [num_shards * nnz_bucket] i32
    values: np.ndarray  # [num_shards * nnz_bucket] f32
    row_ids: np.ndarray  # [num_shards * nnz_bucket] i32, local per shard
    offsets: np.ndarray  # [num_shards * (rows_per_shard + 1)] i32
    num_rows: int
    num_nonzero: int
    num_shards: int
    nnz_bucket: int  # per shard

    @property
    def batch_size(self) -> int:
        return len(self.labels)

    def section(self, shard: int) -> dict:
        """Shard ``shard``'s arrays: its rows' labels and weights and its
        entries' indices, values, local row ids and local offsets."""
        rows = self.batch_size // self.num_shards
        ent = slice(shard * self.nnz_bucket, (shard + 1) * self.nnz_bucket)
        return {
            "label": self.labels[shard * rows:(shard + 1) * rows],
            "weight": self.weights[shard * rows:(shard + 1) * rows],
            "indices": self.indices[ent],
            "values": self.values[ent],
            "row_ids": self.row_ids[ent],
            "offsets": self.offsets[shard * (rows + 1):
                                    (shard + 1) * (rows + 1)],
        }


def pad_to_bucket_sharded(
    block: RowBlock,
    batch_size: int,
    num_shards: int,
) -> ShardedCSRBatch:
    """Partition a RowBlock's entries by destination shard (row-range
    split) into per-shard padded sections, one nnz bucket for all of them
    (the bucket of the fullest shard)."""
    n = len(block)
    check(n <= batch_size, "block larger than batch_size")
    check(batch_size % num_shards == 0,
          "batch_size %d must divide over %d shards", batch_size, num_shards)
    rows_per_shard = batch_size // num_shards

    labels = np.zeros(batch_size, dtype=np.float32)
    labels[:n] = block.label
    weights = np.zeros(batch_size, dtype=np.float32)
    weights[:n] = 1.0 if block.weight is None else block.weight

    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(block.offset).astype(np.int64))
    vals = (np.ones(block.num_nonzero, dtype=np.float32)
            if block.value is None else np.asarray(block.value, np.float32))
    counts = np.bincount(rows // rows_per_shard, minlength=num_shards)
    bucket = round_up_bucket(int(counts.max()) if len(rows) else 0)

    indices = np.zeros(num_shards * bucket, dtype=np.int32)
    values = np.zeros(num_shards * bucket, dtype=np.float32)
    row_ids = np.zeros(num_shards * bucket, dtype=np.int32)
    offsets = np.zeros(num_shards * (rows_per_shard + 1), dtype=np.int32)
    # entries arrive row-major, so each shard's entries are contiguous
    start = 0
    for s in range(num_shards):
        c = int(counts[s])
        seg = slice(start, start + c)
        out = slice(s * bucket, s * bucket + c)
        indices[out] = block.index[seg]
        values[out] = vals[seg]
        local = rows[seg] - s * rows_per_shard
        row_ids[out] = local
        # the section's local CSR offsets (padded rows repeat c)
        base = s * (rows_per_shard + 1)
        offsets[base:base + rows_per_shard + 1] = np.searchsorted(
            local, np.arange(rows_per_shard + 1), side="left")
        start += c
    return ShardedCSRBatch(
        labels=labels,
        weights=weights,
        indices=indices,
        values=values,
        row_ids=row_ids,
        offsets=offsets,
        num_rows=n,
        num_nonzero=block.num_nonzero,
        num_shards=num_shards,
        nnz_bucket=bucket,
    )


def block_to_dense(
    block: RowBlock, batch_size: int, num_features: int, pool=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Densify a RowBlock into fixed [batch, num_features] — the layout for
    small dense feature spaces (HIGGS's 28). Feature ids at or beyond
    ``num_features`` are dropped."""
    n = len(block)
    check(n <= batch_size, "block larger than batch_size")
    x = _staging(pool, (batch_size, num_features), np.float32)
    rows = np.repeat(np.arange(n), np.diff(block.offset).astype(np.int64))
    vals = (
        np.ones(block.num_nonzero, dtype=np.float32)
        if block.value is None
        else block.value
    )
    keep = block.index < num_features
    x[rows[keep], block.index[keep]] = vals[keep]
    labels = _staging(pool, batch_size, np.float32)
    labels[:n] = block.label
    weights = _staging(pool, batch_size, np.float32)
    weights[:n] = 1.0 if block.weight is None else block.weight
    return x, labels, weights

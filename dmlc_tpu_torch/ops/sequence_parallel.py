"""Sequence/context parallelism: ring attention and all-to-all attention —
the port of ``dmlc_tpu/ops/sequence_parallel.py``.

The JAX package makes the sequence dimension a mesh axis and runs each
schedule under ``shard_map``. Here the axis is a ``torch.distributed``
process group (``parallel/axis.py``) and every rank calls the schedule with
its own sequence shard:

- ``make_ring_attention``: K/V shards rotate around the group with
  ``ppermute`` while each rank accumulates its queries' attention in the
  online-softmax form (running max + denominator), so the full T×T score
  matrix never exists. Blocks wholly in a rank's causal future, or wholly
  outside its sliding window, are skipped; the rotation still runs.
- ``make_ulysses_attention`` (all-to-all): ``all_to_all`` re-shards
  sequence → heads, every rank runs full attention for its head group
  (exact softmax, any local kernel — :func:`make_flash_local` runs the
  hand-written CUDA flash kernels), and a second ``all_to_all`` restores the
  sequence sharding.

Shapes are [batch, seq, heads, head_dim] with ``seq`` sharded over the
group. Both equal :func:`full_attention` on the concatenated shards,
forward and gradients (tests/test_torch_sequence_parallel.py holds them
against the JAX package at 1, 2 and 4 ranks over gloo).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dmlc_tpu_torch.ops.attention import (
    NEG_INF,
    full_attention,
    group_ratio,
    grouped_pv,
    grouped_scores,
    keep_mask,
)
from dmlc_tpu_torch.ops.flash_attention import flash_attention
from dmlc_tpu_torch.parallel.axis import (
    all_to_all,
    axis_index,
    axis_size,
    keep_in_graph,
    ppermute,
)
from dmlc_tpu_torch.utils.logging import check


def _block_accumulate(q, k_blk, v_blk, m, l, o, q_pos, k_pos, causal,
                      window: int = 0):
    """One online-softmax block update (the flash-attention recurrence).

    q [B,Tq,H,D]; k_blk/v_blk [B,Tk,Hk,D] with Hk | H (GQA); m,l [B,H,Tq];
    o [B,Tq,H,D]. q_pos [Tq] / k_pos [Tk] are GLOBAL positions for causal
    and sliding-window masking. The accumulator stays per Q head; only the
    score/PV einsums group, and the ring ships the smaller KV shards.
    """
    s = grouped_scores(q, k_blk)
    if causal:
        s = s.masked_fill(~keep_mask(q_pos, k_pos, window), NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    pv = grouped_pv(p, v_blk)
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def zigzag_indices(t: int, num_devices: int):
    """Permutation mapping natural order → zigzag rank layout.

    The sequence splits into 2N equal chunks; rank i holds chunks
    (i, 2N-1-i) — one early + one late — so under CAUSAL masking every
    rank does the same score work per ring hop.
    """
    check(t % (2 * num_devices) == 0,
          "seq len %d must divide by 2*num_devices (%d)", t, 2 * num_devices)
    c = t // (2 * num_devices)
    order = []
    for i in range(num_devices):
        order.extend(range(i * c, (i + 1) * c))
        j = 2 * num_devices - 1 - i
        order.extend(range(j * c, (j + 1) * c))
    return np.asarray(order, dtype=np.int64)


def zigzag_shard(x, num_devices: int):
    """Reorder [B, T, ...] from natural to zigzag layout (rank i's
    contiguous shard then holds chunks i and 2N-1-i). Apply BEFORE cutting
    the sequence into per-rank shards."""
    perm = torch.as_tensor(zigzag_indices(x.shape[1], num_devices),
                           device=x.device)
    return x.index_select(1, perm)


def zigzag_unshard(x, num_devices: int):
    """Inverse of :func:`zigzag_shard`."""
    perm = zigzag_indices(x.shape[1], num_devices)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return x.index_select(1, torch.as_tensor(inv, device=x.device))


def _hop_needed(idx, src, size, t_local, causal, window, zigzag) -> bool:
    """Whether the K/V block that started on rank ``src`` can reach any of
    rank ``idx``'s queries (the block skips of the JAX schedule)."""
    if causal and not zigzag:
        # a block wholly in this rank's future is fully masked, and with a
        # window so is a block wholly older than every local query's
        # window: its youngest key is (src+1)*t_local - 1, the oldest
        # local query idx*t_local
        needed = src <= idx
        if window > 0:
            needed &= idx * t_local - ((src + 1) * t_local - 1) < window
        return needed
    if causal and window > 0:
        # zigzag + window: needed if any (q chunk, k chunk) pair has a hit,
        # i.e. q_hi >= k_lo (causal reach) and q_lo - k_hi < W
        c = t_local // 2

        def chunk_ranges(r):
            return ((r * c, (r + 1) * c - 1),
                    ((2 * size - 1 - r) * c, (2 * size - r) * c - 1))

        return any(qhi >= klo and qlo - khi < window
                   for qlo, qhi in chunk_ranges(idx)
                   for klo, khi in chunk_ranges(src))
    # zigzag pure causal: no hop is ever fully masked (the balance is the
    # optimization); positions make the masking exact
    return True


def make_ring_attention(group=None, causal: bool = False, window: int = 0,
                        layout: str = "contiguous", remat: bool = False):
    """f(q, k, v) -> out for this rank's sequence shard of the group.

    Each rank consumes its own K/V shard, then rotates K and V one hop
    around the ring (``ppermute``, stacked into one tensor) and consumes
    the block it receives; after axis_size - 1 rotations every query has
    seen every key. The accumulator is the online-softmax triple (m, l, o),
    so the result equals exact softmax attention, not an approximation.

    ``window > 0`` = mistral-style sliding window (implies causal). Blocks
    entirely outside every local query's window skip their compute exactly
    like fully-future causal blocks.

    ``layout="zigzag"``: the shards hold chunks (i, 2N-1-i) of 2N (inputs
    permuted with :func:`zigzag_shard` before sharding), which balances the
    causal work over the ranks.

    ``remat=True`` wraps each hop's block update in
    ``torch.utils.checkpoint``: the backward recomputes the hop's scores
    instead of keeping every hop's intermediates alive. The rotation stays
    outside the checkpoint, so no collective runs twice.

    Data parallelism composes by group: each data-parallel row of ranks
    passes its own sequence-parallel group made with ``dist.new_group``.
    """
    check(window >= 0, "window must be >= 0, got %d", window)
    check(layout in ("contiguous", "zigzag"),
          "layout must be 'contiguous' or 'zigzag', got %r", layout)
    causal = causal or window > 0
    zigzag = layout == "zigzag"

    def ring(q, k, v):
        group_ratio(q, k, v)
        size = axis_size(group)
        idx = axis_index(group)
        b, t_local, h, _ = q.shape
        if zigzag:
            check(t_local % 2 == 0,
                  "zigzag needs seq len %% 2*axis_size == 0 (T=%d, n=%d)",
                  t_local * size, size)
        ar = torch.arange(t_local, device=q.device)

        def dev_pos(r):
            if zigzag:
                c = t_local // 2
                return torch.cat([r * c + ar[:c],
                                  (2 * size - 1 - r) * c + ar[:c]])
            return r * t_local + ar

        q_pos = dev_pos(idx)
        m = torch.full((b, h, t_local), NEG_INF, dtype=q.dtype,
                       device=q.device)
        l = torch.zeros((b, h, t_local), dtype=q.dtype, device=q.device)
        o = torch.zeros_like(q)
        # block 0 (the local shard) first, then rotate-and-consume
        m, l, o = _block_accumulate(q, k, v, m, l, o, q_pos, q_pos, causal,
                                    window)
        kv = torch.stack((k, v))
        for step in range(1, size):
            kv = ppermute(kv, group, 1)
            # after `step` rotations this rank holds the shard that started
            # at ring position (idx - step) mod size
            src = (idx - step) % size
            if not _hop_needed(idx, src, size, t_local, causal, window,
                               zigzag):
                continue
            args = (q, kv[0], kv[1], m, l, o, q_pos, dev_pos(src), causal,
                    window)
            if remat:
                m, l, o = checkpoint(_block_accumulate, *args,
                                     use_reentrant=False)
            else:
                m, l, o = _block_accumulate(*args)
        if size > 1:
            o = keep_in_graph(o, kv)
        return o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]

    return ring


def make_ulysses_attention(group=None, causal: bool = False, window: int = 0,
                           local_attention=None):
    """f(q, k, v) -> out: all-to-all sequence↔head re-sharding.

    Each rank trades its sequence shard of every head for the FULL
    sequence of heads/axis_size heads, runs exact local attention (or a
    supplied ``local_attention(q, k, v)`` kernel — e.g.
    :func:`make_flash_local`), and the second all-to-all restores
    [seq-sharded, all heads].

    A custom kernel owns its own masking, so combining ``causal=True``
    with ``local_attention`` is rejected rather than silently dropped.
    Data parallelism composes by group, as in :func:`make_ring_attention`.
    """
    check(window >= 0, "window must be >= 0, got %d", window)
    check(
        not ((causal or window > 0) and local_attention is not None),
        "pass causality/windowing inside your local_attention kernel; the "
        "flags only configure the built-in full_attention",
    )
    fn = local_attention if local_attention is not None else partial(
        full_attention, causal=causal, window=window)

    def ulysses(q, k, v):
        n = axis_size(group)
        check(q.shape[2] % n == 0,
              "ulysses needs heads %% axis_size == 0 (got %d heads over %d)",
              q.shape[2], n)
        # GQA: KV heads re-shard over the same group, so they must divide
        # too (each rank then holds H/n query heads against Hk/n KV heads)
        check(k.shape[2] % n == 0,
              "ulysses needs kv_heads %% axis_size == 0 (got %d over %d)",
              k.shape[2], n)
        group_ratio(q, k, v)
        # [B, T_local, H, D] -> [B, T, H/n, D]: gather seq, scatter heads
        qh, kh, vh = (all_to_all(x, group, split_dim=2, concat_dim=1)
                      for x in (q, k, v))
        return all_to_all(fn(qh, kh, vh), group, split_dim=1, concat_dim=2)

    return ulysses


def make_flash_local(causal: bool = False):
    """A ``local_attention`` for :func:`make_ulysses_attention` backed by
    the hand-written CUDA flash-attention kernels (``ops/flash_attention``):
    the counterpart of ``make_pallas_flash_local`` in
    ``dmlc_tpu/ops/sequence_parallel.py``. The forward and backward never
    hold the T×T scores; GQA K/V heads are read in place rather than
    repeated to H. The TPU version's ``block_sizes`` has no counterpart:
    the CUDA tiles are fixed when the kernels are compiled, 128 query rows
    × 32 keys in the forward and 64 × 64 in the backward. On CPU tensors
    it runs the kernels' plain version."""

    def kernel(q, k, v):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal)

    return kernel

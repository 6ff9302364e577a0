"""Plain attention over [B, T, H, D] with grouped K/V heads: the reference
that the sequence-parallel schedules (``ops/sequence_parallel.py``) and the
flash-attention kernels (``ops/kernels.py``) are held to, and the block
update the ring schedule is built from.

The scores are materialised as [B, H, Tq, Tk]; query head h reads KV head
h // (H / H_kv), with no repeated K/V in memory.
"""

from __future__ import annotations

import math

import torch

from dmlc_tpu_torch.utils.logging import check

NEG_INF = -1e30  # mask value: large-negative beats -inf (0*inf=nan in bwd)


def group_ratio(q, k, v):
    """Q-heads per KV-head (grouped-query attention). 1 = classic MHA;
    H % H_kv must divide (llama-class GQA, MQA at H_kv = 1). K and V must
    agree, or the grouped einsums would silently mis-pair heads."""
    h, hk = q.shape[2], k.shape[2]
    check(k.shape[2] == v.shape[2],
          "k has %d heads but v has %d", k.shape[2], v.shape[2])
    check(h % hk == 0, "num_heads %d must divide by num_kv_heads %d", h, hk)
    return h // hk


def grouped_scores(q, k):
    """QKᵀ/√D with KV-head grouping: q [B,Tq,H,D] x k [B,Tk,Hk,D] →
    [B,H,Tq,Tk] (the G = H/Hk query heads of a group share one KV head —
    no materialized KV repeat)."""
    b, t_q, h, d = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, t_q, hk, h // hk, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (1.0 / math.sqrt(float(d)))
    return s.reshape(b, h, t_q, k.shape[1])


def grouped_pv(p, v):
    """probs [B,H,Tq,Tk] x v [B,Tk,Hk,D] → [B,Tq,H,D] under grouping."""
    b, h, t_q, t_k = p.shape
    hk = v.shape[2]
    pg = p.reshape(b, hk, h // hk, t_q, t_k)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pg, v)
    return out.reshape(b, t_q, h, v.shape[-1])


def keep_mask(q_pos, k_pos, window: int = 0):
    """[Tq, Tk] bool: the query at global position q_pos sees the key at
    k_pos (causal; with ``window > 0`` also q_pos - k_pos < window)."""
    mask = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def masked_scores(q, k, causal: bool = False, window: int = 0):
    """[B, H, Tq, Tk] scores of :func:`grouped_scores`, set to NEG_INF where
    ``causal`` or the sliding ``window`` hides the key (positions count
    from 0 on both sides)."""
    s = grouped_scores(q, k)
    if causal or window > 0:
        q_pos, k_pos = (torch.arange(n, device=q.device) for n in s.shape[2:])
        s = s.masked_fill(~keep_mask(q_pos, k_pos, window), NEG_INF)
    return s


def full_attention(q, k, v, causal: bool = False, window: int = 0):
    """Reference single-device attention: softmax(QKᵀ/√d)V.

    q [B, T, H, D]; k/v [B, T, H_kv, D] with H_kv | H (GQA/MQA — H_kv = H
    is classic MHA); out [B, T, H, D]. ``window > 0`` adds mistral-style
    sliding-window masking (query p attends keys in (p-window, p]; implies
    causal). The parity oracle for the sharded schedules and the flash
    kernels' plain version; it materialises the [B, H, T, T] scores and is
    differentiated by autograd."""
    check(window >= 0, "window must be >= 0, got %d", window)
    group_ratio(q, k, v)
    return grouped_pv(torch.softmax(masked_scores(q, k, causal, window), -1),
                      v)

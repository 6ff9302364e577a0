"""Expert parallelism: switch-style MoE dispatch over a process group (the
port of ``dmlc_tpu/ops/moe.py``).

- experts are SHARDED over the expert-parallel group (each rank owns
  ``num_experts / n`` expert FFNs: model memory scales out);
- tokens stay sharded over the same group: every rank calls the layer
  with its own token shard (:func:`shard_tokens` cuts one from a whole
  batch);
- routing is top-1 (switch) or renormalized top-k (GShard) softmax gating
  with a STATIC per-(rank, expert) capacity: over-capacity tokens pass
  through the residual with zero expert output;
- dispatch and return ride ONE ``all_to_all`` each way over the group
  ([E, C, D] grouped by owning rank, ``parallel.axis.all_to_all``).

The reference runs the layer inside ``shard_map`` over a mesh axis; here
the axis is a ``torch.distributed`` group, and ``batch_group`` (a second
group, made with ``dist.new_group``) composes data parallelism. The
replicated weights get the whole gradient on every rank, as ``shard_map``
gives them: the gate's summed over both groups, the experts' over
``batch_group`` (``parallel.axis.pvary``).

The products are f32 einsums and matmuls (TF32 off: ``utils/device
.strict_f32``), as the reference computes them with XLA ops; no Pallas
kernel is on this path. ``jax.nn.gelu`` is the tanh approximation, so the
experts use ``F.gelu(approximate="tanh")``.

Parity oracle: :func:`moe_dense_oracle` applies every token's routed
experts directly (no capacity, one rank); with a capacity at or above the
local token count the sharded layer matches it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from dmlc_tpu_torch.parallel.axis import (all_to_all, axis_index, axis_size,
                                          pmean, pvary)
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check

MOE_KEYS = ("wg", "w1", "w2")


def init_moe_params(num_experts: int, d_model: int, d_hidden: int,
                    seed: int = 0, device=None,
                    generator: torch.Generator = None) -> Dict:
    """{"wg": [D, E], "w1": [E, D, H], "w2": [E, H, D]}, normal draws
    scaled by 1/√D (wg, w1) and 1/√H (w2), on ``device`` (None means
    cuda). ``generator`` (a ``torch.Generator`` on that device) or, if
    None, one seeded with ``seed``: the same seed on the same kind of
    device gives the same weights, in another process too. The bits are
    not ``jax.random``'s: :func:`moe_params_from_numpy` carries the JAX
    package's params across."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev).mul_(scale)

    s1, s2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)
    return {"wg": normal((d_model, num_experts), s1),
            "w1": normal((num_experts, d_model, d_hidden), s1),
            "w2": normal((num_experts, d_hidden, d_model), s2)}


def moe_params_from_numpy(np_params: Dict, device=None) -> Dict:
    """The JAX package's ``{"wg", "w1", "w2"}`` (numpy arrays) as f32
    tensors on ``device`` (None means cuda)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(np_params[k], dtype=np.float32),
                            device=dev) for k in MOE_KEYS}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _route_topk(x, wg, num_experts: int, capacity: int, top_k: int):
    """Top-k routing with static capacity → (dispatch, combine, aux).

    x [T, D] (local tokens). dispatch [T, E, C] one-hot over every kept
    (token, choice); combine the same scaled by the gate probability of
    each choice, RENORMALIZED over the k choices when k > 1 (GShard) and
    the RAW gate probability at k = 1 (switch: dividing would make it 1.0
    and cut the router's gradient through the output). Capacity fills
    choice-major: all first choices claim slots before any second. A
    choice past its expert's capacity gets zero rows. aux is the
    switch/GShard load-balancing loss on FIRST choices:
    E · Σ_e(frac_e · mean_prob_e)."""
    gates = torch.softmax(x @ wg, dim=-1)  # [T, E]
    probs, ids = torch.topk(gates, top_k, dim=-1)  # [T, K]
    if top_k > 1:
        probs = probs / probs.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(ids, num_experts).to(x.dtype)  # [T, K, E]
    t = onehot.shape[0]
    # bucket positions, choice-major: flatten [K, T, E], exclusive cumsum
    oh_km = onehot.transpose(0, 1).reshape(top_k * t, num_experts)
    pos_flat = torch.cumsum(oh_km, dim=0) - oh_km
    pos = (pos_flat.reshape(top_k, t, num_experts).transpose(0, 1)
           * onehot).sum(dim=-1).to(torch.int64)  # [T, K]
    keep = pos < capacity
    # jax.nn.one_hot gives a zero row past the last class; F.one_hot
    # refuses the index, so a dropped choice takes slot 0 and keep zeroes it
    slot = F.one_hot(torch.where(keep, pos, 0), capacity).to(x.dtype)
    kept = (onehot[:, :, :, None] * slot[:, :, None, :]
            * keep[:, :, None, None].to(x.dtype))  # [T, K, E, C]
    dispatch = kept.sum(dim=1)  # [T, E, C]
    combine = (kept * probs[:, :, None, None]).sum(dim=1)
    frac = onehot[:, 0].mean(dim=0)
    mean_prob = gates.mean(dim=0)
    aux = num_experts * (frac * mean_prob).sum()
    return dispatch, combine, aux


def moe_dense_oracle(params: Dict, x: torch.Tensor, top_k: int = 1):
    """Single-rank reference: every token through its top-k experts
    (renormalized gate mixture when k > 1), no capacity limit.
    [B, T, D] → ([B, T, D], aux).

    The reference gathers each token's expert weights (``w1[ids]``,
    [T, D, H]: about 962 GB at Mixtral's widths and 4096 tokens); this
    computes the same function per expert: the tokens routed to expert e
    through e's FFN, scaled by their gate probability."""
    b, t, d = x.shape
    xt = x.reshape(b * t, d)
    num_experts = params["wg"].shape[1]
    gates = torch.softmax(xt @ params["wg"], dim=-1)
    probs, ids = torch.topk(gates, top_k, dim=-1)  # [T, K]
    if top_k > 1:
        probs = probs / probs.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(xt)
    for kk in range(top_k):
        part = torch.zeros_like(xt)
        for e in range(num_experts):
            rows = torch.nonzero(ids[:, kk] == e).squeeze(1)
            if rows.numel() == 0:
                continue
            h = _gelu(xt[rows] @ params["w1"][e])
            part = part.index_add(0, rows, (h @ params["w2"][e])
                                  * probs[rows, kk:kk + 1])
        y = y + part
    onehot = F.one_hot(ids[:, 0], num_experts).to(x.dtype)
    aux = num_experts * (onehot.mean(dim=0) * gates.mean(dim=0)).sum()
    return y.reshape(b, t, d), aux


def make_moe_layer(group, num_experts: int, capacity: int, batch_group=None,
                   top_k: int = 1):
    """f(params, x[B, T_local, D]) -> (y[B, T_local, D], aux_loss) for
    this rank's token shard.

    ``params`` holds this rank's experts (:func:`shard_moe_params`): wg
    [D, E] whole, w1 [E / n, D, H], w2 [E / n, H, D]. ``capacity`` is PER
    (rank, expert): each rank may send at most ``capacity`` of its local
    tokens to any one expert (raise it toward the local token count for a
    no-drop guarantee). ``batch_group`` composes data parallelism: each
    data-parallel row of ranks passes its own expert group, routes its own
    tokens, and keeps the same experts as the other rows; aux is averaged
    over both groups. ``top_k`` selects switch (1) or GShard-style top-2+
    routing with renormalized gate mixtures; capacity admits first
    choices before second. Every rank of the group must call the layer
    (it runs one ``all_to_all`` each way, forward and backward)."""
    ep = axis_size(group)
    check(num_experts % ep == 0,
          "num_experts %d must divide over axis size %d", num_experts, ep)
    check(1 <= top_k <= num_experts,
          "top_k %d must be in [1, %d]", top_k, num_experts)
    e_local = num_experts // ep

    def layer(params, x):
        check(params["w1"].shape[0] == e_local,
              "w1 holds %d experts, this rank owns %d (shard_moe_params)",
              params["w1"].shape[0], e_local)
        dp = () if batch_group is None else (batch_group,)
        wg, w1, w2 = pvary([params["wg"], params["w1"], params["w2"]],
                           [dp + (group,), dp, dp])
        b, t_local, d = x.shape
        xt = x.reshape(b * t_local, d)
        dispatch, combine, aux = _route_topk(xt, wg, num_experts, capacity,
                                             top_k)
        # expert inputs [E, C, D], experts numbered contiguously per
        # owning rank (expert e lives on rank e // e_local)
        xd = torch.einsum("tec,td->ecd", dispatch, xt)
        # ONE all_to_all each way: slice [dst] goes to rank dst; the
        # received stack's leading axis is the SOURCE rank
        xd = all_to_all(xd.reshape(ep, e_local, capacity, d), group, 0, 0)
        # [ep(source), e_local, C, D] -> [e_local, ep*C, D]
        xd = xd.transpose(0, 1).reshape(e_local, ep * capacity, d)
        h = _gelu(torch.einsum("ecd,edh->ech", xd, w1))
        y = torch.einsum("ech,ehd->ecd", h, w2)
        # reverse exchange: the received stack is my tokens' outputs by
        # owning rank, which is global expert order
        y = y.reshape(e_local, ep, capacity, d).transpose(0, 1)
        y = all_to_all(y, group, 0, 0).reshape(num_experts, capacity, d)
        out = torch.einsum("tec,ecd->td", combine, y)
        # the mean of per-shard switch losses, replicated over every
        # token-sharding group
        aux = pmean(aux, group)
        if batch_group is not None:
            aux = pmean(aux, batch_group)
        return out.reshape(b, t_local, d), aux

    return layer


def shard_moe_params(params: Dict, group=None) -> Dict:
    """This rank's view of whole params for :func:`make_moe_layer`: the
    gate whole, w1 and w2 cut to this rank's ``E / n`` experts (contiguous
    slices, so each rank keeps only its own experts' FFNs once the whole
    params are dropped)."""
    n, me = axis_size(group), axis_index(group)
    e = params["w1"].shape[0]
    check(e % n == 0, "num_experts %d must divide over axis size %d", e, n)
    lo, hi = me * e // n, (me + 1) * e // n
    return {"wg": params["wg"], "w1": params["w1"][lo:hi],
            "w2": params["w2"][lo:hi]}


def shard_tokens(x: torch.Tensor, group=None, batch_group=None):
    """This rank's shard of a whole [B, T, D] batch: T split over
    ``group``, B over ``batch_group`` (the reference's x placed with
    ``P(batch_axis, axis)``). The token dim must divide over the group,
    and the batch over ``batch_group``."""
    n, me = axis_size(group), axis_index(group)
    check(x.shape[1] % n == 0,
          "token dim %d must divide over axis size %d", x.shape[1], n)
    t = x.shape[1] // n
    if batch_group is not None:
        dp, row = axis_size(batch_group), axis_index(batch_group)
        check(x.shape[0] % dp == 0,
              "batch %d must divide over axis size %d", x.shape[0], dp)
        b = x.shape[0] // dp
        x = x[row * b:(row + 1) * b]
    return x[:, me * t:(me + 1) * t]

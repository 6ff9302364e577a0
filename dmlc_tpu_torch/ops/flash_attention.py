"""Flash attention with a backward: the two kernels of ``ops/kernels.py``
joined into one ``torch.autograd.Function``.

The counterpart of JAX's TPU ``flash_attention`` (a ``custom_vjp`` over
Pallas forward and backward kernels) as ``make_pallas_flash_local`` in
``dmlc_tpu/ops/sequence_parallel.py`` calls it, in the JAX package's
[B, T, H, D] layout, with grouped K/V heads read in place and the softmax
scale 1/√D.
"""

from __future__ import annotations

import torch

from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops.attention import full_attention


def softmax_delta(out, dout):
    """delta = rowsum(dout·out) as [B, H, T]: the backward kernel's third
    row input (a small torch reduction, the one place torch does
    arithmetic on the flash path)."""
    return (dout * out).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool):
    """(dq, dk, dv) of :func:`kernels.flash_attention_fwd`'s ``(out, lse)``
    for the output gradient ``dout``: delta, then the one backward
    kernel."""
    return kernels.flash_attention_bwd(q, k, v, dout, lse,
                                       softmax_delta(out, dout), causal)


class FlashAttention(torch.autograd.Function):
    """Forward: :func:`kernels.flash_attention_fwd`, saving the output and
    the row logsumexp. Backward: :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = kernels.flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """softmax(Q Kᵀ/√D [+ causal mask]) V for q [B, T, H, D] and k, v
    [B, T, Hkv, D] (H % Hkv == 0), f32, D in 32/64/128. Differentiable in
    q, k and v.

    On CUDA tensors the forward and backward run the hand-written kernels
    and no T x T tensor exists; on CPU tensors this is the kernels' plain
    version, :func:`ops.attention.full_attention`, differentiated by
    autograd."""
    if q.device.type == "cpu":
        kernels.check_flash_inputs(q, k, v)
        return full_attention(q, k, v, causal)
    return FlashAttention.apply(q, k, v, causal)

"""Why the flash kernels split every f32 product into three TF32 products,
and may not drop to one.

The forward kernel (``dmlc_tpu_torch/ops/csrc/flash_attention_fwd.cu``)
computes its two products (S = Q K^T, then P V a tile of
``FLASH_FWD_KV_ROWS`` keys at a time under the online softmax, each
tile's part added to O in f32) and the backward kernel
(``flash_attention_bwd.cu``) its five (S, dP, dV, dK, dQ) on the tensor
cores, whose TF32 operands keep 10 bits of mantissa. The backward kernel
sums dQ across its CTAs: each K/V tile of ``FLASH_BWD_KV_ROWS`` keys forms
its part dS[:, tile] K[tile], and the parts are added in f32 from tile 0
up to the highest (``fused_model_backward``). Each f32 operand x is
split as big = tf32(x), small = tf32(x - big), and a product is
small·big + big·small + big·big. This file models those products on the
CPU (TF32 rounding to nearest, ties away from zero, by masking the low 13
bits of an f32) at the small shapes of ``chip_smoke.FLASH_CASES`` and holds
the models against the JAX package's ``full_attention`` (the backward's
differentiated by ``jax.vjp``) within the tolerances the card's kernels are
held to: the forward's ``out`` and ``lse`` within ``chip_smoke.OUT_TOL``,
the gradients within ``chip_smoke.GRAD_TOL``. The 3-pass models pass them;
one-pass models fail them, the forward's at every case, the backward's
from ``chip_smoke.TF32_FAULT_MIN_T`` on.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FLASH_CASES, GRAD_TOL, OUT_TOL, TF32_FAULT_MIN_T
from dmlc_tpu.ops import sequence_parallel as jsp
from dmlc_tpu_torch.ops.kernels import FLASH_BWD_KV_ROWS, FLASH_FWD_KV_ROWS

SMALL_CASES = [c for c in FLASH_CASES if c[1] <= 1024]
FAULT_CASES = [c for c in SMALL_CASES if c[1] >= TF32_FAULT_MIN_T]


def tf32(x):
    """f32 -> the nearest TF32 value (ties away from zero), as
    ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_matmul(a, b):
    """a @ b as the kernels form it: three TF32 products, small terms
    first, each summed in f32."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def one_pass_matmul(a, b):
    return tf32(a) @ tf32(b)


def _model_scores(matmul, q, k, v, dout, causal):
    """The backward's shared steps: (qh, doh, kh, vh, p, ds, unflatten)
    with S and dP formed once by ``matmul``, lse and delta from the plain
    f32 forward, as the forward kernel hands them over. q, dout
    [B, T, H, D]; k, v [B, T, Hk, D]; the head-major tensors are
    [B, Hk, G, T, D] (k and v with G = 1)."""
    b, t, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(float(d))

    def heads(x, n):  # [B, T, n*, D] -> [B, Hk, n, T, D]
        return x.reshape(b, t, hk, n, d).permute(0, 2, 3, 1, 4)

    qh, doh = heads(q, g), heads(dout, g)
    kh, vh = heads(k, 1), heads(v, 1)
    keep = torch.ones(t, t, dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)
    s_plain = (qh @ kh.transpose(-1, -2)) * scale
    s_plain = s_plain.masked_fill(~keep, -1e30)
    lse = torch.logsumexp(s_plain, -1, keepdim=True)
    out = torch.softmax(s_plain, -1) @ vh
    delta = (doh * out).sum(-1, keepdim=True)

    s = matmul(qh, kh.transpose(-1, -2).expand(-1, -1, g, -1, -1))
    p = torch.where(keep, torch.exp(s * scale - lse), torch.zeros(()))
    dp = matmul(doh, vh.transpose(-1, -2).expand(-1, -1, g, -1, -1))
    ds = p * (dp - delta)

    def back(x, n):  # [B, Hk, n, T, D] -> [B, T, Hk*n, D]
        return x.permute(0, 3, 1, 2, 4).reshape(b, t, hk * n, d)

    return qh, doh, kh, vh, p, ds, back


def model_backward(matmul, q, k, v, dout, causal):
    """(dq, dk, dv) of attention by the kernels' recipe with every product
    formed by ``matmul``; lse and delta from the plain f32 forward, as the
    forward kernel hands them over. q, dout [B, T, H, D]; k, v
    [B, T, Hk, D]."""
    qh, doh, kh, vh, p, ds, back = _model_scores(matmul, q, k, v, dout,
                                                 causal)
    scale = 1.0 / math.sqrt(float(q.shape[3]))
    g = qh.shape[2]
    dq = matmul(ds, kh.expand(-1, -1, g, -1, -1)) * scale
    dk = (matmul(ds.transpose(-1, -2), qh) * scale).sum(2, keepdim=True)
    dv = matmul(p.transpose(-1, -2), doh).sum(2, keepdim=True)
    return back(dq, g), back(dk, 1), back(dv, 1)


def fused_model_backward(matmul, q, k, v, dout, causal,
                         kv_rows=FLASH_BWD_KV_ROWS):
    """(dq, dk, dv) by the fused backward kernel's recipe: S and dP once
    (as :func:`model_backward`), dV and dK as there, and dQ from one part
    a K/V tile of ``kv_rows`` keys, dS[:, tile] K[tile] formed by
    ``matmul``, summed in f32 in the kernel's fixed order (tile 0's part
    first, the highest tile's last, each added to the running sum), then
    scaled."""
    qh, doh, kh, vh, p, ds, back = _model_scores(matmul, q, k, v, dout,
                                                 causal)
    t = q.shape[1]
    scale = 1.0 / math.sqrt(float(q.shape[3]))
    g = qh.shape[2]
    dq = None
    for n0 in range(0, t, kv_rows):
        part = matmul(ds[..., n0:n0 + kv_rows],
                      kh[..., n0:n0 + kv_rows, :].expand(-1, -1, g, -1, -1))
        dq = part if dq is None else dq + part
    dk = (matmul(ds.transpose(-1, -2), qh) * scale).sum(2, keepdim=True)
    dv = matmul(p.transpose(-1, -2), doh).sum(2, keepdim=True)
    return back(dq * scale, g), back(dk, 1), back(dv, 1)


def model_forward(matmul, q, k, v, causal, tile=FLASH_FWD_KV_ROWS):
    """(out [B, T, H, D], lse [B, H, T]) by the forward kernel's recipe:
    S = Q K^T by ``matmul``, scaled and masked; an online softmax over
    ``tile`` keys at a time (the kernel's streamed K/V tile: running max
    and sum, O rescaled); each tile's P V by ``matmul`` (a fresh
    tensor-core sum in the kernel), added to the rescaled O in f32.
    q [B, T, H, D]; k, v [B, T, Hk, D]."""
    b, t, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(float(d))
    qh = q.reshape(b, t, hk, g, d).permute(0, 2, 3, 1, 4)  # [B,Hk,G,T,D]
    kh = k.permute(0, 2, 1, 3)[:, :, None]                 # [B,Hk,1,T,D]
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    s_all = matmul(qh, kh.transpose(-1, -2).expand(-1, -1, g, -1, -1))
    rows = torch.arange(t)[:, None]
    m = torch.full((b, hk, g, t, 1), -math.inf)
    l = torch.zeros((b, hk, g, t, 1))
    o = torch.zeros((b, hk, g, t, d))
    for n0 in range(0, t, tile):
        keys = torch.arange(n0, min(t, n0 + tile))[None, :]
        s = s_all[..., n0:n0 + tile] * scale
        if causal:
            s = s.masked_fill(keys > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + matmul(p, vh[..., n0:n0 + tile, :].expand(
            -1, -1, g, -1, -1))
        m = m_new
    out = (o / l).permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
    return out, (m + torch.log(l)).reshape(b, h, t)


def tol_ratio(got, want, tol):
    """max |got - want| / (atol + rtol·|want|), as chip_smoke reads it."""
    return float(np.max(np.abs(got - want)
                        / (tol["atol"] + tol["rtol"] * np.abs(want))))


def _inputs(b, t, h, hk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for shape in (
        (b, t, h, d), (b, t, hk, d), (b, t, hk, d), (b, t, h, d))]


def _jax_grads(q, k, v, dout, causal):
    _, vjp = jax.vjp(lambda q, k, v: jsp.full_attention(q, k, v, causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _ratios(matmul, case, model=model_backward):
    b, t, h, hk, d, causal = case
    q, k, v, dout = _inputs(b, t, h, hk, d, seed=t + hk + d)
    want = _jax_grads(q, k, v, dout, causal)
    got = model(matmul, *(torch.from_numpy(x) for x in (q, k, v, dout)),
                causal)
    return [tol_ratio(g.numpy(), w, GRAD_TOL) for g, w in zip(got, want)]


def _fwd_ratios(matmul, case):
    """(out, lse) tolerance ratios of the forward model against the JAX
    package's full_attention (out) and a float64 logsumexp of the scores
    (lse)."""
    b, t, h, hk, d, causal = case
    q, k, v, _ = _inputs(b, t, h, hk, d, seed=t + hk + d)
    want_out = np.asarray(jsp.full_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal))
    g = h // hk
    s = np.einsum("bqhgd,bkhd->bhgqk", q.reshape(b, t, hk, g, d).astype(
        np.float64), k.astype(np.float64)) / math.sqrt(float(d))
    if causal:
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    top = s.max(-1, keepdims=True)
    want_lse = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))
    want_lse = want_lse.reshape(b, h, t)
    out, lse = model_forward(matmul, *(torch.from_numpy(x)
                                       for x in (q, k, v)), causal)
    return (tol_ratio(out.numpy(), want_out, OUT_TOL),
            tol_ratio(lse.numpy(), want_lse, OUT_TOL))


@pytest.mark.parametrize("case", SMALL_CASES, ids=str)
def test_forward_three_pass_split_holds_output_tolerance(case):
    """The 3-pass model of the forward kernel's products keeps out and lse
    inside OUT_TOL, with a margin of 4."""
    ratios = _fwd_ratios(split_matmul, case)
    assert max(ratios) < 0.25, ratios


@pytest.mark.parametrize("case", SMALL_CASES, ids=str)
def test_forward_one_tf32_pass_fails_output_tolerance(case):
    """One TF32 pass per product in the forward, the rest unchanged, puts
    out (or lse) outside OUT_TOL at every case: why the split stays."""
    ratios = _fwd_ratios(one_pass_matmul, case)
    assert max(ratios) > 1.0, ratios


@pytest.mark.parametrize("case", SMALL_CASES, ids=str)
def test_three_pass_split_holds_gradient_tolerance(case):
    """The 3-pass model of the kernels' products stays inside GRAD_TOL
    for dq, dk and dv, with a margin of 4."""
    ratios = _ratios(split_matmul, case)
    assert max(ratios) < 0.25, ratios


@pytest.mark.parametrize("case", FAULT_CASES, ids=str)
def test_one_tf32_pass_fails_gradient_tolerance(case):
    """One TF32 pass per product, the rest unchanged, falls outside
    GRAD_TOL on each of dq, dk and dv: why the split stays."""
    ratios = _ratios(one_pass_matmul, case)
    assert min(ratios) > 1.0, ratios


@pytest.mark.parametrize("case", SMALL_CASES, ids=str)
def test_fused_recipe_three_pass_holds_gradient_tolerance(case):
    """The fused kernel's recipe (S and dP once, dQ summed from per-K/V-tile
    parts in ascending tile order) with 3-pass products stays inside
    GRAD_TOL against the JAX package's full_attention + jax.vjp, with a
    margin of 4."""
    ratios = _ratios(split_matmul, case, fused_model_backward)
    assert max(ratios) < 0.25, ratios


@pytest.mark.parametrize("case", FAULT_CASES, ids=str)
def test_fused_recipe_one_tf32_pass_fails_gradient_tolerance(case):
    """The same recipe with one TF32 pass per product falls outside
    GRAD_TOL on each of dq, dk and dv."""
    ratios = _ratios(one_pass_matmul, case, fused_model_backward)
    assert min(ratios) > 1.0, ratios


def test_fused_dq_parts_cover_every_key_once():
    """fused_model_backward's per-tile parts are slices of the whole
    product: with exact (f64) products its dQ is model_backward's to f32
    rounding, at a T that leaves a ragged last tile, and dK, dV are
    model_backward's bit for bit."""
    rng = np.random.RandomState(9)
    b, t, h, hk, d = 1, 3 * FLASH_BWD_KV_ROWS + 5, 2, 1, 32
    q, k, v, dout = (torch.from_numpy(rng.randint(-2, 3, s).astype(
        np.float32)) for s in ((b, t, h, d), (b, t, hk, d), (b, t, hk, d),
                               (b, t, h, d)))

    def exact(a, c):
        return (a.double() @ c.double()).float()

    whole = model_backward(exact, q, k, v, dout, True)
    fused = fused_model_backward(exact, q, k, v, dout, True)
    assert torch.allclose(fused[0], whole[0], rtol=1e-6, atol=1e-6)
    assert torch.equal(fused[1], whole[1]) and torch.equal(fused[2], whole[2])


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-39])
    got = tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0, 3.0e-39])
    # ties go away from zero; a subnormal keeps its top 10 bits
    assert torch.equal(got[:5], want[:5])
    assert abs(float(got[5]) - 3.0e-39) < 2.0 ** -136
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    b = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    exact = (a.double() @ b.double())
    split_err = float((split_matmul(a, b).double() - exact).abs().max())
    one_err = float((one_pass_matmul(a, b).double() - exact).abs().max())
    plain_err = float(((a @ b).double() - exact).abs().max())
    assert split_err < 4 * plain_err < one_err


def test_model_forward_agrees_with_jax():
    """The model's plain f32 forward (its lse and delta) is the JAX
    package's attention within OUT_TOL, so the gradient readings above
    test the products alone."""
    b, t, h, hk, d, causal = SMALL_CASES[0]
    q, k, v, _ = _inputs(b, t, h, hk, d, seed=3)
    want = np.asarray(jsp.full_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                         causal))
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    g = h // hk
    s = torch.einsum("bqhgd,bkhd->bhgqk", qt.reshape(b, t, hk, g, d), kt)
    s = s / math.sqrt(float(d))
    if causal:
        s = s.masked_fill(~torch.tril(torch.ones(t, t, dtype=torch.bool)),
                          -1e30)
    got = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), vt)
    assert tol_ratio(got.reshape(b, t, h, d).numpy(), want, OUT_TOL) < 1.0

"""The hand-written CUDA kernels of the port, each beside its plain PyTorch
version — the port of ``dmlc_tpu/ops/pallas_kernels.py`` and of the TPU
flash-attention kernel behind ``dmlc_tpu/ops/sequence_parallel.py``.

- :func:`fused_linear_grads` — the whole dense local step
  (csrc/fused_linear_grads.cu);
- :func:`coo_segment_sum` — the row-direction reduce of the csr margin
  (csrc/coo_segment_sum.cu);
- :func:`flash_attention_fwd` — attention output and row logsumexp
  (csrc/flash_attention_fwd.cu);
- :func:`flash_attention_bwd_dq` and :func:`flash_attention_bwd_dkv` — its
  gradients (csrc/flash_attention_bwd.cu). ``ops/flash_attention.py`` joins
  the three into an autograd Function;
- :func:`tokenize_boundaries` — the libsvm token start/end masks of a
  chunk of bytes (csrc/tokenize_boundaries.cu), for the parsers.

The tensor's device picks the route: on a CUDA tensor the wrapper launches
the kernel (built at first use by ops/_build.py) or raises; the plain
version runs only for tensors on the CPU. Each wrapper counts its launches
in a plain int attribute, ``<wrapper>.launches``, so that a run can show
that its main path went through the kernel; :func:`count_launch` adds one
under a lock, since the parsers launch from several threads at once.
Kernels launch on the current CUDA stream and allocate nothing: the wrapper
allocates outputs and scratch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from dmlc_tpu_torch.ops import _build
from dmlc_tpu_torch.ops.attention import (
    full_attention,
    grouped_pv,
    masked_scores,
)
from dmlc_tpu_torch.ops.objectives import margin_loss_grad
from dmlc_tpu_torch.utils.logging import DMLCError, check

OBJECTIVE_CODES = {"logistic": 0, "squared": 1, "hinge": 2}
#: rows per CTA tile; must equal kTileRows in csrc/fused_linear_grads.cu
FUSED_TILE_ROWS = 128

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_declared = False
#: guards every wrapper's ``launches`` count (a += from two threads can
#: lose one) and the arrival counters of ``fused_linear_grads``
_LAUNCH_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    global _declared
    lib = _build.load_library()
    if not _declared:
        lib.dmlc_fused_linear_grads.argtypes = [
            _P, _P, _P, _P, _P, _I64, _I64, ctypes.c_int, ctypes.c_int,
            _P, _P, _P, _P, _P]
        lib.dmlc_fused_linear_grads.restype = ctypes.c_int
        lib.dmlc_coo_segment_sum.argtypes = [_P, _P, _I64, _I64, _P, _P,
                                             _P]
        lib.dmlc_coo_segment_sum.restype = ctypes.c_int
        dims = [ctypes.c_int] * 6 + [_P]  # B T H Hkv D causal, stream
        lib.dmlc_flash_attention_fwd.argtypes = [_P] * 5 + dims
        lib.dmlc_flash_attention_fwd.restype = ctypes.c_int
        lib.dmlc_flash_attention_bwd_dq.argtypes = [_P] * 7 + dims
        lib.dmlc_flash_attention_bwd_dq.restype = ctypes.c_int
        lib.dmlc_flash_attention_bwd_dkv.argtypes = [_P] * 8 + dims
        lib.dmlc_flash_attention_bwd_dkv.restype = ctypes.c_int
        lib.dmlc_tokenize_boundaries.argtypes = [_P, _I64, _P, _P, _P]
        lib.dmlc_tokenize_boundaries.restype = ctypes.c_int
        lib.dmlc_empty_launches.argtypes = [ctypes.c_int, _P]
        lib.dmlc_empty_launches.restype = ctypes.c_int
        _declared = True
    return lib


def _check_input(t, name: str, dtype, shape, device) -> None:
    check(isinstance(t, torch.Tensor), "%s must be a tensor", name)
    check(t.device == device, "%s is on %s, expected %s", name, t.device,
          device)
    check(t.dtype == dtype, "%s must be %s, got %s", name, dtype, t.dtype)
    check(tuple(t.shape) == tuple(shape), "%s must have shape %s, got %s",
          name, tuple(shape), tuple(t.shape))
    check(t.is_contiguous(), "%s must be contiguous", name)


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise DMLCError(f"{name}: CUDA kernel launch failed with error {rc}")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, safe under threads."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


# ---------------------------------------------------------------------------
# fused_linear_grads
# ---------------------------------------------------------------------------


def fused_linear_grads_plain(x, label, weight, w, b, objective="logistic"):
    """The dense local step in plain PyTorch ops (the kernel's reference):
    returns (gw [F], gb, loss_sum, weight_sum)."""
    margin = x @ w + b
    loss, grad = margin_loss_grad(objective, margin, label)
    wg = weight * grad
    return x.T @ wg, torch.sum(wg), torch.sum(weight * loss), torch.sum(weight)


#: (device index, stream handle) -> the int32 arrival counter of
#: csrc/fused_linear_grads.cu on that stream, zeroed once; each call leaves
#: it at 0, and calls on one stream run one after another
_ARRIVAL_COUNTERS = {}


def _arrival_counter(dev, stream):
    key = (dev.index, stream.cuda_stream)
    with _LAUNCH_LOCK:
        counter = _ARRIVAL_COUNTERS.get(key)
        if counter is None:
            # zeroed on the current stream, ahead of the launch that reads it
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            _ARRIVAL_COUNTERS[key] = counter
    return counter


def fused_linear_grads(x, label, weight, w, b, objective="logistic"):
    """(gw [F], gb, loss_sum, weight_sum) for a dense batch in one kernel.

    x [B, F], label and weight [B], w [F] and b (0-d), all f32 on one
    device; the same contract as the dense ``_local_grads`` of
    models/linear.py. Padded rows carry weight 0. On a CUDA tensor this
    launches csrc/fused_linear_grads.cu once (per-tile partial rows; the
    CTA that arrives last sums them in tile order, counted by an int32 on
    the stream that is zeroed once); on a CPU tensor it runs
    :func:`fused_linear_grads_plain`.
    """
    check(objective in OBJECTIVE_CODES, "unknown objective %r", objective)
    if x.device.type == "cpu":
        return fused_linear_grads_plain(x, label, weight, w, b, objective)
    check(x.device.type == "cuda", "unsupported device %s", x.device)
    check(x.dim() == 2, "x must be [B, F], got shape %s", tuple(x.shape))
    rows, features = x.shape
    check(rows > 0 and features > 0, "x must be non-empty")
    dev = x.device
    _check_input(x, "x", torch.float32, (rows, features), dev)
    _check_input(label, "label", torch.float32, (rows,), dev)
    _check_input(weight, "weight", torch.float32, (rows,), dev)
    _check_input(w, "w", torch.float32, (features,), dev)
    _check_input(b, "b", torch.float32, (), dev)
    num_tiles = -(-rows // FUSED_TILE_ROWS)
    partials = torch.empty((num_tiles, features + 3), dtype=torch.float32,
                           device=dev)
    gw = torch.empty(features, dtype=torch.float32, device=dev)
    scalars = torch.empty(3, dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev)
    counter = _arrival_counter(dev, stream)
    with torch.cuda.device(dev):
        rc = lib.dmlc_fused_linear_grads(
            x.data_ptr(), label.data_ptr(), weight.data_ptr(), w.data_ptr(),
            b.data_ptr(), rows, features, OBJECTIVE_CODES[objective],
            FUSED_TILE_ROWS, partials.data_ptr(), counter.data_ptr(),
            gw.data_ptr(), scalars.data_ptr(), stream.cuda_stream)
    _launch_check(rc, "fused_linear_grads")
    count_launch(fused_linear_grads)
    return gw, scalars[0], scalars[1], scalars[2]


fused_linear_grads.launches = 0


# ---------------------------------------------------------------------------
# coo_segment_sum
# ---------------------------------------------------------------------------


def coo_segment_sum_plain(contrib, row_ids, num_rows: int):
    """``y[r] = Σ_{e: row_ids[e]==r} contrib[e]`` in plain PyTorch ops, for
    row ids in any order; ids outside [0, num_rows) contribute nothing."""
    ids = row_ids.long()
    keep = (ids >= 0) & (ids < num_rows)
    out = torch.zeros(num_rows, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(
        0, torch.where(keep, ids, 0),
        torch.where(keep, contrib, torch.zeros_like(contrib)))


def coo_segment_sum(contrib, row_ids, num_rows: int):
    """``y[r] = Σ_{e: row_ids[e]==r} contrib[e]`` for r in [0, num_rows).

    contrib [E] f32 and row_ids [E] i32 on one device; returns
    [num_rows] f32. Row ids outside [0, num_rows) contribute nothing (the
    reference's -1 pad). On a CUDA tensor this launches
    csrc/coo_segment_sum.cu (two kernels: each row's first entry, then the
    row sums), which requires ``row_ids`` to never decrease
    — what ops/spmv.expand_row_ids produces — and is not checked here,
    since checking would cost a device sync per call. On a CPU tensor it
    runs :func:`coo_segment_sum_plain`, which takes any order.
    """
    if contrib.device.type == "cpu":
        return coo_segment_sum_plain(contrib, row_ids, num_rows)
    check(contrib.device.type == "cuda", "unsupported device %s",
          contrib.device)
    check(contrib.dim() == 1, "contrib must be [E], got shape %s",
          tuple(contrib.shape))
    check(0 < num_rows < 2**31 - 1, "num_rows out of range: %d", num_rows)
    entries = contrib.shape[0]
    dev = contrib.device
    _check_input(contrib, "contrib", torch.float32, (entries,), dev)
    _check_input(row_ids, "row_ids", torch.int32, (entries,), dev)
    out = torch.empty(num_rows, dtype=torch.float32, device=dev)
    starts = torch.empty(num_rows + 1, dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.dmlc_coo_segment_sum(
            contrib.data_ptr(), row_ids.data_ptr(), entries, num_rows,
            starts.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _launch_check(rc, "coo_segment_sum")
    count_launch(coo_segment_sum)
    return out


coo_segment_sum.launches = 0


# ---------------------------------------------------------------------------
# flash attention: forward, dQ, dK/dV
# ---------------------------------------------------------------------------

#: head dims the CUDA kernels are compiled for (csrc/flash_attention.cuh)
FLASH_HEAD_DIMS = (32, 64, 128)


def check_flash_inputs(q, k, v):
    """(B, T, H, Hkv, D) after checking q [B, T, H, D] and k, v
    [B, T, Hkv, D]: f32, contiguous, one device, H % Hkv == 0, D one of
    FLASH_HEAD_DIMS. The same checks hold on both routes."""
    check(isinstance(q, torch.Tensor) and q.dim() == 4,
          "q must be a [B, T, H, D] tensor")
    b, t, h, d = q.shape
    check(k.dim() == 4 and k.shape[:2] == q.shape[:2]
          and k.shape[3] == d, "k must be [B, T, Hkv, D] for q %s, got %s",
          tuple(q.shape), tuple(k.shape))
    hk = k.shape[2]
    check(d in FLASH_HEAD_DIMS, "head dim %d is not one of %s", d,
          FLASH_HEAD_DIMS)
    check(b > 0 and t > 0 and hk > 0 and h % hk == 0,
          "num_heads %d must divide by num_kv_heads %d (T=%d, B=%d)", h, hk,
          t, b)
    _check_input(q, "q", torch.float32, (b, t, h, d), q.device)
    _check_input(k, "k", torch.float32, (b, t, hk, d), q.device)
    _check_input(v, "v", torch.float32, (b, t, hk, d), q.device)
    if q.device.type == "cuda":
        check(b * h <= 65535 and t < 2**31 - 64,
              "flash attention: B*H=%d or T=%d out of range", b * h, t)
        for name, x in (("q", q), ("k", k), ("v", v)):
            check(x.data_ptr() % 16 == 0, "%s must be 16-byte aligned", name)
    else:
        check(q.device.type == "cpu", "unsupported device %s", q.device)
    return b, t, h, hk, d


def flash_attention_fwd_plain(q, k, v, causal: bool = False):
    """(out, lse) of :func:`flash_attention_fwd` from the materialised
    scores of :func:`ops.attention.full_attention`."""
    s = masked_scores(q, k, causal)
    return grouped_pv(torch.softmax(s, dim=-1), v), torch.logsumexp(s, -1)


def flash_attention_bwd_plain(q, k, v, dout, causal: bool = False):
    """(dq, dk, dv): :func:`ops.attention.full_attention` differentiated
    by autograd for the output gradient ``dout``."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        return torch.autograd.grad(full_attention(*leaves, causal), leaves,
                                   dout)


def flash_attention_fwd(q, k, v, causal: bool = False):
    """(out [B, T, H, D], lse [B, H, T]): attention and the natural-log
    logsumexp of each query row's masked scores (scaled by 1/√D).

    On a CUDA tensor this launches csrc/flash_attention_fwd.cu; on a CPU
    tensor it runs :func:`flash_attention_fwd_plain`."""
    b, t, h, hk, d = check_flash_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().dmlc_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, h, hk, d, int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _launch_check(rc, "flash_attention_fwd")
    count_launch(flash_attention_fwd)
    return out, lse


flash_attention_fwd.launches = 0


def _flash_bwd_inputs(q, k, v, dout, lse, delta):
    b, t, h, hk, d = check_flash_inputs(q, k, v)
    _check_input(dout, "dout", torch.float32, (b, t, h, d), q.device)
    _check_input(lse, "lse", torch.float32, (b, h, t), q.device)
    _check_input(delta, "delta", torch.float32, (b, h, t), q.device)
    if q.device.type == "cuda":
        check(dout.data_ptr() % 16 == 0, "dout must be 16-byte aligned")
    return b, t, h, hk, d


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal: bool = False):
    """dQ [B, T, H, D] of :func:`flash_attention_fwd` for the output
    gradient ``dout``, from its ``lse`` and ``delta`` = rowsum(dout·out)
    as [B, H, T].

    On a CUDA tensor this launches the dQ kernel of
    csrc/flash_attention_bwd.cu; on a CPU tensor it runs
    :func:`flash_attention_bwd_plain` (``lse`` and ``delta`` are checked,
    and the plain route recomputes them)."""
    b, t, h, hk, d = _flash_bwd_inputs(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, causal)[0]
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().dmlc_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t, h, hk, d,
            int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _launch_check(rc, "flash_attention_bwd_dq")
    count_launch(flash_attention_bwd_dq)
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = False):
    """(dK, dV), each [B, T, Hkv, D], of :func:`flash_attention_fwd`; the
    inputs as for :func:`flash_attention_bwd_dq`. Under GQA each KV head's
    gradient sums over the H / Hkv query heads that read it.

    On a CUDA tensor this launches the dK/dV kernel of
    csrc/flash_attention_bwd.cu; on a CPU tensor it runs
    :func:`flash_attention_bwd_plain`."""
    b, t, h, hk, d = _flash_bwd_inputs(q, k, v, dout, lse, delta)
    if q.device.type == "cpu":
        return tuple(flash_attention_bwd_plain(q, k, v, dout, causal)[1:])
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _lib().dmlc_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, t, h, hk, d, int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _launch_check(rc, "flash_attention_bwd_dkv")
    count_launch(flash_attention_bwd_dkv)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# tokenize_boundaries
# ---------------------------------------------------------------------------

#: the libsvm separators: space, tab, ':', '\n', '\r'
TOKEN_SEPARATORS = (0x20, 0x09, 0x3A, 0x0A, 0x0D)


def tokenize_boundaries_plain(a):
    """(starts, ends) bool [n] in plain PyTorch ops: a byte starts (ends)
    a token when it is no separator and the byte before (after) it is one;
    the byte before the chunk and the byte after it count as separators
    (``vparse.token_boundary_masks``)."""
    sep = torch.zeros_like(a, dtype=torch.bool)
    for code in TOKEN_SEPARATORS:
        sep |= a == code
    edge = torch.ones(1, dtype=torch.bool, device=a.device)
    starts = ~sep & torch.cat([edge, sep[:-1]])
    ends = ~sep & torch.cat([sep[1:], edge])
    return starts, ends


def tokenize_boundaries(a):
    """(starts, ends) bool [n]: the token start and end masks of the uint8
    chunk ``a`` [n], as :func:`tokenize_boundaries_plain` defines them.

    On a CUDA tensor this launches csrc/tokenize_boundaries.cu once, at any
    n >= 1 and any base address (the outputs may be views into slightly
    larger buffers: the wrapper aligns them as the input is aligned, so
    the kernel stores 16 bytes at a time); on a CPU tensor it runs
    :func:`tokenize_boundaries_plain`. n == 0 gives two empty masks and
    launches nothing."""
    check(isinstance(a, torch.Tensor) and a.dim() == 1,
          "a must be a 1-d tensor")
    n = a.shape[0]
    _check_input(a, "a", torch.uint8, (n,), a.device)
    if a.device.type == "cpu":
        return tokenize_boundaries_plain(a)
    check(a.device.type == "cuda", "unsupported device %s", a.device)
    if n == 0:
        return (torch.empty(0, dtype=torch.bool, device=a.device),
                torch.empty(0, dtype=torch.bool, device=a.device))
    shift = a.data_ptr() % 16
    outs = []
    for _ in range(2):
        buf = torch.empty(n + 16, dtype=torch.bool, device=a.device)
        lead = (shift - buf.data_ptr()) % 16
        outs.append(buf[lead:lead + n])
    starts, ends = outs
    with torch.cuda.device(a.device):
        rc = _lib().dmlc_tokenize_boundaries(
            a.data_ptr(), n, starts.data_ptr(), ends.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    _launch_check(rc, "tokenize_boundaries")
    count_launch(tokenize_boundaries)
    return starts, ends


tokenize_boundaries.launches = 0

# ---------------------------------------------------------------------------
# the launch floor
# ---------------------------------------------------------------------------


def empty_launches(n: int, device) -> None:
    """Launch the empty kernel of csrc/launch_floor.cu ``n`` times on the
    current stream of the CUDA ``device``: a measuring aid for the fixed
    cost of a launch, not a port, so it counts nothing and is not in
    :data:`KERNELS`."""
    device = torch.device(device)
    check(device.type == "cuda", "empty_launches runs on a CUDA device, "
          "not %s", device)
    with torch.cuda.device(device):
        rc = _lib().dmlc_empty_launches(
            n, torch.cuda.current_stream(device).cuda_stream)
    _launch_check(rc, "empty_launches")


#: every kernel wrapper of the package, by name
KERNELS = {
    "fused_linear_grads": fused_linear_grads,
    "coo_segment_sum": coo_segment_sum,
    "flash_attention_fwd": flash_attention_fwd,
    "flash_attention_bwd_dq": flash_attention_bwd_dq,
    "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
    "tokenize_boundaries": tokenize_boundaries,
}


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for fn in KERNELS.values():
            fn.launches = 0

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``dmlc_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one. With ``--times``
it only builds the kernels and prints one ``{"times": ...}`` line: each
kernel's cold-L2 CUDA-event time at the main path's shapes beside its
yardstick, to compare two checkouts in turns on one card. Phases, each
ending in ``torch.cuda.synchronize()``; any failure ends the run with a
non-zero exit and no result line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``dmlc_tpu_torch/ops/csrc`` (nvcc, sm_90a)
   and print ptxas's registers and spills of each kernel; every flash
   kernel must show 0 spill bytes;
3. ``fused_linear_grads`` against its plain PyTorch version on the card at
   [16384, 29] (HIGGS), a ragged [1000, 29] and a wide [4096, 2048]:
   integer-valued data with the squared and hinge objectives must match bit
   for bit (every sum is exact), float data with the logistic objective
   within rtol 1e-5 / atol 1e-6 (another summation order, and ``expf``
   against torch's sigmoid); two runs must give the same bits;
4. ``coo_segment_sum`` against its plain version at a Criteo batch (8192
   rows, 327,680 bucketed entries, row ids from ``expand_row_ids`` over
   real offsets with a padded tail) and at the edge cases of
   ``seg_sum_edge_cases`` (no entries, fewer than a warp, one row holding
   every entry, empty rows at the start, middle and end, a -1 pad before
   row 0, ids past the last row, a row longer than 32 x 32 entries):
   bit-equal on integer data, the same bits twice; ``spmv_transpose``
   gives the same bits twice, and the same bits again under
   ``torch.use_deterministic_algorithms(True)``;
5. the dense path: ``LinearLearner(objective="logistic").fit_uri`` over a
   seeded HIGGS-shaped LibSVM file (262,144 rows x 28 features), batch
   16384, 2 epochs, on the card and on the CPU; the launch count of
   ``fused_linear_grads`` must equal the step count; the loss must fall;
   the card's loss history must match the CPU's within rtol 1e-5 and its
   params within a relative norm of 1e-5; the same fit on the CPU at half
   the learning rate (a step whose gradient is halved) is read against
   that limit too, and must fail it; the same batches are then fed to the
   card with no step, to time the host's share;
6. the csr path: the same over a seeded Criteo-shaped file (65,536 rows x
   39 skewed ids in [1, 2^20], labels from a planted sparse rule), batch
   8192, 2^20 + 1 features; the launch count of ``coo_segment_sum`` must
   equal the step count;
7. per kernel: CUDA-event times (cold L2) of the kernel, its plain
   version and the one PyTorch call that computes the same function where
   there is one, beside the least time the card could take;
8. the flash-attention kernels (forward, dQ, dK/dV) against their plain
   version with autograd at the (B, T, H, Hkv, D, causal) of
   ``FLASH_CASES`` (T 4096 at D 128 MHA and GQA, a ragged T = 1000, D 32,
   MQA at T = 33): outputs and the row logsumexp within rtol 2e-4 /
   atol 2e-5, gradients within rtol 2e-3 / atol 2e-4, the same bits
   twice. Known faults are read against the same limits and must fail
   them: the causal diagonal hidden (output), dS without its diagonal
   (dQ, dK), under GQA dK/dV summed over the first query head of each
   group only, and from T = 512 on the plain forward's out and lse, and
   dq, dk and dv of ``full_attention``'s backward, with one TF32 pass
   (``allow_tf32``: what the kernels would give without their 3-pass
   split; at T = 33 only recorded);
9. the long-context path: a one-rank NCCL group,
   ``make_ulysses_attention(group, local_attention=make_flash_local(True))``,
   3 steps of forward and ``sum(out**2).backward()`` on q, k, v
   [1, 16384, 8, 128] with each flash kernel launched once a step, then
   one more step under torch.profiler (``path.profile``: each CUDA
   kernel's device ms, their sum and the device's idle share); at
   T = 8192 (MHA and Hkv = 2) its output and gradients match the same
   schedule over the built-in ``full_attention(causal=True)``, and the
   backward faults of phase 8, run through the same schedule, fail those
   limits; one step at T = 32768, where the scores alone would take 34 GB;
   the ring schedule at world 1 matches ``full_attention`` at T = 4096;
10. at the path's shape (1, 16384, 8, 8, 128, causal): the three flash
   kernels held against the plain version on the same inputs (the
   ``max_abs_err`` of their rows) and the one-TF32-pass faults read there,
   and their times beside the plain version's,
   ``scaled_dot_product_attention``'s (its backward alone for the
   backward rows) and their bound. Every flash row's ``bound_ms`` is the
   kernels' tensor-core route (3 TF32 products per f32 product at 495
   TFLOP/s), with the f32 CUDA-core figure under
   ``f32_cuda_core_bound_ms``. ``flash_timing_extra`` adds ``port_bwd_ms``
   (delta and both kernels, as the autograd Function runs them) beside
   ``sdpa_bwd_ms``, ``kernels_bwd_ms`` and ``sdpa_backend``, which an
   earlier ``sdpa_backend`` line names from the kernels of one
   torch.profiler step;
11. ``tokenize_boundaries`` against its plain version on the card, masks
   equal bit for bit: the sizes of ``TOKEN_SIZES`` (ragged n, separators
   only, none, an 8 MiB chunk), chunks starting 1-15 bytes into a buffer,
   and the first 8 MiB chunk of a seeded Criteo-shaped file (262,144
   rows, ~120 MB); masks that leave ':' out of the separators must differ
   from the kernel's there. The kernel and its plain version are timed at
   that chunk, and the ``kernel_token_spans`` route step by step;
12. the ingest path: ``create_row_block_iter`` over that file on the card
   and on the CPU must give the same RowBlock, bit for bit, and the
   tokenizer must launch once for each non-empty chunk part handed to
   ``LibSVMParser.parse_chunk`` (counted here); then the same through a
   ``#cachefile`` (``DiskRowIter``), cold (parses, launches) and warm
   (pages only, no launch). MB/s of each route, and the seconds
   ``kernel_token_spans`` takes over all the file's chunks.

Phases 5 and 6 also require the tokenizer to launch once for each chunk
part of their fits on the card: the parser tokenizes on the learner's
device. The last lines are the ``{"kernels": [...]}`` line, the card line
again, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # tensor cores, dense
# the flash kernels compute each f32 product as three TF32 products on the
# tensor cores (csrc/flash_mma.cuh)
TF32_PASSES = 3
# the one-TF32-pass faults must fail OUT_TOL (forward) and GRAD_TOL
# (backward) from this T on; below it (T = 33) they are only recorded
TF32_FAULT_MIN_T = 512

HIGGS_ROWS, HIGGS_FEATURES, HIGGS_BATCH = 262_144, 28, 16_384
CRITEO_ROWS, CRITEO_NNZ, CRITEO_DIM, CRITEO_BATCH = 65_536, 39, 1 << 20, 8192
EPOCHS = 2
# CPU (plain path) vs card (kernels) after 2 epochs of logistic SGD: the
# gradients sum in another order and the card's expf differs from the
# host's sigmoid by an ulp or two; 32 steps compound that to ~1e-6
# relative, held here with a margin. Params are held by the norm of the
# difference over the norm of the CPU's params (w and b together).
FIT_LOSS_RTOL = 1e-5
FIT_PARAM_REL = 1e-5
# both datasets carry a planted rule: 2 epochs must lower the mean loss
MIN_LOSS_FALL = 0.01
# flash attention against the plain version (tests/test_sequence_parallel.py's
# tolerances): f32 sums over the keys in another order, and the online
# softmax rescales partial sums per tile
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
# (B, T, H, Hkv, D, causal) of phase 8 and tests/test_torch_cuda.py:
# BASELINE's width with MHA and GQA, a ragged tail (1000 = 15 tiles of 64
# + 40) at D = 64, D = 32 both ways, and MQA over a sequence shorter than
# one tile
FLASH_CASES = ((1, 4096, 8, 8, 128, True), (1, 4096, 8, 2, 128, True),
               (2, 1000, 8, 2, 64, False), (1, 512, 8, 2, 32, True),
               (1, 512, 8, 2, 32, False), (3, 33, 4, 1, 64, True))
# BASELINE.md's long-context width: heads 8, head dim 128
ATTN_HEADS, ATTN_DIM = 8, 128
PATH_T, PATH_STEPS, CHECK_T, LONG_T, RING_T = 16384, 3, 8192, 32768, 4096
# the InputSplit's chunk (dmlc_tpu_torch/io/input_split.py)
CHUNK_BYTES = 8 << 20
# (kind, n) of phase 11 and tests/test_torch_cuda.py: tests/test_parse_parity
# .py's sizes around the 16-byte group and the TPU's 128-byte lane, a chunk
# of separators only and one with none, and a whole InputSplit chunk
TOKEN_SIZES = (("mixed", 0), ("mixed", 1), ("mixed", 127), ("mixed", 128),
               ("mixed", 129), ("mixed", 4096), ("mixed", 33000),
               ("all_sep", 4099), ("no_sep", 4099), ("mixed", CHUNK_BYTES))
TOKEN_ALPHABETS = {"mixed": b"0123456789.:-+e \t\r\nqid",
                   "all_sep": b" \t:\r\n", "no_sep": b"0123456789.-+eqid"}
# the ingest path's file: Criteo's widths (write_criteo), ~120 MB, ~15
# chunks: one partition of a many-worker Criteo job
INGEST_ROWS = 262_144


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str, *args) -> None:
    if not cond:
        raise SmokeFailure(msg % args if args else msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data files
# ---------------------------------------------------------------------------


def token_chunk(kind: str, size: int, seed: int) -> np.ndarray:
    """``size`` seeded random bytes of ``TOKEN_ALPHABETS[kind]``."""
    alphabet = np.frombuffer(TOKEN_ALPHABETS[kind], dtype=np.uint8)
    return alphabet[np.random.RandomState(seed).randint(0, alphabet.size,
                                                        size)]


def write_higgs(path: str, rows: int, seed: int) -> None:
    """HIGGS-shaped libsvm: 28 dense float features (ids 1-28), labels
    0/1 from a noisy linear rule so the loss has something to learn."""
    rng = np.random.RandomState(seed)
    true_w = rng.randn(HIGGS_FEATURES)
    fmt = "%d " + " ".join(f"{j}:%.6f" for j in range(1, HIGGS_FEATURES + 1))
    with open(path, "w") as fh:
        for start in range(0, rows, 16384):
            n = min(16384, rows - start)
            vals = rng.randn(n, HIGGS_FEATURES)
            labels = (vals @ true_w + rng.randn(n) > 0).astype(int)
            fh.write("\n".join(
                fmt % ((labels[i],) + tuple(vals[i].tolist()))
                for i in range(n)) + "\n")


def write_criteo(path: str, rows: int, seed: int) -> None:
    """Criteo-shaped libsvm: 39 sorted ids a row in [1, 2^20], 4-digit
    values (the bench.py csr tier's widths). Ids are skewed as hashed
    categorical values are (1 + 2^20·u^8 for uniform u: ~42 % of entries
    fall on the 1024 hottest ids), and labels 0/1 come from a noisy sparse
    linear rule, so that two epochs can lower the loss. Each row is one
    ``%`` format over a float64 row (ids and labels are exact there)."""
    rng = np.random.RandomState(seed)
    true_w = rng.randn(CRITEO_DIM + 1)
    fmt = "%d " + " ".join(["%d:%.4f"] * CRITEO_NNZ)
    with open(path, "w") as fh:
        for start in range(0, rows, 8192):
            n = min(8192, rows - start)
            ids = np.sort(1 + (rng.rand(n, CRITEO_NNZ) ** 8
                               * CRITEO_DIM).astype(np.int64), axis=1)
            vals = rng.rand(n, CRITEO_NNZ)
            margin = (vals * true_w[ids]).sum(axis=1)
            labels = (margin + 0.5 * rng.randn(n) > 0).astype(int)
            table = np.empty((n, 1 + 2 * CRITEO_NNZ))
            table[:, 0] = labels
            table[:, 1::2] = ids
            table[:, 2::2] = vals
            fh.write("\n".join(fmt % tuple(row) for row in table.tolist())
                     + "\n")


@contextlib.contextmanager
def count_parts():
    """The lengths of the non-empty chunk parts handed to
    ``LibSVMParser.parse_chunk`` while the block runs, counted here (the
    parse pool calls it from several threads): the tokenizer must launch
    once for each."""
    from dmlc_tpu_torch.data.parsers import LibSVMParser

    parts, lock, real = [], threading.Lock(), LibSVMParser.parse_chunk

    def counting(self, chunk):
        if chunk:
            with lock:
                parts.append(len(chunk))
        return real(self, chunk)

    LibSVMParser.parse_chunk = counting
    try:
        yield parts
    finally:
        LibSVMParser.parse_chunk = real


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, flush: torch.Tensor, iters: int = 30) -> float:
    """Median CUDA-event time of ``fn`` with a cold L2: each launch waits
    behind a write of ``flush`` (far larger than the 50 MB L2), which also
    covers the host's enqueue time, so the events bracket device work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_spills(log: str) -> dict:
    """{kernel entry (mangled): spill store + load bytes} from the
    ``-Xptxas -v`` lines of a build log."""
    spills, entry = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            entry = line.split("Function properties for", 1)[1].strip()
        elif "bytes spill stores" in line and entry is not None:
            words = line.replace(",", " ").split()
            spills[entry] = sum(int(words[i - 2]) for i, w in enumerate(words)
                                if w == "spill")
            entry = None
    return spills


def bound(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS) -> tuple:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the
    memory rate and ``flops`` over ``peak``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def fused_case(kernels, dev, rows, features, objective, integer, seed):
    rng = np.random.RandomState(seed)
    if integer:
        x = rng.randint(-1, 2, size=(rows, features))
        w = rng.randint(-1, 2, size=features)
        b = 1.0
        label = rng.randint(0, 2, size=rows)
        weight = rng.randint(0, 3, size=rows)
    else:
        x = rng.rand(rows, features)
        w = rng.randn(features) * 0.1 * np.sqrt(29.0 / features)
        b = 0.05
        # labels mostly 0: Σ wg stays far from 0, so every gw component is
        # well away from 0 and the relative tolerance is meaningful
        label = (rng.rand(rows) < 0.2).astype(int)
        weight = np.ones(rows)

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    args = (t(x), t(label), t(weight), t(w), t(b))
    got = kernels.fused_linear_grads(*args, objective=objective)
    again = kernels.fused_linear_grads(*args, objective=objective)
    want = kernels.fused_linear_grads_plain(*args, objective=objective)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(got, again)),
            "fused_linear_grads %s [%d, %d]: two runs differ in bits",
            objective, rows, features)
    err = max(float((a - c).abs().max()) for a, c in zip(got, want))
    for a, c in zip(got, want):
        if integer:
            require(torch.equal(a, c),
                    "fused_linear_grads %s [%d, %d] integer data: kernel "
                    "and plain differ (max abs err %g)",
                    objective, rows, features, err)
        else:
            require(torch.allclose(a, c, rtol=1e-5, atol=1e-6),
                    "fused_linear_grads %s [%d, %d]: kernel and plain "
                    "differ beyond rtol 1e-5 / atol 1e-6 (max abs err %g)",
                    objective, rows, features, err)
    return err, args


def criteo_batch(dev, seed):
    """A padded Criteo batch as the feed builds it: 8192 rows of 39
    entries (319,488) in a 327,680-entry bucket."""
    from dmlc_tpu_torch.data.row_block import RowBlock
    from dmlc_tpu_torch.device.csr import pad_to_bucket

    rng = np.random.RandomState(seed)
    rows = CRITEO_BATCH
    counts = np.full(rows, CRITEO_NNZ)
    offset = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(offset[-1])
    block = RowBlock(
        offset=offset, label=rng.randint(0, 2, rows),
        index=rng.randint(1, CRITEO_DIM + 1, nnz).astype(np.uint32),
        value=rng.rand(nnz).astype(np.float32))
    batch = pad_to_bucket(block, rows)
    return {k: torch.tensor(getattr(batch, k), device=dev)
            for k in ("labels", "weights", "indices", "values", "offsets")}


def seg_sum_edge_cases():
    """(name, row_ids, num_rows) of phase 4 and tests/test_torch_cuda.py:
    sorted int32 row ids where a search for a row's entries can go wrong.
    Each run of equal ids is one row's entries."""
    def runs(*pairs):  # (id, count), ...
        return np.concatenate([np.full(n, r, dtype=np.int32)
                               for r, n in pairs] or
                              [np.zeros(0, dtype=np.int32)])

    rng = np.random.RandomState(7)
    return [
        ("no entries", runs(), 5),
        ("fewer than a warp", np.sort(rng.randint(0, 6, 20)).astype(
            np.int32), 6),
        ("one row holds every entry", runs((3, 5000)), 8),
        ("empty rows at start, middle and end",
         runs((2, 40), (3, 1), (7, 300), (8, 33)), 12),
        ("-1 pad before row 0", runs((-1, 77), (0, 5), (1, 64), (4, 2)), 5),
        ("ids past the last row", runs((0, 9), (1, 31), (2, 1), (5, 50),
                                       (9, 700)), 5),
        ("a row longer than 32 x 32", runs((0, 3), (1, 1025), (2, 3000),
                                           (3, 1)), 4),
        ("one entry a row", np.arange(4099, dtype=np.int32), 4099),
    ]


def hold_seg_sum(kernels, dev, name, row_ids, num_rows):
    """coo_segment_sum on ``row_ids`` with seeded integer contributions:
    bit-equal to the plain version and the same bits twice."""
    rng = np.random.RandomState(len(row_ids) + num_rows)
    contrib = torch.tensor(rng.randint(-5, 6, len(row_ids)).astype(
        np.float32), device=dev)
    ids = torch.tensor(row_ids, device=dev)
    got = kernels.coo_segment_sum(contrib, ids, num_rows)
    again = kernels.coo_segment_sum(contrib, ids, num_rows)
    want = kernels.coo_segment_sum_plain(contrib, ids, num_rows)
    torch.cuda.synchronize()
    require(torch.equal(got, want),
            "coo_segment_sum %s: kernel and plain differ", name)
    require(torch.equal(got, again), "coo_segment_sum %s: two runs differ",
            name)


def run_fit(path, layout, batch_size, num_features, device,
            learning_rate=0.1):
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    learner = LinearLearner(device=device, objective="logistic",
                            learning_rate=learning_rate)
    t0 = time.perf_counter()
    history = learner.fit_uri(path, batch_size=batch_size, epochs=EPOCHS,
                              layout=layout, num_features=num_features)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return history, params_to_numpy(learner.params), seconds


def feed_seconds(path, layout, batch_size, num_features):
    """Seconds to read, parse, pad and copy to the card the batches of
    EPOCHS epochs with no step: the host's share of the fit."""
    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed

    feed = DeviceFeed(create_parser(path), BatchSpec(
        batch_size=batch_size, layout=layout, num_features=num_features))
    t0 = time.perf_counter()
    for epoch in range(EPOCHS):
        for _batch in feed:
            pass
        if epoch + 1 < EPOCHS:
            feed.before_first()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    feed.close()
    return seconds


def param_rel_err(params, ref) -> float:
    """|params - ref| / |ref| over w and b together (2-norms)."""
    a = np.append(params["w"], params["b"]).astype(np.float64)
    r = np.append(ref["w"], ref["b"]).astype(np.float64)
    return float(np.linalg.norm(a - r) / np.linalg.norm(r))


def drive_path(kernels, name, kernel_name, path, layout, batch_size,
               num_features, rows):
    steps = EPOCHS * (-(-rows // batch_size))
    kernels.reset_launch_counts()
    with count_parts() as parts:
        history, params, seconds = run_fit(path, layout, batch_size,
                                           num_features, None)
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    feed_only = feed_seconds(path, layout, batch_size, num_features)
    require(launches[kernel_name] == steps,
            "%s path: %s launched %d times for %d steps", name, kernel_name,
            launches[kernel_name], steps)
    require(launches["tokenize_boundaries"] == len(parts) > 0,
            "%s path: tokenize_boundaries launched %d times for %d chunk "
            "parts", name, launches["tokenize_boundaries"], len(parts))
    require(np.all(np.isfinite(history)), "%s path: loss history %s",
            name, history)
    for k in ("w", "b"):
        require(np.all(np.isfinite(params[k])), "%s path: %s not finite",
                name, k)
    require(params["w"].shape == (num_features,), "%s path: w shape %s",
            name, params["w"].shape)
    require(history[-1] < history[0] - MIN_LOSS_FALL,
            "%s path: loss did not fall by %g: %s", name, MIN_LOSS_FALL,
            history)
    cpu_history, cpu_params, cpu_seconds = run_fit(
        path, layout, batch_size, num_features, "cpu")
    np.testing.assert_allclose(history, cpu_history, rtol=FIT_LOSS_RTOL)
    rel_err = param_rel_err(params, cpu_params)
    require(rel_err <= FIT_PARAM_REL,
            "%s path: params differ from the CPU's by %g relative (limit %g)",
            name, rel_err, FIT_PARAM_REL)
    param_err = max(float(np.max(np.abs(params[k] - cpu_params[k])))
                    for k in ("w", "b"))
    # what the check reads for known faults: a step whose gradient is
    # halved (the same fit at half the learning rate), and w and b left
    # at their zero start (which reads 1 by construction)
    _, halved_params, _ = run_fit(path, layout, batch_size, num_features,
                                  "cpu", learning_rate=0.05)
    halved_err = param_rel_err(halved_params, cpu_params)
    require(halved_err > FIT_PARAM_REL,
            "%s path: a halved gradient reads %g, within the limit %g",
            name, halved_err, FIT_PARAM_REL)
    return {
        "steps": steps, "launches": launches, "chunk_parts": len(parts),
        "tokenize_launches": launches["tokenize_boundaries"],
        "seconds": seconds,
        "steps_per_s": steps / seconds, "rows_per_s": EPOCHS * rows / seconds,
        "feed_only_seconds": feed_only,
        "loss_history": history, "cpu_loss_history": cpu_history,
        "max_abs_param_err_vs_cpu": param_err,
        "param_rel_err_vs_cpu": rel_err,
        "halved_grad_param_rel_err": halved_err,
        "cpu_seconds": cpu_seconds,
    }


def tol_ratio(got, want, tol) -> float:
    """max |got - want| / (atol + rtol·|want|): at most 1 inside ``tol``."""
    return float(((got - want).abs()
                  / (tol["atol"] + tol["rtol"] * want.abs())).max())


def randn(gen, shape, dev, grad=False):
    return torch.randn(shape, generator=gen, device=dev,
                       requires_grad=grad)


def flash_kernels(q, k, v, dout, causal):
    """(out, lse, dq, dk, dv) from the three flash kernels."""
    from dmlc_tpu_torch.ops import kernels
    from dmlc_tpu_torch.ops.flash_attention import flash_attention_bwd

    out, lse = kernels.flash_attention_fwd(q, k, v, causal)
    return (out, lse) + flash_attention_bwd(q, k, v, out, lse, dout, causal)


def diagonal_hidden(q, k, v):
    """The forward fault: attention whose causal mask also hides the
    diagonal (query p sees keys < p only)."""
    from dmlc_tpu_torch.ops.attention import NEG_INF, grouped_pv, grouped_scores

    s = grouped_scores(q, k)
    pos = torch.arange(s.shape[-1], device=q.device)
    return grouped_pv(torch.softmax(
        s.masked_fill(pos[:, None] <= pos[None, :], NEG_INF), -1), v)


def diagonal_detached(q, k, v, causal):
    """The backward fault: the forward is sound, but the scores of query p
    against key p pass no gradient (dS without its diagonal, in dQ and
    dK)."""
    from dmlc_tpu_torch.ops.attention import grouped_pv, masked_scores

    s = masked_scores(q, k, causal)
    eye = torch.eye(s.shape[-1], dtype=torch.bool, device=q.device)
    return grouped_pv(torch.softmax(torch.where(eye, s.detach(), s), -1), v)


def first_head_mask(h, hk, dev):
    """[H, 1] of 1 for the first query head of each GQA group, else 0: an
    output gradient times it gives dK and dV summed over that head only."""
    return (torch.arange(h, device=dev) % (h // hk) == 0).float()[:, None]


def grads_of(fn, q, k, v, dout):
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


def hold_flash(shape, got, want):
    """The kernels' (out, lse, dq, dk, dv) against the plain version's:
    each finite and within its tolerance; returns the readings."""
    names = ("out", "lse", "dq", "dk", "dv")
    tols = (OUT_TOL, OUT_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)
    report = {"shape": list(shape)}
    for name, x, w, tol in zip(names, got, want, tols):
        require(bool(torch.isfinite(x).all()), "flash %s: %s not finite",
                shape, name)
        report[name + "_max_abs_err"] = float((x - w).abs().max())
        report[name + "_tol_ratio"] = tol_ratio(x, w, tol)
        require(report[name + "_tol_ratio"] <= 1.0,
                "flash %s: %s differs from plain beyond rtol %g / atol %g "
                "(max abs err %g)", shape, name, tol["rtol"], tol["atol"],
                report[name + "_max_abs_err"])
    return report


def read_fault(where, report, key, fault, sound, tol, must_fail=True):
    """Reads a known fault against the limit ``tol``, where the sound
    result passes, and (with ``must_fail``) requires it to fail there."""
    report[key + "_tol_ratio"] = tol_ratio(fault, sound, tol)
    report[key + "_max_abs_err"] = float((fault - sound).abs().max())
    require(not must_fail or report[key + "_tol_ratio"] > 1.0,
            "%s: the fault %s reads %g, inside the limit", where, key,
            report[key + "_tol_ratio"])


def one_tf32_pass(fn):
    """``fn()`` with torch's matmuls in one TF32 pass (``allow_tf32 =
    True``): what the flash kernels would give without their 3-pass split.
    TF32 goes off again (``strict_f32``) however it ends."""
    from dmlc_tpu_torch.utils.device import strict_f32

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        strict_f32()


def read_tf32_fault(where, report, names, fault, got, tol, t):
    """Reads the one-TF32-pass results ``fault`` against ``tol`` beside the
    kernels' ``got`` (keys ``one_tf32_pass_<name>``); from
    TF32_FAULT_MIN_T on the fault must fail there (the largest of its
    readings above 1)."""
    keys = ["one_tf32_pass_" + name for name in names]
    for key, f, g in zip(keys, fault, got):
        read_fault(where, report, key, f, g, tol, must_fail=False)
    worst = max(report[key + "_tol_ratio"] for key in keys)
    require(t < TF32_FAULT_MIN_T or worst > 1.0,
            "%s: the one-TF32-pass fault on %s reads %g, inside the limit",
            where, "/".join(names), worst)


def read_tf32_faults(kernels, where, report, q, k, v, dout, causal, got):
    """The forward's (out, lse against OUT_TOL: the plain forward) and the
    backward's (dq, dk, dv against GRAD_TOL: ``full_attention``'s autograd
    backward) one-TF32-pass faults beside the kernels' (out, lse, dq, dk,
    dv)."""
    from dmlc_tpu_torch.ops import full_attention

    t = q.shape[1]
    fault = one_tf32_pass(
        lambda: kernels.flash_attention_fwd_plain(q, k, v, causal))
    read_tf32_fault(where, report, ("out", "lse"), fault, got[:2], OUT_TOL,
                    t)
    del fault
    torch.cuda.empty_cache()
    fault = one_tf32_pass(lambda: grads_of(
        lambda *x: full_attention(*x, causal), q, k, v, dout))
    read_tf32_fault(where, report, ("dq", "dk", "dv"), fault, got[2:],
                    GRAD_TOL, t)


def flash_case(kernels, dev, b, t, h, hk, d, causal, seed):
    """Phase 8 for one shape: the three kernels against the plain version,
    and the known faults against the same limits."""
    from dmlc_tpu_torch.ops import full_attention

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (randn(gen, s, dev) for s in (
        (b, t, h, d), (b, t, hk, d), (b, t, hk, d), (b, t, h, d)))
    got = flash_kernels(q, k, v, dout, causal)
    again = flash_kernels(q, k, v, dout, causal)
    want = kernels.flash_attention_fwd_plain(q, k, v, causal) + tuple(
        kernels.flash_attention_bwd_plain(q, k, v, dout, causal))
    torch.cuda.synchronize()
    shape = (b, t, h, hk, d, causal)
    require(all(torch.equal(x, y) for x, y in zip(got, again)),
            "flash %s: two runs differ in bits", shape)
    report = hold_flash(shape, got, want)
    where = "flash %s" % (shape,)
    if causal:
        read_fault(where, report, "diagonal_hidden_out",
                   diagonal_hidden(q, k, v), got[0], OUT_TOL)
    fault = grads_of(lambda *x: diagonal_detached(*x, causal), q, k, v, dout)
    read_fault(where, report, "diagonal_detached_dq", fault[0], got[2],
               GRAD_TOL)
    read_fault(where, report, "diagonal_detached_dk", fault[1], got[3],
               GRAD_TOL)
    if hk < h:
        fault = grads_of(lambda *x: full_attention(*x, causal), q, k, v,
                         dout * first_head_mask(h, hk, dev))
        read_fault(where, report, "first_head_only_dk", fault[1], got[3],
                   GRAD_TOL)
        read_fault(where, report, "first_head_only_dv", fault[2], got[4],
                   GRAD_TOL)
    read_tf32_faults(kernels, where, report, q, k, v, dout, causal, got)
    del q, k, v, dout, got, again, want, fault
    torch.cuda.empty_cache()
    return report


def attention_steps(fn, q, k, v, steps):
    """``steps`` of forward and sum(out**2).backward(); returns the last
    output, its gradients and each step's milliseconds (host clock, each
    step ending in a synchronize)."""
    times = []
    for _ in range(steps):
        for x in (q, k, v):
            x.grad = None
        t0 = time.perf_counter()
        out = fn(q, k, v)
        (out ** 2).sum().backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out.detach(), [x.grad for x in (q, k, v)], times


def profile_step(fn, q, k, v) -> dict:
    """One step of ``attention_steps`` under torch.profiler: the device
    milliseconds of each CUDA kernel (by name, summed), their total, the
    step's host milliseconds (profiler on) and the device's idle share of
    them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_ms = attention_steps(fn, q, k, v, 1)[2][0]
    kernel_ms = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernel_ms[e.key[:96]] = kernel_ms.get(e.key[:96], 0.0) + us / 1e3
    busy = sum(kernel_ms.values())
    top = dict(sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:8])
    return {"step_ms": step_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / step_ms, "kernel_ms": top}


def attention_inputs(dev, t, hk, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [randn(gen, (1, t, heads, ATTN_DIM), dev, grad=True)
            for heads in (ATTN_HEADS, hk, hk)]


def compare_schedules(name, got, want):
    """got/want: (out, [dq, dk, dv]); returns the tolerance ratios."""
    ratios = {"out": tol_ratio(got[0], want[0], OUT_TOL)}
    for key, g, w in zip(("dq", "dk", "dv"), got[1], want[1]):
        ratios[key] = tol_ratio(g, w, GRAD_TOL)
    for key, r in ratios.items():
        require(r <= 1.0, "%s: %s differs beyond its tolerance (ratio %g)",
                name, key, r)
    return ratios


def drive_attention(kernels, dev, group):
    """Phase 9: the long-context path on the card."""
    from dmlc_tpu_torch.ops import (full_attention, make_flash_local,
                                    make_ring_attention,
                                    make_ulysses_attention)

    flash = make_ulysses_attention(group,
                                   local_attention=make_flash_local(True))
    builtin = make_ulysses_attention(group, causal=True)
    result = {}
    q, k, v = attention_inputs(dev, PATH_T, ATTN_HEADS, 21)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, grads, times = attention_steps(flash, q, k, v, PATH_STEPS)
    launches = {n: fn.launches for n, fn in kernels.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        require(launches[name] == PATH_STEPS,
                "attention path: %s launched %d times in %d steps", name,
                launches[name], PATH_STEPS)
    require(out.shape == q.shape and bool(torch.isfinite(out).all())
            and all(bool(torch.isfinite(g).all()) for g in grads),
            "attention path: output or gradients not finite")
    result["path"] = {"T": PATH_T, "step_ms": times, "launches": launches,
                      "peak_bytes": peak,
                      "profile": profile_step(flash, q, k, v)}
    del q, k, v, out, grads

    # the known backward faults, through the same schedule, read against
    # the same limits: dS without its diagonal, and (under GQA) dK/dV
    # summed over only the first query head of each group
    diagonal_fault = make_ulysses_attention(
        group, local_attention=lambda q, k, v: diagonal_detached(q, k, v,
                                                                 True))
    for hk in (ATTN_HEADS, 2):
        q, k, v = attention_inputs(dev, CHECK_T, hk, 22 + hk)
        got = attention_steps(flash, q, k, v, 1)[:2]
        want = attention_steps(builtin, q, k, v, 1)[:2]
        name = f"vs_full_attention_T{CHECK_T}_hkv{hk}"
        report = compare_schedules(name, got, want)
        del want
        fault = attention_steps(diagonal_fault, q, k, v, 1)[1]
        read_fault(name, report, "diagonal_detached_dq", fault[0],
                   got[1][0], GRAD_TOL)
        read_fault(name, report, "diagonal_detached_dk", fault[1],
                   got[1][1], GRAD_TOL)
        if hk < ATTN_HEADS:
            mask = first_head_mask(ATTN_HEADS, hk, dev)
            fault = attention_steps(lambda *x: builtin(*x) * mask, q, k, v,
                                    1)[1]
            read_fault(name, report, "first_head_only_dk", fault[1],
                       got[1][1], GRAD_TOL)
            read_fault(name, report, "first_head_only_dv", fault[2],
                       got[1][2], GRAD_TOL)
        result[name] = report
        del q, k, v, got, fault
        torch.cuda.empty_cache()

    q, k, v = attention_inputs(dev, LONG_T, ATTN_HEADS, 23)
    torch.cuda.reset_peak_memory_stats()
    out, grads, times = attention_steps(flash, q, k, v, 1)
    peak = torch.cuda.max_memory_allocated()
    scores_bytes = 4 * ATTN_HEADS * LONG_T * LONG_T
    require(bool(torch.isfinite(out).all())
            and all(bool(torch.isfinite(g).all()) for g in grads),
            "attention path at T=%d: not finite", LONG_T)
    require(peak < scores_bytes / 8,
            "attention path at T=%d: peak %d bytes, near the %d of the "
            "scores", LONG_T, peak, scores_bytes)
    result["long"] = {"T": LONG_T, "step_ms": times, "peak_bytes": peak,
                      "scores_bytes": scores_bytes}
    del q, k, v, out, grads

    q, k, v = attention_inputs(dev, RING_T, 2, 24)
    kernels.reset_launch_counts()
    got = attention_steps(make_ring_attention(group, causal=True), q, k, v,
                          1)[:2]
    ring_launches = sum(fn.launches for fn in kernels.KERNELS.values())
    want = attention_steps(
        lambda q, k, v: full_attention(q, k, v, causal=True), q, k, v, 1)[:2]
    result[f"ring_vs_full_attention_T{RING_T}"] = compare_schedules(
        "ring vs full_attention", got, want)
    result["ring_kernel_launches"] = ring_launches
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return result


def sdpa_backend(fn) -> dict:
    """The backend behind ``fn`` (one scaled_dot_product_attention step),
    named from the CUDA kernels one torch.profiler run of it records."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if getattr(e, "device_type", None)
                    == torch.autograd.DeviceType.CUDA})
    lower = " ".join(names).lower()
    backend = ("cudnn" if "cudnn" in lower else
               "flash" if "flash" in lower else
               "efficient" if ("fmha" in lower or "efficient" in lower
                               or "mem_eff" in lower) else "math")
    return {"backend": backend, "kernels": names}


def flash_timing_rows(kernels, dev, launches):
    """Phase 10: the three flash kernels at the path's shape, held against
    the plain version on the same inputs and timed beside it,
    scaled_dot_product_attention and their bound; the one-TF32-pass fault
    read there; the port's whole backward (delta and both kernels) beside
    SDPA's, and SDPA's backend."""
    import torch.nn.functional as F

    from dmlc_tpu_torch.ops import full_attention
    from dmlc_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                    softmax_delta)

    b, t, h, d = 1, PATH_T, ATTN_HEADS, ATTN_DIM
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v, dout = (randn(gen, (b, t, h, d), dev) for _ in range(4))
    got = flash_kernels(q, k, v, dout, True)
    out, lse = got[:2]
    delta = softmax_delta(out, dout)
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    ms = {
        "flash_attention_fwd": time_ms(
            lambda: kernels.flash_attention_fwd(q, k, v, True), flush, 10),
        "flash_attention_bwd_dq": time_ms(
            lambda: kernels.flash_attention_bwd_dq(
                q, k, v, dout, lse, delta, True), flush, 10),
        "flash_attention_bwd_dkv": time_ms(
            lambda: kernels.flash_attention_bwd_dkv(
                q, k, v, dout, lse, delta, True), flush, 10),
    }
    # the backward as the autograd Function runs it: delta, dQ, dK/dV
    port_bwd_ms = time_ms(lambda: flash_attention_bwd(
        q, k, v, out, lse, dout, True), flush, 10)
    # the plain version keeps several [B, H, T, T] f32 tensors (8.6 GB
    # each here); its last results are kept and the kernels held to them
    plain = {}

    def plain_fwd():
        plain["fwd"] = kernels.flash_attention_fwd_plain(q, k, v, True)

    with torch.no_grad():
        plain_fwd_ms = time_ms(plain_fwd, flush, 3)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref = full_attention(*leaves, True)

    def plain_bwd():
        plain["bwd"] = torch.autograd.grad(ref, leaves, dout,
                                           retain_graph=True)

    plain_bwd_ms = time_ms(plain_bwd, flush, 3)
    del ref, leaves
    torch.cuda.empty_cache()
    report = hold_flash((b, t, h, h, d, True), got,
                        plain["fwd"] + tuple(plain["bwd"]))
    errors = {
        "flash_attention_fwd": max(report["out_max_abs_err"],
                                   report["lse_max_abs_err"]),
        "flash_attention_bwd_dq": report["dq_max_abs_err"],
        "flash_attention_bwd_dkv": max(report["dk_max_abs_err"],
                                       report["dv_max_abs_err"]),
    }
    del plain
    torch.cuda.empty_cache()
    read_tf32_faults(kernels, "flash at the path shape", report, q, k, v,
                     dout, True, got)
    torch.cuda.empty_cache()
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, dout))
    with torch.no_grad():
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush, 10)
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(o, leaves, dot)

    sdpa_both = time_ms(sdpa_fwd_bwd, flush, 10)
    backend = sdpa_backend(sdpa_fwd_bwd)
    print(json.dumps({"sdpa_backend": backend}), flush=True)
    # the backward alone, as the plain backward is timed: one forward
    # outside the timed region
    o = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        o, leaves, dot, retain_graph=True), flush, 10)
    extra = {"vs_plain_at_path_shape": report,
             "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
             "sdpa_fwd_bwd_ms": sdpa_both, "plain_fwd_ms": plain_fwd_ms,
             "plain_bwd_ms": plain_bwd_ms, "port_bwd_ms": port_bwd_ms,
             "kernels_bwd_ms": ms["flash_attention_bwd_dq"]
             + ms["flash_attention_bwd_dkv"],
             "sdpa_backend": backend["backend"]}
    del flush, leaves, o
    torch.cuda.empty_cache()

    pairs = b * h * t * (t + 1) / 2  # causal (query, key) pairs
    qkv = 4 * b * t * h * d  # bytes of one [B, T, H, D] f32 tensor
    rows_lse = 4 * b * h * t
    work = {  # (bytes moved once, f32 flops): 2 products per matmul-pair
        "flash_attention_fwd": (4 * qkv + rows_lse, 2 * 2 * d * pairs),
        "flash_attention_bwd_dq": (5 * qkv + 2 * rows_lse, 3 * 2 * d * pairs),
        "flash_attention_bwd_dkv": (6 * qkv + 2 * rows_lse,
                                    4 * 2 * d * pairs),
    }
    sources = {
        "flash_attention_fwd": (
            "dmlc_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            "dmlc_tpu/ops/sequence_parallel.py:423"),
        "flash_attention_bwd_dq": (
            "dmlc_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "dmlc_tpu/ops/sequence_parallel.py:423"),
        "flash_attention_bwd_dkv": (
            "dmlc_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "dmlc_tpu/ops/sequence_parallel.py:423"),
    }
    rows = []
    for name, (source, replaces) in sources.items():
        fwd = name == "flash_attention_fwd"
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errors[name], "ms": ms[name],
               "plain_ms": plain_fwd_ms if fwd else plain_bwd_ms,
               "library_ms": sdpa_fwd if fwd else sdpa_bwd}
        # the route the kernels take: TF32_PASSES TF32 products per f32
        # product on the tensor cores; the f32 CUDA-core figure beside
        nbytes, flops = work[name]
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, TF32_PASSES * flops, PEAK_TF32_FLOPS)
        row["f32_cuda_core_bound_ms"] = bound(nbytes, flops)[0]
        rows.append(row)
    del q, k, v, dout, got, out, lse, delta
    torch.cuda.empty_cache()
    return rows, extra


def hold_masks(kernels, where, a):
    """The kernel's masks of ``a`` against the plain version's: equal, bit
    for bit (they are exact booleans). Returns the kernel's masks and the
    max |kernel - plain| over both, each mask read as 0/1."""
    got = kernels.tokenize_boundaries(a)
    want = kernels.tokenize_boundaries_plain(a)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("starts", "ends"), got, want):
        require(g.dtype == torch.bool and g.shape == a.shape,
                "tokenize_boundaries %s: %s is %s %s", where, name, g.dtype,
                tuple(g.shape))
        require(torch.equal(g, w),
                "tokenize_boundaries %s: %s differ from plain at %d bytes",
                where, name, int((g != w).sum()))
        if g.numel():
            err = max(err, float((g.to(torch.int8) - w.to(torch.int8))
                                 .abs().max()))
    return got, err


def colon_dropped_masks(a):
    """The known fault: token masks whose separators leave out ':'."""
    sep = torch.zeros_like(a, dtype=torch.bool)
    for code in (0x20, 0x09, 0x0A, 0x0D):
        sep |= a == code
    edge = torch.ones(1, dtype=torch.bool, device=a.device)
    return ~sep & torch.cat([edge, sep[:-1]]), ~sep & torch.cat([sep[1:],
                                                                 edge])


def first_chunk(path: str) -> np.ndarray:
    from dmlc_tpu_torch.io import create_input_split

    split = create_input_split(path, 0, 1)
    try:
        return np.frombuffer(split.next_chunk(), dtype=np.uint8)
    finally:
        split.close()


def host_ms(fn, repeats: int = 5):
    """(median host milliseconds of ``fn()``, its last result); ``fn``
    ends in a synchronize or a copy to the host."""
    times, out = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def tokenizer_vs_plain(kernels, dev, path):
    """Phase 11: the tokenizer against its plain version on the card, the
    colon-dropped fault, and the kernel, its plain version and the whole
    ``kernel_token_spans`` route timed at one chunk of ``path``."""
    from dmlc_tpu_torch.data import vparse

    err = 0.0
    for kind, size in TOKEN_SIZES:
        err = max(err, hold_masks(kernels, "%s n=%d" % (kind, size),
                                  torch.tensor(token_chunk(kind, size,
                                                           seed=size),
                                               device=dev))[1])
    buf = torch.tensor(token_chunk("mixed", 70_000, seed=5), device=dev)
    for off in range(1, 16):
        for n in (1, 15, 16, 17, 65_536 - off):
            err = max(err, hold_masks(kernels, "offset %d n=%d" % (off, n),
                                      buf[off:off + n])[1])
    chunk = first_chunk(path)
    a = torch.tensor(chunk, device=dev)
    n = a.shape[0]
    got, chunk_err = hold_masks(kernels, "criteo chunk n=%d" % n, a)
    err = max(err, chunk_err)
    fault = colon_dropped_masks(a)
    fault_bytes = int(sum(int((g != f).sum()) for g, f in zip(got, fault)))
    require(fault_bytes > 0, "the colon-dropped masks equal the kernel's")
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    ms = time_ms(lambda: kernels.tokenize_boundaries(a), flush, 30)
    plain_ms = time_ms(lambda: kernels.tokenize_boundaries_plain(a), flush,
                       30)
    del flush
    # the route, step by step, on the host's clock (pageable copies)
    own_ms, owned = host_ms(lambda: torch.from_numpy(chunk.copy()))
    h2d_ms, on_card = host_ms(lambda: (owned.to(dev),
                                       torch.cuda.synchronize())[0])
    d2h_ms, masks = host_ms(lambda: tuple(
        m.cpu().numpy() for m in kernels.tokenize_boundaries(on_card)))
    spans_ms, _ = host_ms(lambda: (np.flatnonzero(masks[0]),
                                   np.flatnonzero(masks[1]) + 1))
    route_ms, spans = host_ms(lambda: vparse.kernel_token_spans(chunk, dev))
    want = vparse.token_boundary_masks(chunk)
    require(np.array_equal(spans[0], np.flatnonzero(want[0]))
            and np.array_equal(spans[1], np.flatnonzero(want[1]) + 1),
            "kernel_token_spans differs from the numpy spans")
    numpy_ms, _ = host_ms(lambda: vparse.token_boundary_masks(chunk))
    report = {"chunk_bytes": n, "fault_colon_dropped_differing_bytes":
              fault_bytes, "kernel_ms": ms, "plain_ms": plain_ms,
              "route_ms": {"kernel_token_spans": route_ms,
                           "copy_into_owned_tensor": own_ms,
                           "h2d": h2d_ms, "kernel_and_d2h": d2h_ms,
                           "flatnonzero": spans_ms},
              "numpy_masks_ms": numpy_ms}
    row = {"name": "tokenize_boundaries", "route": "cuda",
           "source": "dmlc_tpu_torch/ops/csrc/tokenize_boundaries.cu",
           "replaces": "dmlc_tpu/ops/pallas_kernels.py:279",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound(3 * n, 0)
    del a, got, fault, buf, on_card
    torch.cuda.empty_cache()
    return row, report


def same_blocks(where, got, want) -> None:
    for name in ("offset", "label", "index", "value", "weight", "qid",
                 "field"):
        g, w = getattr(got, name), getattr(want, name)
        require((g is None) == (w is None) and (
            g is None or (g.dtype == w.dtype and np.array_equal(g, w))),
            "%s: %s differs from the CPU route's", where, name)


def read_all(it):
    from dmlc_tpu_torch.data import RowBlockContainer

    cont = RowBlockContainer()
    try:
        for block in it:
            cont.push_block(block)
        return cont.to_block(), it.num_col()
    finally:
        it.close()


def drive_ingest(kernels, dev, path, tmp):
    """Phase 12: create_row_block_iter over the Criteo-shaped file on the
    card and on the CPU, bit for bit, with one tokenizer launch a chunk
    part; then through a #cachefile, cold and warm."""
    from dmlc_tpu_torch.data import create_row_block_iter

    nbytes = os.path.getsize(path)
    result = {"file_bytes": nbytes}

    def timed(uri, device):
        kernels.reset_launch_counts()
        with count_parts() as parts:
            t0 = time.perf_counter()
            block, ncol = read_all(create_row_block_iter(uri, device=device))
            seconds = time.perf_counter() - t0
        return block, ncol, seconds, len(parts), \
            kernels.tokenize_boundaries.launches

    card, ncol, sec, parts, launches = timed(path, dev)
    require(launches == parts > 0, "ingest: %d tokenizer launches for %d "
            "chunk parts", launches, parts)
    cpu, cpu_ncol, cpu_sec, _, cpu_launches = timed(path, "cpu")
    require(cpu_launches == 0, "ingest: the CPU route launched a kernel")
    same_blocks("ingest on the card", card, cpu)
    require(ncol == cpu_ncol and len(card) == INGEST_ROWS,
            "ingest: num_col %d/%d, %d rows", ncol, cpu_ncol, len(card))
    result.update({"rows": len(card), "nnz": card.num_nonzero,
                   "num_col": ncol, "chunk_parts": parts,
                   "launches": launches, "card_seconds": sec,
                   "card_mb_per_s": nbytes / 1e6 / sec,
                   "cpu_seconds": cpu_sec,
                   "cpu_mb_per_s": nbytes / 1e6 / cpu_sec})
    cache = os.path.join(tmp, "criteo.cache")
    for state in ("cold", "warm"):
        block, dncol, dsec, dparts, dlaunches = timed(path + "#" + cache,
                                                      dev)
        same_blocks("ingest through the %s cache" % state, block, cpu)
        require(dncol == cpu_ncol, "ingest %s cache: num_col %d", state,
                dncol)
        require(dlaunches == dparts and (dparts > 0) == (state == "cold"),
                "ingest %s cache: %d launches for %d chunk parts", state,
                dlaunches, dparts)
        result["disk_" + state] = {"seconds": dsec,
                                   "mb_per_s": nbytes / 1e6 / dsec,
                                   "launches": dlaunches}
    del card, cpu, block
    # the seconds kernel_token_spans takes over every chunk of the file
    from dmlc_tpu_torch.data import vparse
    from dmlc_tpu_torch.io import create_input_split

    split = create_input_split(path, 0, 1)
    spans_seconds, chunks = 0.0, 0
    try:
        while True:
            chunk = split.next_chunk()
            if chunk is None:
                break
            a = np.frombuffer(chunk, dtype=np.uint8)
            t0 = time.perf_counter()
            vparse.kernel_token_spans(a, dev)
            spans_seconds += time.perf_counter() - t0
            chunks += 1
    finally:
        split.close()
    result["kernel_token_spans"] = {"chunks": chunks,
                                    "seconds": spans_seconds}
    return result


def kernel_times(kernels, dev) -> dict:
    """``--times``: the kernels' times at the main path's shapes (as phases
    7, 10 and 11 take them, the forward twice) beside SDPA's forward and
    ``index_add_``."""
    import torch.nn.functional as F

    from dmlc_tpu_torch.ops.flash_attention import softmax_delta
    from dmlc_tpu_torch.ops.spmv import expand_row_ids

    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v, dout = (randn(gen, (1, PATH_T, ATTN_HEADS, ATTN_DIM), dev)
                     for _ in range(4))
    out, lse = kernels.flash_attention_fwd(q, k, v, True)
    delta = softmax_delta(out, dout)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    batch = criteo_batch(dev, 3)
    row_ids = expand_row_ids(batch["offsets"], batch["values"].shape[0])
    ids64 = row_ids.long()
    contrib = batch["values"] * 0.5
    dense = fused_case(kernels, dev, HIGGS_BATCH, HIGGS_FEATURES + 1,
                       "logistic", False, 2)[1]
    chunk = torch.tensor(token_chunk("mixed", CHUNK_BYTES, seed=1),
                         device=dev)
    with torch.no_grad():
        return {
            "flash_attention_fwd": [
                time_ms(lambda: kernels.flash_attention_fwd(q, k, v, True),
                        flush, 10) for _ in range(2)],
            "flash_attention_bwd_dq": time_ms(
                lambda: kernels.flash_attention_bwd_dq(
                    q, k, v, dout, lse, delta, True), flush, 10),
            "flash_attention_bwd_dkv": time_ms(
                lambda: kernels.flash_attention_bwd_dkv(
                    q, k, v, dout, lse, delta, True), flush, 10),
            "sdpa_fwd": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), flush, 10),
            "coo_segment_sum": time_ms(lambda: kernels.coo_segment_sum(
                contrib, row_ids, CRITEO_BATCH), flush),
            "index_add_": time_ms(lambda: torch.zeros(
                CRITEO_BATCH, device=dev).index_add_(0, ids64, contrib),
                flush),
            "fused_linear_grads": time_ms(lambda: kernels.fused_linear_grads(
                *dense, objective="logistic"), flush),
            "tokenize_boundaries": time_ms(
                lambda: kernels.tokenize_boundaries(chunk), flush),
        }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--times"]:
        from dmlc_tpu_torch.ops import kernels
        from dmlc_tpu_torch.utils.device import resolve_device

        dev = resolve_device(None)
        print("card:", card_line())
        print(json.dumps({"times": kernel_times(kernels, dev)}))
        return 0
    require(not sys.argv[1:], "unknown arguments %s (only --times)",
            sys.argv[1:])
    from dmlc_tpu_torch.ops import _build, kernels
    from dmlc_tpu_torch.ops.spmv import expand_row_ids, spmv_transpose
    from dmlc_tpu_torch.utils.device import resolve_device

    started = time.perf_counter()
    dev = resolve_device(None)  # also turns TF32 off
    card = card_line()
    print("card:", card, flush=True)
    torch.cuda.synchronize()

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels._lib()
    built = time.perf_counter() - t0
    print(json.dumps({"build_seconds": built,
                      "nvcc_seconds": _build.build_seconds}), flush=True)
    log = _build.build_log_path()
    require(log.exists(), "no build log beside the kernels' library")
    text = log.read_text()
    for line in text.splitlines():
        if ("registers" in line or "spill" in line
                or line.startswith("==") or "Compiling entry" in line):
            print("  ptxas:", line.strip())
    spills = ptxas_spills(text)
    flash = {name: n for name, n in spills.items() if "flash_" in name}
    require(len(flash) == 3 * 3 * 2,
            "ptxas reported %d flash kernel variants, expected 18", len(flash))
    require(not any(flash.values()), "flash kernels spill: %s",
            {name: n for name, n in flash.items() if n})
    torch.cuda.synchronize()

    # ---- 3. fused_linear_grads vs plain ------------------------------------
    fused_err = None
    main_args = None
    for rows, features in ((16384, 29), (1000, 29), (4096, 2048)):
        for objective in ("squared", "hinge"):
            fused_case(kernels, dev, rows, features, objective, True, 1)
        err, args = fused_case(kernels, dev, rows, features, "logistic",
                               False, 2)
        print(json.dumps({"fused_linear_grads": [rows, features],
                          "logistic_max_abs_err": err}), flush=True)
        if (rows, features) == (16384, 29):
            fused_err, main_args = err, args
    torch.cuda.synchronize()

    # ---- 4. coo_segment_sum vs plain, spmv_transpose determinism -----------
    batch = criteo_batch(dev, 3)
    entries = batch["values"].shape[0]
    row_ids = expand_row_ids(batch["offsets"], entries)
    require(torch.equal(row_ids.cpu(),
                        expand_row_ids(batch["offsets"].cpu(), entries)),
            "expand_row_ids: card and CPU differ")
    rng = np.random.RandomState(4)
    contrib_int = rng.randint(-5, 6, entries).astype(np.float32)
    contrib_int[batch["values"].cpu().numpy() == 0] = 0.0  # padded tail
    contrib_int = torch.tensor(contrib_int, device=dev)
    got = kernels.coo_segment_sum(contrib_int, row_ids, CRITEO_BATCH)
    again = kernels.coo_segment_sum(contrib_int, row_ids, CRITEO_BATCH)
    want = kernels.coo_segment_sum_plain(contrib_int, row_ids, CRITEO_BATCH)
    torch.cuda.synchronize()
    require(torch.equal(got, want),
            "coo_segment_sum integer data: kernel and plain differ")
    require(torch.equal(got, again), "coo_segment_sum: two runs differ")
    for name, ids, num_rows in seg_sum_edge_cases():
        hold_seg_sum(kernels, dev, name, ids, num_rows)
    w_vec = torch.tensor(rng.randn(CRITEO_DIM + 1).astype(np.float32) * 0.1,
                         device=dev)
    contrib = batch["values"] * w_vec.index_select(0, batch["indices"])
    got = kernels.coo_segment_sum(contrib, row_ids, CRITEO_BATCH)
    want = kernels.coo_segment_sum_plain(contrib, row_ids, CRITEO_BATCH)
    seg_err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
            "coo_segment_sum float data: max abs err %g", seg_err)
    row_grads = torch.tensor(rng.randn(CRITEO_BATCH).astype(np.float32),
                             device=dev)
    g1 = spmv_transpose(batch["values"], batch["indices"], row_ids,
                        row_grads, CRITEO_DIM + 1)
    g2 = spmv_transpose(batch["values"], batch["indices"], row_ids,
                        row_grads, CRITEO_DIM + 1)
    torch.use_deterministic_algorithms(True)
    try:
        g_det = spmv_transpose(batch["values"], batch["indices"], row_ids,
                               row_grads, CRITEO_DIM + 1)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    require(torch.equal(g1, g2), "spmv_transpose: two runs differ in bits")
    require(torch.equal(g1, g_det),
            "spmv_transpose: bits differ from torch's deterministic mode")
    print(json.dumps({"coo_segment_sum_float_max_abs_err": seg_err,
                      "spmv_transpose_same_bits_twice": True}), flush=True)

    # ---- 5./6. the main path, dense and csr --------------------------------
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        higgs = os.path.join(tmp, "higgs.svm")
        write_higgs(higgs, HIGGS_ROWS, seed=11)
        paths["dense"] = drive_path(
            kernels, "dense", "fused_linear_grads", higgs, "dense",
            HIGGS_BATCH, HIGGS_FEATURES + 1, HIGGS_ROWS)
        torch.cuda.synchronize()
        print(json.dumps({"dense": paths["dense"]}), flush=True)
        criteo = os.path.join(tmp, "criteo.svm")
        write_criteo(criteo, CRITEO_ROWS, seed=12)
        paths["csr"] = drive_path(
            kernels, "csr", "coo_segment_sum", criteo, "csr",
            CRITEO_BATCH, CRITEO_DIM + 1, CRITEO_ROWS)
        torch.cuda.synchronize()
        print(json.dumps({"csr": paths["csr"]}), flush=True)

    # ---- 7. timings ----------------------------------------------------------
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    x, label, weight, w, b = main_args
    rows, features = x.shape
    fused_row = {
        "name": "fused_linear_grads", "route": "cuda",
        "source": "dmlc_tpu_torch/ops/csrc/fused_linear_grads.cu",
        "replaces": "dmlc_tpu/ops/pallas_kernels.py:108",
        "launches": paths["dense"]["launches"]["fused_linear_grads"],
        "max_abs_err": fused_err,
        "ms": time_ms(lambda: kernels.fused_linear_grads(
            x, label, weight, w, b, "logistic"), flush),
        "plain_ms": time_ms(lambda: kernels.fused_linear_grads_plain(
            x, label, weight, w, b, "logistic"), flush),
        "library_ms": None,
    }
    fused_row["bound_ms"], fused_row["bound_by"] = bound(
        4 * (rows * features + 2 * rows + 2 * features + 4),
        4 * rows * features)
    ids64 = row_ids.long()
    seg_row = {
        "name": "coo_segment_sum", "route": "cuda",
        "source": "dmlc_tpu_torch/ops/csrc/coo_segment_sum.cu",
        "replaces": "dmlc_tpu/ops/pallas_kernels.py:221",
        "launches": paths["csr"]["launches"]["coo_segment_sum"],
        "max_abs_err": seg_err,
        "ms": time_ms(lambda: kernels.coo_segment_sum(
            contrib, row_ids, CRITEO_BATCH), flush),
        "plain_ms": time_ms(lambda: kernels.coo_segment_sum_plain(
            contrib, row_ids, CRITEO_BATCH), flush),
        "library_ms": time_ms(lambda: torch.zeros(
            CRITEO_BATCH, device=dev).index_add_(0, ids64, contrib), flush),
    }
    seg_row["bound_ms"], seg_row["bound_by"] = bound(
        8 * entries + 4 * CRITEO_BATCH, entries)
    torch.cuda.synchronize()
    del flush

    # ---- 8. flash kernels vs plain -----------------------------------------
    for seed, case in enumerate(FLASH_CASES):
        report = flash_case(kernels, dev, *case, seed=40 + seed)
        print(json.dumps({"flash_vs_plain": report}), flush=True)
    torch.cuda.synchronize()

    # ---- 9. the long-context path --------------------------------------------
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            attention = drive_attention(kernels, dev, dist.group.WORLD)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    print(json.dumps({"attention": attention}), flush=True)

    # ---- 10. flash timings -----------------------------------------------------
    flash_rows, flash_extra = flash_timing_rows(
        kernels, dev, attention["path"]["launches"])
    torch.cuda.synchronize()
    print(json.dumps({"flash_timing_extra": flash_extra}), flush=True)

    # ---- 11./12. the tokenizer and the ingest path --------------------------
    with tempfile.TemporaryDirectory() as tmp:
        ingest_file = os.path.join(tmp, "criteo_ingest.svm")
        t0 = time.perf_counter()
        write_criteo(ingest_file, INGEST_ROWS, seed=13)
        write_seconds = time.perf_counter() - t0
        token_row, token_report = tokenizer_vs_plain(kernels, dev,
                                                     ingest_file)
        torch.cuda.synchronize()
        print(json.dumps({"tokenizer_vs_plain": token_report}), flush=True)
        ingest = drive_ingest(kernels, dev, ingest_file, tmp)
        ingest["write_seconds"] = write_seconds
        torch.cuda.synchronize()
    print(json.dumps({"ingest": ingest}), flush=True)
    token_row["launches"] = ingest["launches"]

    print(json.dumps({"paths": {
        k: {"steps": v["steps"], "seconds": v["seconds"],
            "steps_per_s": v["steps_per_s"], "rows_per_s": v["rows_per_s"],
            "feed_only_seconds": v["feed_only_seconds"],
            "chunk_parts": v["chunk_parts"],
            "tokenize_launches": v["tokenize_launches"]}
        for k, v in paths.items()}}))
    print(json.dumps({"attention_path_ms_per_step": {
        str(PATH_T): statistics.median(attention["path"]["step_ms"]),
        str(LONG_T): attention["long"]["step_ms"][0]}}))
    print(json.dumps({"ingest_mb_per_s": {
        "card": ingest["card_mb_per_s"], "cpu": ingest["cpu_mb_per_s"],
        "disk_cold": ingest["disk_cold"]["mb_per_s"],
        "disk_warm": ingest["disk_warm"]["mb_per_s"],
        "kernel_token_spans_seconds":
            ingest["kernel_token_spans"]["seconds"]}}))
    print(json.dumps({"seconds": time.perf_counter() - started}))
    print(json.dumps({"kernels": [fused_row, seg_row] + flash_rows
                      + [token_row]}))
    print("card:", card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

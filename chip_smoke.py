#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``dmlc_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one. With ``--times``
it only builds the kernels and prints one ``{"times": ...}`` line: each
kernel's cold-L2 CUDA-event time at the main path's shapes beside its
yardstick, and the launch floor (``launch_floor_ms``: one and two launches
of an empty kernel, timed the same way), to compare two checkouts in turns
on one card. Phases, each
ending in ``torch.cuda.synchronize()``; any failure ends the run with a
non-zero exit and no result line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``dmlc_tpu_torch/ops/csrc`` (nvcc, sm_90a)
   and print ptxas's registers and spills of each kernel; every flash
   kernel and ``fused_linear_grads`` must show 0 spill bytes;
3. ``fused_linear_grads`` against its plain PyTorch version on the card at
   [16384, 29] (HIGGS), a ragged [1000, 29] and a wide [4096, 2048]:
   integer-valued data with the squared and hinge objectives must match bit
   for bit (every sum is exact), float data with the logistic objective
   within ``FUSED_TOL``, rtol 1e-5 / atol 1e-6 (another summation order,
   and ``expf`` against torch's sigmoid); two runs, and a run on a second
   stream, must give the same bits. A known fault, the plain version
   without the last tile's rows (a partial row the kernel's cross-CTA sum
   lost), is read against ``FUSED_TOL`` at [1000, 29] and must fail it;
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
7. one call of ``fused_linear_grads`` must run exactly one kernel on the
   card and nothing else (no memset), counted from a CUDA graph captured
   around the call and, where CUPTI traces the card, under
   torch.profiler too; the launch floor (one and
   two launches of the empty kernel of ``csrc/launch_floor.cu``); per
   kernel: CUDA-event times (cold L2) of the kernel, its plain version and
   the one PyTorch call that computes the same function where there is
   one, beside the least time the card could take (``fused_linear_grads``'s
   row carries the floor as ``launch_floor_ms``);
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
   ``kernel_token_spans`` takes over all the file's chunks; then the MB/s
   of ``create_parser``'s ``PipelinedParser`` (chunks parsed whole on its
   worker threads) beside a ``ThreadedParser`` built directly over the
   same ``LibSVMParser`` (each chunk split over its pool): the same rows,
   one tokenizer launch a chunk part;
13. the distributed fit, over phases 5-6's files: world 1 over NCCL
   (``parallel.distributed.initialize``, ``LinearLearner(group=WORLD)``,
   the data-parallel step's ``bucketed_all_reduce``) must give phases
   5-6's bits, with one launch a step and a tokenizer launch a chunk part,
   and one step runs under torch.profiler (``step_device_ops``: what the
   NCCL all_reduce puts on the card); world 2 as two rank processes
   (``--fit-rank``) on the one card over gloo (NCCL refuses two ranks on
   one GPU), each reading its own byte range with 3/4 of phases 5-6's
   batch (``DIST_BATCH``): ``sync="spmd"`` and ``sync="host"`` (the port's
   ``RabitTracker`` and socket engine: the dense bucket takes the tree, the
   csr bucket the ring) on the card and ``sync="spmd"`` on the CPU. Both
   ranks must end with the same bits, the two card flavors with the same
   bits, within ``FIT_PARAM_REL`` of the CPU's; each rank launches its
   step's kernel once a step, as many steps as the other, and the
   tokenizer once a chunk part. World 2 over NCCL runs where a second card
   exists (else the report says it was skipped). Rows/s of each world and
   flavor; a rank that fails or hangs (``RANK_TIMEOUT_S``) fails the run.

14. GBDT on the card (``GBDTLearner``, ``GBDT_HYPER``: GBDTParam's
   defaults at HIGGS's 28 features, logistic, 20 trees of depth 6, 256
   bins): one squared-loss tree on integer labels equals the CPU route bit
   for bit (edges, features, bins, leaves); ``fit`` on 1,048,576 seeded
   rows twice gives the same bits (seconds a fit, ms a tree, rows·trees/s,
   peak device bytes); one level's histogram at depth 5 timed (CUDA
   events, cold L2) beside its byte bound, and one tree under
   torch.profiler (device ops, idle share); the card against the CPU route
   at 65,536 rows: loss history within rtol ``GBDT_LOSS_RTOL``,
   probabilities within a mean absolute ``GBDT_PRED_MEAN_ATOL``, the trees
   of equal structure counted; ``fit_uri`` over phase 5's HIGGS file with
   one tokenizer launch a chunk part (both passes); then world 2 on the one
   card over gloo (``--group-rank``), each rank fitting half of the rows
   with world 1's edges: the ranks bit-identical, their margins within
   ``GBDT_PRED_MEAN_ATOL`` (mean) of world 1's;
15. the rest of the data-parallel path: in the same world-2 processes the
   feature-sharded step at dp × mp = 1 × 2 and 2 × 1 (3 steps on a HIGGS
   batch) within ``MP_TOL`` of the data-parallel step on the same rows;
   the sharded SpMV of a Criteo batch in 4 sections, each through
   ``coo_segment_sum`` (4 launches), bit for bit against ``spmv``; and
   ``run_parity(world=2)`` (socket-engine ranks on the CPU, the single
   process on the card), which must pass its rtol criterion;
16. factorization machines (``FMLearner``, ``FM_HYPER``: FMParam's
   defaults, K = 8) at the csr path's width (2^20 + 1 features, batch
   8192) over phase 6's rows written as libfm (``write_libfm``) through
   ``DeviceFeed(create_parser(format libfm))``: (a) the column
   ``coo_segment_sum`` at [327,680, 17] (8192 rows) and at
   ``seg_sum_edge_cases`` with C in ``FM_SEG_COLS``, bit-equal to its
   plain version on integer data, each column bit-equal to the [E] call,
   the same bits twice; (b) ``feature_segment_sum`` at [E, 8] the same bits
   twice and under ``torch.use_deterministic_algorithms(True)``; (c) 2
   epochs on the card from params drawn once on the host: one
   ``coo_segment_sum`` launch a step, the loss falls by ``MIN_LOSS_FALL``,
   two fits give the same bits, the loss history within ``FM_LOSS_RTOL``
   of the CPU route's and w, b and v each within ``FM_PARAM_REL`` of its
   update; (d) known faults read against those limits, which must fail
   them: the margin without its −q term, the factor gradient without its
   −x·v self term; (e) rows/s, ms a step, peak device bytes, the feed's
   seconds with no step, and one step under torch.profiler (device ops,
   idle share); (f) CUDA-event times
   (cold L2) of the column kernel at [327,680, 17] beside its plain
   version, ``index_add_`` over [E, 17] and its byte bound;
17. snapshots and resume on the card: (a) the csr linear fit of phase 6's
   file (``fit_uri(snapshot_uri=...)``) and the FM fit of phase 16
   (``Snapshotter``), 3 epochs, a preemption notice injected at poll
   ``SNAP_NOTICE_POLL`` (mid-epoch 2) must raise ``Preempted`` with code 75
   after committing epoch 1; ``resume=True`` (linear) or ``start_epoch`` /
   ``history`` from ``load_snapshot`` (FM) must end bit-identical to an
   uninterrupted 3-epoch run on the card; (b) a child process
   (``--snap-rank SPEC``) fits the csr file for ``SIGNAL_EPOCHS`` epochs
   with snapshots armed and takes a SIGTERM once its first manifest has
   committed: it must still be running then, and exit with 75; relaunched
   with ``resume=True``, its saved model must equal an uninterrupted
   run's file byte for byte; (c) ``capture_ns`` (device → host on the
   training thread) and ``write_ns`` of the FM snapshots;
18. fault-tolerant distributed training on the card: rank processes
   (``--recover-rank SPEC``) started by the port's launcher (``python -m
   dmlc_tpu_torch.tracker.submit --cluster local --host-ip 127.0.0.1``)
   fit phase 6's csr file at phase 13's world-2 batch, ``LinearLearner(
   sync="host")`` over the socket engine, one epoch a round under
   ``collective.run_with_recovery`` for ``RECOVER_EPOCHS`` rounds, each
   round from the shared checkpoint (epoch, params, velocity, loss
   history) on part ``rank()`` of ``world_size()``; each rank prints its
   digest of (w, b), version, generation and launch counts. (a) ``-n 2``,
   no fault: the yardstick digest; (b) ``--max-attempts 2``, rank 1 exits
   hard as it starts round 2, is relaunched, the survivor recovers, both
   replay: the digests equal (a)'s, version 4 on both, the seconds from
   the crash to the replayed round and the relaunch's parts; (c)
   ``--elastic --spares 1``, rank 1 killed by the ``worker.step``
   faultpoint (``RECOVER_FAULTS``) outside the recovery before round 3,
   the warm spare called up: the digests equal (a)'s, the tracker's
   generation 2 with ``join`` and ``rebuild`` events, the spare's own
   launches; (d) world 2 on the device engine, ``sync="spmd"`` over gloo
   with CUDA tensors, each task in a relaunch loop exporting
   DMLC_TPU_COORDINATOR / DMLC_TPU_NUM_PROC / DMLC_TPU_PROC_ID: a clean
   run within ``FIT_PARAM_REL`` of (a)'s params, and a run where rank 0
   (which serves the store) crashes as it starts round 2 and rank 1 as
   it starts round 3 (the surviving rank 0 then serves the store again),
   whose digests must equal the clean run's; the route each survivor
   took (re-initialized in process, or the fail-stop exit 41 and a
   relaunch) is reported. Over NCCL only
   with a second card. In every job each process launches
   ``coo_segment_sum`` once a step and the tokenizer once a chunk part;
   (e) rows/s of (a) and the seconds of (b)-(d) against their clean runs;
19. expert-parallel MoE and the GPipe pipeline at Mixtral-8x7B's MoE
   widths (``MOE_*``: D 4096, expert hidden 14336, 8 experts, top-2; the
   reference's GELU FFN, not SwiGLU), weights and x drawn on the card:
   (a) ``make_moe_layer`` over a one-rank group, B 1, T 4096, capacity
   4096: forward and backward of sum(y²) + aux held against the
   per-expert ``moe_dense_oracle`` on the card, y, aux and every
   gradient by its relative norm error (``MOE_REL``), and both f32 routes'
   y read against a float64 oracle;
   ms a step (median of ``MOE_STEPS`` after a warm-up) beside the f32
   bound of its operations, peak device bytes, one step under
   torch.profiler (idle share), and the forward's router, dispatch and
   combine einsums and expert FFN timed alone; (b) the MoE-transformer
   block of ``dmlc_tpu_torch.examples.moe_transformer`` (causal ring
   attention with 32 query and 8 KV heads of 128, the MoE FFN, RMSNorm,
   residuals) at T 4096, forward, within the example's max|Δ| < 1e-3 of
   its single-rank block; (c) world 2 on the one card over gloo
   (``--moe-rank``): each rank's 4 experts and 2048 tokens, capacity
   2048, forward and backward held against (a)'s layer at one rank with
   world 2's loss (its aux the mean of the two halves'), the
   ``all_to_all`` timed alone; the 2-stage pipeline of
   tests/test_pipeline_parallel.py's ``_mlp_stage`` at D 4096, batch 4096
   in 8 microbatches, forward and gradients against ``pipeline_oracle``
   on the card (``MOE_REL``), ms a step and the bubble M / (M + N - 1).
   NCCL at world 2 needs a second card and is not run. No kernel of
   ``KERNELS`` is on this path (the reference computes it with XLA ops).

Phases 5 and 6 also require the tokenizer to launch once for each chunk
part of their fits on the card: the parser tokenizes on the learner's
device. The ``{"kernels": [...]}`` line has a row a kernel at its main
path's shape, and ``coo_segment_sum_fm``, the same kernel at FM's [E, 17]
(launches from phase 16's fit). Before the last lines come the ``moe``
and ``pipeline`` lines (phase 19); the last lines are the ``kernels``
line, the card line again, and ``{"ok": true, "device": {...}}``.
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
# fused_linear_grads on float data against its plain version: another
# summation order, and expf against torch's sigmoid
FUSED_TOL = dict(rtol=1e-5, atol=1e-6)
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
# phase 13 fits phases 5-6's files. At world 2 each rank's batch is 3/4 of
# theirs: each rank's half of a file then holds ~10.67 (dense) and ~5.33
# (csr) batches, so byte-range parts that differ by a few rows take the
# same 10 and 5 full steps an epoch (drop_remainder). A rank with a step
# more than the other would wait for ever in its extra allreduce.
DIST_BATCH = {"dense": HIGGS_BATCH * 3 // 4, "csr": CRITEO_BATCH * 3 // 4}
DIST_NF = {"dense": HIGGS_FEATURES + 1, "csr": CRITEO_DIM + 1}
DIST_ROWS = {"dense": HIGGS_ROWS, "csr": CRITEO_ROWS}
DIST_KERNEL = {"dense": "fused_linear_grads", "csr": "coo_segment_sum"}
# a world whose ranks have not all exited by then fails the run
RANK_TIMEOUT_S = 300


# phase 14: GBDTParam's defaults at HIGGS's width (28 features), the rows
# of a HIGGS-sized training set, the card against the CPU route at a size
# the CPU fits in seconds, and one level's histogram timed at depth 5
GBDT_HYPER = dict(objective="logistic", num_trees=20, max_depth=6,
                  num_bins=256, learning_rate=0.3)
GBDT_ROWS, GBDT_CPU_ROWS, GBDT_HIST_DEPTH = 1 << 20, 1 << 16, 5
# card vs CPU route at GBDT_CPU_ROWS, and world 2 vs world 1: torch's
# sigmoid on the card rounds differently from the host's by an ulp, and
# world 2 adds two half-sums where world 1 sums the rows serially, so a
# near-tie split can go the other way in a late tree. The loss history is
# held to rtol 1e-4; the predictions by their mean absolute difference,
# 1e-4 (a probability, a margin), with the largest difference and the
# trees of equal structure printed.
GBDT_LOSS_RTOL = 1e-4
GBDT_PRED_MEAN_ATOL = 1e-4
# phase 15: the feature-sharded step against the data-parallel step on a
# HIGGS batch (3 steps): another summation order of the partial margins
# and of gw, and lr·gw/wsum rounded where the other divides first
MP_STEPS = 3
MP_TOL = dict(rtol=1e-5, atol=1e-6)
SHARDED_SPMV_SECTIONS = 4
# phase 16: FM at FMParam's defaults over phase 6's rows written as libfm
# (the same seed: the same rows and planted rule), at the csr path's width
FM_HYPER = dict(objective="logistic", num_factors=8, init_scale=0.01,
                learning_rate=0.05)
FM_COLS = 2 * FM_HYPER["num_factors"] + 1  # [linear | x·v | (x·v)^2]
FM_SEG_COLS = (1, 3, FM_COLS)
# card vs CPU after 2 epochs, as the linear fits (FIT_LOSS_RTOL,
# FIT_PARAM_REL): the row and feature sums run in another order and the
# card's exp differs from the host's by an ulp. Params are read as the
# norm of the difference over the norm of the CPU fit's update (params -
# start), for each of w, b and v: v's random start would hide a fault in
# its gradient from a norm over the whole table.
FM_LOSS_RTOL = 1e-5
FM_PARAM_REL = 1e-5
# phase 17: 3 epochs of 8 steps, the notice injected at the 20th poll
# (epoch 2, step 4); the signalled child fits 8 epochs, so that it is
# still running when its first manifest commits
SNAP_EPOCHS = 3
SNAP_NOTICE_POLL = 2 * (CRITEO_ROWS // CRITEO_BATCH) + 4
SIGNAL_EPOCHS = 8
# phase 18: rounds of one epoch over phase 6's csr file at phase 13's
# world-2 batch; (b) and (d) crash a rank as it starts round 2, after two
# committed checkpoints, and (d) crashes the other rank as it starts round
# 3; (c) kills rank 1 as it starts round 3: rank r
# passes the worker.step faultpoint r + 1 times before each round, so its
# 8th pass is rank 1's before round 3 (and no other rank reaches 8)
RECOVER_EPOCHS = 4
RECOVER_CRASH_EPOCH = 2
RECOVER_FAULTS = "worker.step:nth=8"
# phase 19: Mixtral-8x7B's MoE widths (its public config.json:
# hidden_size 4096, intermediate_size 14336, num_local_experts 8,
# num_experts_per_tok 2; attention 32 query heads, 8 KV heads, head dim
# 128). Only the widths are taken: the experts are the reference's
# two-matrix GELU FFN, not SwiGLU. B = 1, T = 4096, capacity T (no token
# dropped), weights and x drawn on the card from MOE_SEED
MOE_D, MOE_H, MOE_E, MOE_K, MOE_T = 4096, 14336, 8, 2, 4096
MOE_HEADS, MOE_KV_HEADS = 32, 8
MOE_SEED, MOE_STEPS = 19, 3
# the layer against its per-expert oracle, world 2 against world 1, and
# the pipeline against its sequential fold: every tensor (y, aux, each
# gradient) by its relative 2-norm error, ‖got − want‖ / ‖want‖, held to
# FIT_PARAM_REL. The routing is exact and the products are f32 sums of
# 4096 and 14336 terms in another order. Elementwise limits set at the
# reference's toy widths do not describe that: the gate's gradient
# cancels (the two chosen experts' dp_k are sums of ~1e3), and on the CPU
# at D 1024 both f32 routes sit 1.8× tests/test_moe.py's gradient limit
# from a float64 oracle, while every tensor's relative norm error stays
# ~1e-6 at D 256-2048. A wrong slot, a dropped token or a gradient scaled
# by the world size reads O(1). Both f32 routes are also read against a
# float64 oracle (a measurement, not a check)
MOE_REL = FIT_PARAM_REL
# the 2-stage pipeline of tests/test_pipeline_parallel.py's _mlp_stage at
# D = 4096, batch 4096 in 8 microbatches
PIPE_D, PIPE_BATCH, PIPE_M, PIPE_STAGES = 4096, 4096, 8, 2


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


def criteo_rows(rows: int, seed: int):
    """Seeded Criteo-shaped rows in blocks of 8192: (labels, ids, values),
    39 sorted ids a row in [1, 2^20] and 4-digit values (the bench.py csr
    tier's widths). Ids are skewed as hashed categorical values are
    (1 + 2^20·u^8 for uniform u: ~42 % of entries fall on the 1024 hottest
    ids), and labels 0/1 come from a noisy sparse linear rule, so that two
    epochs can lower the loss."""
    rng = np.random.RandomState(seed)
    true_w = rng.randn(CRITEO_DIM + 1)
    for start in range(0, rows, 8192):
        n = min(8192, rows - start)
        ids = np.sort(1 + (rng.rand(n, CRITEO_NNZ) ** 8
                           * CRITEO_DIM).astype(np.int64), axis=1)
        vals = rng.rand(n, CRITEO_NNZ)
        margin = (vals * true_w[ids]).sum(axis=1)
        labels = (margin + 0.5 * rng.randn(n) > 0).astype(int)
        yield labels, ids, vals


def _write_rows(path: str, rows: int, seed: int, fmt: str) -> None:
    """:func:`criteo_rows` through ``fmt``, one ``%`` format over a float64
    row of (label, id, value, id, value, ...) a line (ids and labels are
    exact there)."""
    with open(path, "w") as fh:
        for labels, ids, vals in criteo_rows(rows, seed):
            table = np.empty((len(labels), 1 + 2 * CRITEO_NNZ))
            table[:, 0] = labels
            table[:, 1::2] = ids
            table[:, 2::2] = vals
            fh.write("\n".join(fmt % tuple(row) for row in table.tolist())
                     + "\n")


def write_criteo(path: str, rows: int, seed: int) -> None:
    """:func:`criteo_rows` as libsvm (``id:value``)."""
    _write_rows(path, rows, seed,
                "%d " + " ".join(["%d:%.4f"] * CRITEO_NNZ))


def write_libfm(path: str, rows: int, seed: int) -> None:
    """:func:`criteo_rows` as libfm (``field:id:value``), the field the
    id's position in its row (Criteo's 39 fields), for the FM path."""
    _write_rows(path, rows, seed, "%d " + " ".join(
        f"{j}:%d:%.4f" for j in range(CRITEO_NNZ)))


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


def launch_floor_ms(kernels, dev, flush: torch.Tensor) -> dict:
    """``time_ms`` of one and of two launches of an empty kernel
    (csrc/launch_floor.cu): the least time any kernel takes by that
    method, what a small kernel's time is read against."""
    return {"one": time_ms(lambda: kernels.empty_launches(1, dev), flush),
            "two": time_ms(lambda: kernels.empty_launches(2, dev), flush)}


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
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = kernels.fused_linear_grads(*args, objective=objective)
    want = kernels.fused_linear_grads_plain(*args, objective=objective)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) and torch.equal(a, o)
                for a, c, o in zip(got, again, other)),
            "fused_linear_grads %s [%d, %d]: two runs, or a run on a second "
            "stream, differ in bits", objective, rows, features)
    err = max(float((a - c).abs().max()) for a, c in zip(got, want))
    for a, c in zip(got, want):
        if integer:
            require(torch.equal(a, c),
                    "fused_linear_grads %s [%d, %d] integer data: kernel "
                    "and plain differ (max abs err %g)",
                    objective, rows, features, err)
        else:
            require(torch.allclose(a, c, **FUSED_TOL),
                    "fused_linear_grads %s [%d, %d]: kernel and plain "
                    "differ beyond rtol %g / atol %g (max abs err %g)",
                    objective, rows, features, FUSED_TOL["rtol"],
                    FUSED_TOL["atol"], err)
    return err, args


def read_lost_tile(kernels, args, objective="logistic") -> float:
    """Phase 3's known fault: the plain version without the rows of the
    last tile (a partial row the cross-CTA sum lost), read against
    FUSED_TOL beside the kernel's result, which must fail it. Returns the
    largest tolerance ratio over (gw, gb, loss_sum, weight_sum)."""
    x, label, weight, w, b = args
    keep = (x.shape[0] - 1) // kernels.FUSED_TILE_ROWS * kernels.FUSED_TILE_ROWS
    got = kernels.fused_linear_grads(*args, objective=objective)
    fault = kernels.fused_linear_grads_plain(
        x[:keep], label[:keep], weight[:keep], w, b, objective)
    ratio = max(tol_ratio(f, g, FUSED_TOL) for f, g in zip(fault, got))
    require(ratio > 1.0, "fused_linear_grads %s: the lost-tile fault reads "
            "%g, inside the limit", list(x.shape), ratio)
    return ratio


def device_ops(fn) -> dict:
    """{name: count} of the device operations (kernels, memsets, copies)
    that torch.profiler records for one call of ``fn``, after a warm-up
    call. Empty where CUPTI, through which the profiler sees the card,
    traced nothing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA}


#: CUgraphNodeType values (cuda.h) other than CU_GRAPH_NODE_TYPE_KERNEL (0)
GRAPH_NODE_KINDS = {1: "memcpy", 2: "memset", 3: "host", 4: "graph",
                    5: "empty", 6: "wait_event", 7: "event_record",
                    8: "ext_semaphore_signal", 9: "ext_semaphore_wait",
                    10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
                    13: "conditional"}


def graph_ops(fn) -> dict:
    """{name: count} of the device operations that one call of ``fn``
    enqueues, read from a CUDA graph captured around it through the
    driver API: each kernel node by its function's name, any other node
    by its kind ("memset", "memcpy", ...). A warm-up call on the capturing
    stream comes first, so that state a wrapper keeps per stream
    (``fused_linear_grads``'s arrival counter) exists before the capture.
    Needs no CUPTI, unlike :func:`device_ops`."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        rc = getattr(cu, name)(*args)
        require(rc == 0, "%s returned CUresult %d", name, rc)

    stream = torch.cuda.Stream()
    handle = ctypes.c_void_p(stream.cuda_stream)
    graph = ctypes.c_void_p()
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        call("cuStreamBeginCapture_v2", handle, ctypes.c_int(2))  # relaxed
        try:
            fn()
        finally:
            call("cuStreamEndCapture", handle, ctypes.byref(graph))
    ops = {}
    try:
        count = ctypes.c_size_t(0)
        call("cuGraphGetNodes", graph, None, ctypes.byref(count))
        nodes = (ctypes.c_void_p * count.value)()
        call("cuGraphGetNodes", graph, nodes, ctypes.byref(count))
        for node in nodes:
            node = ctypes.c_void_p(node)
            kind = ctypes.c_int(-1)
            call("cuGraphNodeGetType", node, ctypes.byref(kind))
            key = GRAPH_NODE_KINDS.get(kind.value, "node %d" % kind.value)
            if kind.value == 0:
                key = kernel_node_name(call, node)
            ops[key] = ops.get(key, 0) + 1
    finally:
        call("cuGraphDestroy", graph)
    return ops


def kernel_node_name(call, node) -> str:
    """The (mangled) function name of a kernel node of a CUDA graph."""
    import ctypes

    # CUDA_KERNEL_NODE_PARAMS_v2: CUfunction func at byte 0 and, where the
    # runtime launched a CUkernel instead, CUkernel kern at byte 56
    params = (ctypes.c_char * 128)()
    call("cuGraphKernelNodeGetParams_v2", node, params)
    func = ctypes.c_void_p.from_buffer(params, 0)
    name = ctypes.c_char_p()
    if func.value:
        call("cuFuncGetName", ctypes.byref(name), func)
    else:
        call("cuKernelGetName", ctypes.byref(name),
             ctypes.c_void_p.from_buffer(params, 56))
    return name.value.decode()


def one_call_ops(fn) -> dict:
    """The device operations of one call of ``fn``, counted twice: from a
    captured CUDA graph (``graph``, always) and by torch.profiler
    (``profiler``: the first of up to three tries that traced any device
    operation, or None where none did)."""
    traced = None
    for _ in range(3):
        traced = device_ops(fn) or None
        if traced:
            break
    return {"graph": graph_ops(fn), "profiler": traced}


def require_one_kernel(ops, what, kernel):
    """Every count of :func:`one_call_ops` (the profiler's where it traced
    anything) must be exactly one launch of ``kernel``, nothing else."""
    for source, counted in ops.items():
        if counted is None:
            continue
        require(list(counted.values()) == [1]
                and kernel in next(iter(counted)),
                "%s: one call ran %s on the card by the %s's count, not "
                "one %s", what, counted, source, kernel)


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
            learning_rate=0.1, group=None):
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    learner = LinearLearner(device=device, group=group, objective="logistic",
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
    }, params


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
    """One step of ``attention_steps`` under torch.profiler
    (:func:`profile_call`): each CUDA kernel's device milliseconds, their
    total, the step's host milliseconds (profiler on) and the device's idle
    share of them."""
    report = profile_call(lambda: attention_steps(fn, q, k, v, 1)[2][0])
    return {"step_ms": report["wall_ms"],
            "device_busy_ms": report["device_busy_ms"],
            "idle_share": report["idle_share"],
            "kernel_ms": report["kernel_ms"]}


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
    names = sorted(device_ops(fn))
    lower = " ".join(names).lower()
    backend = ("cudnn" if "cudnn" in lower else
               "flash" if "flash" in lower else
               "efficient" if ("fmha" in lower or "efficient" in lower
                               or "mem_eff" in lower) else
               "math" if names else "not traced")
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
    # create_parser's PipelinedParser (chunks parsed whole on its worker
    # threads) beside a ThreadedParser built directly over the same
    # LibSVMParser (each chunk split over its pool): the same rows, and one
    # tokenizer launch a non-empty chunk part either way
    from dmlc_tpu_torch.data import (LibSVMParser, PipelinedParser,
                                     RowBlockContainer, ThreadedParser,
                                     create_parser)
    from dmlc_tpu_torch.data.parsers import DEFAULT_NTHREAD
    from dmlc_tpu_torch.io import create_input_split

    makers = {
        "pipelined": lambda: create_parser(path, device=dev),
        "threaded": lambda: ThreadedParser(LibSVMParser(
            create_input_split(path, 0, 1), DEFAULT_NTHREAD, dev)),
    }
    result["parsers"] = {}
    for name, make in makers.items():
        kernels.reset_launch_counts()
        with count_parts() as parts:
            t0 = time.perf_counter()
            parser = make()
            cont = RowBlockContainer()
            try:
                for b in parser:
                    cont.push_block(b)
                whole = cont.to_block()
            finally:
                parser.close()
            seconds = time.perf_counter() - t0
        require(isinstance(parser, PipelinedParser) == (name == "pipelined"),
                "create_parser returned %s", type(parser).__name__)
        same_blocks("ingest through the %s parser" % name, whole, cpu)
        launches = kernels.tokenize_boundaries.launches
        require(launches == len(parts) > 0, "%s parser: %d tokenizer "
                "launches for %d chunk parts", name, launches, len(parts))
        result["parsers"][name] = {
            "seconds": seconds, "mb_per_s": nbytes / 1e6 / seconds,
            "launches": launches, "nthread": DEFAULT_NTHREAD}
        del whole, cont
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


# ---------------------------------------------------------------------------
# phase 13: the distributed fit
# ---------------------------------------------------------------------------


def fit_rank(rank: int, spec_path: str) -> int:
    """One rank of phase 13, run as ``chip_smoke.py --fit-rank RANK SPEC``
    by :func:`run_ranks`: join the process group the spec names, then for
    each flavor of ``spec["flavors"]`` ("spmd/card", "host/card",
    "spmd/cpu") fit the dense and the csr file on this rank's part, with
    the launch counts set to 0 just before each fit and read just after.
    Writes ``rank<r>.json`` (times, launches, losses) and ``rank<r>.npz``
    (params) beside the spec."""
    import torch.distributed as dist
    from dmlc_tpu_torch import collective
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy
    from dmlc_tpu_torch.ops import kernels
    from dmlc_tpu_torch.parallel import distributed

    with open(spec_path) as fh:
        spec = json.load(fh)
    world = spec["world"]
    dev = distributed.initialize(spec["init"], world, rank,
                                 backend=spec["backend"],
                                 device=spec["devices"][rank])
    report = {"device": str(dev), "backend": dist.get_backend()}
    arrays = {}
    try:
        for flavor in spec["flavors"]:
            sync, where = flavor.split("/")
            collective.finalize()
            if sync == "host":
                collective.init("socket", tracker_uri="127.0.0.1",
                                tracker_port=spec["tracker_port"],
                                rank=rank, world_size=world)
            else:
                collective.init()
            kind = "socket" if sync == "host" else "device"
            require(collective.engine_kind() == kind
                    and collective.rank() == rank
                    and collective.world_size() == world,
                    "rank %d: engine %s, rank %d of %d", rank,
                    collective.engine_kind(), collective.rank(),
                    collective.world_size())
            device = dev if where == "card" else torch.device("cpu")
            for layout in ("dense", "csr"):
                kernels.reset_launch_counts()
                with count_parts() as parts:
                    t0 = time.perf_counter()
                    learner = LinearLearner(
                        device=device, sync=sync, objective="logistic",
                        group=dist.group.WORLD if sync == "spmd" else None)
                    history = learner.fit_uri(
                        spec["files"][layout],
                        batch_size=DIST_BATCH[layout], epochs=EPOCHS,
                        layout=layout, num_features=DIST_NF[layout],
                        drop_remainder=True)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    seconds = time.perf_counter() - t0
                key = f"{flavor}/{layout}"
                report[key] = {
                    "seconds": seconds, "history": history,
                    "chunk_parts": len(parts),
                    "launches": {k: fn.launches
                                 for k, fn in kernels.KERNELS.items()}}
                for k, v in params_to_numpy(learner.params).items():
                    arrays[f"{key}/{k}"] = v
    finally:
        collective.finalize()
        distributed.shutdown()
    out = os.path.dirname(spec_path)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    return 0


def run_ranks(spec: dict, tmp: str, entry: str = "--fit-rank"):
    """Start one ``entry`` process (``--fit-rank`` or ``--group-rank``) a
    rank of ``spec`` and wait for all of them. A rank that exits non-zero, or a world that outlasts
    ``RANK_TIMEOUT_S`` (a rank waiting for ever in a collective), fails
    the run at once; every rank process is killed on the way out."""
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(spec["world"])]
    procs = []

    def tail(r):
        with open(os.path.join(tmp, f"rank{r}.log")) as fh:
            return fh.read()[-6000:]

    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), entry, str(r),
             spec_path], stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(spec["world"])]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                require(p.returncode in (None, 0), "%s: rank %d exited "
                        "with %s:\n%s", spec["name"], r, p.returncode,
                        tail(r))
            require(time.monotonic() < deadline, "%s: the ranks did not "
                    "finish in %d s", spec["name"], RANK_TIMEOUT_S)
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for fh in logs:
            fh.close()
    for r, p in enumerate(procs):
        require(p.returncode == 0, "%s: rank %d exited with %s:\n%s",
                spec["name"], r, p.returncode, tail(r))
    reports, arrays = [], []
    for r in range(spec["world"]):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            reports.append(json.load(fh))
        arrays.append(dict(np.load(os.path.join(tmp, f"rank{r}.npz"))))
    return reports, arrays


def hold_world(spec, reports, arrays) -> dict:
    """Phase 13's checks of one world: every rank ends each fit with rank
    0's bits; on the card each rank launched its step's kernel once a step,
    the same number of steps as the others, and the tokenizer once a chunk
    part; the CPU flavor launched nothing; the loss fell. Returns the
    report: per flavor and layout, each rank's seconds and launches and
    the world's rows/s (the rows all ranks stepped over the slowest rank's
    seconds)."""
    name = spec["name"]
    fits = {}
    for flavor in spec["flavors"]:
        fits[flavor] = {}
        for layout in ("dense", "csr"):
            key = f"{flavor}/{layout}"
            per_rank = [rep[key] for rep in reports]
            for r in range(1, len(reports)):
                for k in ("w", "b"):
                    require(arrays[r][f"{key}/{k}"].tobytes()
                            == arrays[0][f"{key}/{k}"].tobytes(),
                            "%s %s: rank %d's %s differs from rank 0's "
                            "bits", name, key, r, k)
            history = per_rank[0]["history"]
            require(np.all(np.isfinite(history))
                    and history[-1] < history[0] - MIN_LOSS_FALL,
                    "%s %s: loss history %s", name, key, history)
            steps = [rep["launches"][DIST_KERNEL[layout]]
                     for rep in per_rank]
            if flavor.endswith("/card"):
                require(steps[0] > 0 and len(set(steps)) == 1,
                        "%s %s: %s launches of %s by rank", name, key,
                        steps, DIST_KERNEL[layout])
                for r, rep in enumerate(per_rank):
                    require(rep["launches"]["tokenize_boundaries"]
                            == rep["chunk_parts"] > 0,
                            "%s %s: rank %d launched the tokenizer %d "
                            "times for %d chunk parts", name, key, r,
                            rep["launches"]["tokenize_boundaries"],
                            rep["chunk_parts"])
            else:
                require(not any(sum(rep["launches"].values())
                                for rep in per_rank),
                        "%s %s: the CPU route launched a kernel", name, key)
            fits[flavor][layout] = {
                "seconds": [rep["seconds"] for rep in per_rank],
                "launches": [{k: rep["launches"][k] for k in (
                    "fused_linear_grads", "coo_segment_sum",
                    "tokenize_boundaries")} for rep in per_rank],
                "chunk_parts": [rep["chunk_parts"] for rep in per_rank],
                "loss_history": history,
            }
    # the rows every rank stepped over (drop_remainder: full batches only),
    # counted from the card flavor's launches
    for layout in ("dense", "csr"):
        card = next(f for f in spec["flavors"] if f.endswith("/card"))
        rows = sum(r[DIST_KERNEL[layout]]
                   for r in fits[card][layout]["launches"]) \
            * DIST_BATCH[layout]
        for flavor in spec["flavors"]:
            fit = fits[flavor][layout]
            fit["rows"] = rows
            fit["rows_per_s"] = rows / max(fit["seconds"])
    return {"backend": reports[0]["backend"],
            "devices": [rep["device"] for rep in reports], "fits": fits}


def drive_distributed(kernels, dev, files, single) -> dict:
    """Phase 13: the fits of phases 5-6 through the collective layer.
    World 1 over NCCL must give phase 5-6's bits; world 2 runs two rank
    processes on the card over gloo (NCCL refuses two ranks on one GPU),
    data-parallel and hostsync (the port's tracker and socket engine),
    and on the CPU; world 2 over NCCL runs where a second card exists."""
    import torch.distributed as dist
    from dmlc_tpu_torch import collective
    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import (init_linear_params,
                                       make_linear_train_step, step_batch)
    from dmlc_tpu_torch.parallel import distributed
    from dmlc_tpu_torch.tracker import RabitTracker

    out = {}
    # world 1 over NCCL: phases 5-6's fits, with the data-parallel step's
    # all_reduce over one card
    fits = {}
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(f"file://{tmp}/pg", 1, 0, device=dev)
        try:
            require(dist.get_backend() == "nccl", "world 1 runs over %s",
                    dist.get_backend())
            # NCCL builds its communicator at the first collective: timed
            # alone, so that the fits read the steps
            t0 = time.perf_counter()
            dist.all_reduce(torch.zeros(1, device=dev))
            torch.cuda.synchronize()
            first_all_reduce_s = time.perf_counter() - t0
            for layout, batch in (("dense", HIGGS_BATCH),
                                  ("csr", CRITEO_BATCH)):
                kernels.reset_launch_counts()
                with count_parts() as parts:
                    history, params, seconds = run_fit(
                        files[layout], layout, batch, DIST_NF[layout], dev,
                        group=dist.group.WORLD)
                launches = {k: fn.launches
                            for k, fn in kernels.KERNELS.items()}
                steps = EPOCHS * (-(-DIST_ROWS[layout] // batch))
                require(launches[DIST_KERNEL[layout]] == steps,
                        "world 1 %s: %s launched %d times for %d steps",
                        layout, DIST_KERNEL[layout],
                        launches[DIST_KERNEL[layout]], steps)
                require(launches["tokenize_boundaries"] == len(parts) > 0,
                        "world 1 %s: %d tokenizer launches for %d chunk "
                        "parts", layout, launches["tokenize_boundaries"],
                        len(parts))
                for k in ("w", "b"):
                    require(params[k].tobytes() == single[layout][k].tobytes(),
                            "world 1 over NCCL, %s: %s differs from the "
                            "single-device fit's bits", layout, k)
                fits[layout] = {
                    "seconds": seconds, "steps": steps,
                    "rows_per_s": EPOCHS * DIST_ROWS[layout] / seconds,
                    "launches": launches, "chunk_parts": len(parts),
                    "loss_history": history,
                    "bits_equal_single_device": True}
            # what one data-parallel step runs on the card, the NCCL
            # all_reduce included
            feed = DeviceFeed(create_parser(files["dense"], device=dev),
                              BatchSpec(batch_size=HIGGS_BATCH,
                                        num_features=DIST_NF["dense"]),
                              device=dev)
            try:
                batch = step_batch(next(iter(feed)), "dense")
            finally:
                feed.close()
            step = make_linear_train_step(
                dist.group.WORLD, layout="dense",
                num_features=DIST_NF["dense"])
            params = init_linear_params(DIST_NF["dense"], dev)
            velocity = {k: torch.zeros_like(v) for k, v in params.items()}
            ops = device_ops(lambda: step(params, velocity, batch))
            if not ops:
                print("torch.profiler traced no device operation of the "
                      "world-1 NCCL step", file=sys.stderr, flush=True)
            # and the step's all_reduce alone, on its 32-float bucket
            bucket = torch.zeros(DIST_NF["dense"] + 3, device=dev)
            reduce_ops = device_ops(lambda: dist.all_reduce(bucket))
        finally:
            collective.finalize()
            distributed.shutdown()
    out["world1_nccl"] = {"backend": "nccl", "devices": [str(dev)],
                          "fits": {"spmd/card": fits},
                          "first_all_reduce_seconds": first_all_reduce_s,
                          "step_device_ops": ops or "not traced",
                          "all_reduce_device_ops": reduce_ops or "none"}
    print(json.dumps({"distributed_world1_nccl": out["world1_nccl"]}),
          flush=True)

    # world 2 on the one card over gloo: data-parallel, hostsync, and the
    # data-parallel fit on the CPU as the reference
    tracker = RabitTracker("127.0.0.1", 2, port=9091, port_end=9999)
    tracker.start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            spec = {"name": "world2_gloo", "world": 2,
                    "init": f"file://{tmp}/pg", "backend": "gloo",
                    "devices": [str(dev)] * 2, "files": files,
                    "flavors": ["spmd/card", "host/card", "spmd/cpu"],
                    "tracker_port": tracker.port}
            reports, arrays = run_ranks(spec, tmp)
        tracker.thread.join(30)
        require(not tracker.alive(), "world2_gloo: the tracker still waits "
                "for shutdowns")
    finally:
        tracker.close()
    world2 = hold_world(spec, reports, arrays)
    for layout in ("dense", "csr"):
        spmd = {k: arrays[0][f"spmd/card/{layout}/{k}"] for k in ("w", "b")}
        for k in ("w", "b"):
            require(spmd[k].tobytes()
                    == arrays[0][f"host/card/{layout}/{k}"].tobytes(),
                    "world 2 %s: the spmd and host flavors differ in %s",
                    layout, k)
        cpu = {k: arrays[0][f"spmd/cpu/{layout}/{k}"] for k in ("w", "b")}
        rel = param_rel_err(spmd, cpu)
        require(rel <= FIT_PARAM_REL, "world 2 %s: params differ from the "
                "CPU's by %g relative (limit %g)", layout, rel,
                FIT_PARAM_REL)
        world2["fits"]["spmd/card"][layout]["param_rel_err_vs_cpu"] = rel
        world2["fits"]["host/card"][layout]["bits_equal_spmd"] = True
    out["world2_gloo"] = world2
    print(json.dumps({"distributed_world2_gloo": world2}), flush=True)

    # world 2 over NCCL needs a card a rank
    if torch.cuda.device_count() < 2:
        out["world2_nccl"] = ("skipped: %d card (NCCL refuses two ranks on "
                              "one GPU)" % torch.cuda.device_count())
    else:
        with tempfile.TemporaryDirectory() as tmp:
            spec = {"name": "world2_nccl", "world": 2,
                    "init": f"file://{tmp}/pg", "backend": "nccl",
                    "devices": ["cuda:0", "cuda:1"], "files": files,
                    "flavors": ["spmd/card"], "tracker_port": 0}
            reports, nccl_arrays = run_ranks(spec, tmp)
        out["world2_nccl"] = hold_world(spec, reports, nccl_arrays)
        for layout in ("dense", "csr"):
            for k in ("w", "b"):
                key = f"spmd/card/{layout}/{k}"
                require(nccl_arrays[0][key].tobytes()
                        == arrays[0][key].tobytes(), "world 2 %s: NCCL and "
                        "gloo differ in %s", layout, k)
    print(json.dumps({"distributed_world2_nccl": out["world2_nccl"]}),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 14-15: GBDT on the card, the rest of the data-parallel path
# ---------------------------------------------------------------------------


def gbdt_data(rows: int, seed: int):
    """HIGGS-shaped rows in memory by ``write_higgs``'s rule: 28 standard
    normal features, labels 0/1 from a noisy linear rule."""
    rng = np.random.RandomState(seed)
    true_w = rng.randn(HIGGS_FEATURES)
    x = rng.randn(rows, HIGGS_FEATURES).astype(np.float32)
    y = (x @ true_w + rng.randn(rows) > 0).astype(np.float32)
    return x, y


def gbdt_fit(x, y, device, group=None, edges=None, **hyper):
    """(learner, history, seconds) of one ``GBDTLearner.fit``."""
    from dmlc_tpu_torch.models import GBDTLearner

    learner = GBDTLearner(device=device, group=group,
                          **dict(GBDT_HYPER, **hyper))
    t0 = time.perf_counter()
    history = learner.fit(x, y, edges=edges)
    if learner.device.type == "cuda":
        torch.cuda.synchronize()
    return learner, history, time.perf_counter() - t0


def tree_bits(learner) -> dict:
    return {k: v.cpu().numpy() for k, v in learner.trees.items()}


def same_structure(a: dict, b: dict) -> int:
    """The number of trees whose features and bins agree."""
    return int(sum(np.array_equal(a["feature"][t], b["feature"][t])
                   and np.array_equal(a["bin"][t], b["bin"][t])
                   for t in range(a["feature"].shape[0])))


def hold_close(where, got, want, mean_atol) -> dict:
    """Mean and largest absolute difference; the mean within the limit."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    report = {"mean_abs_diff": float(diff.mean()),
              "max_abs_diff": float(diff.max())}
    require(np.all(np.isfinite(got)) and report["mean_abs_diff"] <= mean_atol,
            "%s: %s (limit %g)", where, report, mean_atol)
    return report


def profile_call(run) -> dict:
    """One ``run()`` (which returns its host milliseconds) under
    torch.profiler: each CUDA kernel's device milliseconds (by name,
    summed; the 8 largest), their total and the device's idle share of the
    host time. No kernel traced means CUPTI saw nothing: busy and idle are
    then None, not a card that idled."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run()
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy if top else None,
            "idle_share": 1.0 - busy / wall_ms if top else None,
            "kernel_count": len(kernel_ms), "kernel_ms": top}


def group_rank(rank: int, spec_path: str) -> int:
    """One rank of phases 14-15's world 2, run as ``chip_smoke.py
    --group-rank RANK SPEC`` by :func:`run_ranks` (gloo on the one card):
    the GBDT fit of this rank's half of phase 14's rows with the shared
    edges, then the feature-sharded step at dp × mp = 1 × 2 and 2 × 1 beside
    the data-parallel step on the same rows. Writes ``rank<r>.json`` and
    ``rank<r>.npz`` beside the spec."""
    import torch.distributed as dist
    from dmlc_tpu_torch.models import (feature_shard, init_linear_params,
                                       make_feature_sharded_train_step,
                                       make_linear_train_step)
    from dmlc_tpu_torch.parallel import distributed

    with open(spec_path) as fh:
        spec = json.load(fh)
    out = os.path.dirname(spec_path)
    world = spec["world"]
    dev = distributed.initialize(spec["init"], world, rank,
                                 backend=spec["backend"],
                                 device=spec["devices"][rank])
    arrays = {}
    try:
        x, y = gbdt_data(GBDT_ROWS, spec["seed"])
        half = slice(rank * GBDT_ROWS // world,
                     (rank + 1) * GBDT_ROWS // world)
        edges = np.load(os.path.join(out, "edges.npy"))
        learner, history, seconds = gbdt_fit(
            x[half], y[half], dev, group=dist.group.WORLD, edges=edges)
        for k, v in tree_bits(learner).items():
            arrays[f"gbdt/{k}"] = v
        arrays["gbdt/margin"] = learner.predict_margin(x[:GBDT_CPU_ROWS])
        report = {"gbdt": {"seconds": seconds, "history": history,
                           "rows": half.stop - half.start}}
        # the feature-sharded step: 1 × 2 (each rank all rows, half of w)
        # and 2 × 1 (half the rows, all of w), each beside the
        # data-parallel step on the same rows
        nf = HIGGS_FEATURES
        xs = torch.tensor(x[:HIGGS_BATCH], device=dev)
        ys = torch.tensor(y[:HIGGS_BATCH], device=dev)
        ws = torch.ones(HIGGS_BATCH, device=dev)
        for dp, mp in ((1, 2), (2, 1)):
            rows = slice(rank * HIGGS_BATCH // dp if dp > 1 else 0,
                         (rank + 1) * HIGGS_BATCH // dp if dp > 1
                         else HIGGS_BATCH)
            j = rank if mp > 1 else 0
            step = make_feature_sharded_train_step(
                dist.group.WORLD if dp > 1 else None,
                dist.group.WORLD if mp > 1 else None, learning_rate=0.5)
            dp_step = make_linear_train_step(
                dist.group.WORLD if dp > 1 else None, learning_rate=0.5,
                num_features=nf)
            params = init_linear_params(nf, dev)
            velocity = {k: torch.zeros_like(v) for k, v in params.items()}
            ref = {k: v.clone() for k, v in params.items()}
            shard = {"w": feature_shard(params["w"], j, mp),
                     "b": params["b"]}
            x_rows = feature_shard(xs[rows], j, mp).contiguous()
            for _ in range(MP_STEPS):
                shard, metrics = step(shard, x_rows, ys[rows], ws[rows])
                ref, velocity, _ = dp_step(ref, velocity, {
                    "x": xs[rows], "label": ys[rows], "weight": ws[rows]})
            key = f"mp/{dp}x{mp}"
            arrays[f"{key}/w"] = shard["w"].cpu().numpy()
            arrays[f"{key}/b"] = shard["b"].cpu().numpy()
            arrays[f"{key}/dp_w"] = feature_shard(ref["w"], j, mp).cpu() \
                .numpy()
            arrays[f"{key}/dp_b"] = ref["b"].cpu().numpy()
            arrays[f"{key}/loss_sum"] = metrics["loss_sum"].cpu().numpy()
    finally:
        distributed.shutdown()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    return 0


def drive_gbdt(kernels, dev, higgs_file) -> dict:
    """Phase 14: GBDT on the card (the module docstring)."""
    from dmlc_tpu_torch.models import gbdt

    out = {"hyper": GBDT_HYPER, "rows": GBDT_ROWS}
    x, y = gbdt_data(GBDT_ROWS, seed=14)
    # one squared-loss tree on integer labels: the card's bits are the CPU
    # route's (integer (g, h): every sum exact)
    xs = x[:GBDT_CPU_ROWS]
    yi = np.random.RandomState(15).randint(-3, 4, GBDT_CPU_ROWS).astype(
        np.float32)
    one = dict(objective="squared", num_trees=1)
    card, _, _ = gbdt_fit(xs, yi, dev, **one)
    cpu, _, _ = gbdt_fit(xs, yi, "cpu", **one)
    require(card.edges.tobytes() == cpu.edges.tobytes(),
            "GBDT edges: the card's quantiles differ from numpy's")
    a, b = tree_bits(card), tree_bits(cpu)
    for k in ("feature", "bin", "leaf"):
        require(a[k].tobytes() == b[k].tobytes(),
                "GBDT squared tree on integer labels: card and CPU differ "
                "in %s", k)
    out["squared_tree_bits_equal_cpu"] = True

    # (a) the fit at full rows, twice: the same bits
    torch.cuda.reset_peak_memory_stats(dev)
    first, history, seconds = gbdt_fit(x, y, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    again, history2, seconds2 = gbdt_fit(x, y, dev)
    a, b = tree_bits(first), tree_bits(again)
    for k in a:
        require(a[k].tobytes() == b[k].tobytes(),
                "GBDT fit twice on the card: %s differs", k)
    require(history == history2, "GBDT fit twice: loss histories differ")
    require(np.all(np.isfinite(history)) and history[-1] < history[0]
            - MIN_LOSS_FALL, "GBDT fit: loss history %s", history)
    trees = GBDT_HYPER["num_trees"]
    out["fit"] = {
        "seconds": [seconds, seconds2], "ms_per_tree":
        [1e3 * s / trees for s in (seconds, seconds2)],
        "rows_trees_per_s": [GBDT_ROWS * trees / s
                             for s in (seconds, seconds2)],
        "peak_device_bytes": peak, "loss_history": history,
        "same_bits_twice": True}

    # one level's histogram at depth 5 and one tree under torch.profiler
    xb = gbdt.apply_bins(torch.tensor(x, device=dev), first.edges)
    gen = torch.Generator(device=dev).manual_seed(5)
    nodes = 1 << GBDT_HIST_DEPTH
    node = torch.randint(0, nodes, (GBDT_ROWS,), generator=gen,
                         device=dev, dtype=torch.int32)
    g = torch.randn(GBDT_ROWS, generator=gen, device=dev)
    h = torch.rand(GBDT_ROWS, generator=gen, device=dev)
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    hist_ms = time_ms(lambda: gbdt._level_histogram(
        xb, node, g, h, nodes, GBDT_HYPER["num_bins"]), flush, 10)
    del flush
    entries = GBDT_ROWS * HIGGS_FEATURES
    bound_ms, bound_by = bound(entries * (4 + 8), 2 * entries)
    out["level_histogram"] = {
        "depth": GBDT_HIST_DEPTH, "entries": entries, "ms": hist_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_counts": "a 4-byte key and an 8-byte (g, h) value an entry"}
    build = gbdt.make_tree_builder(GBDT_HYPER["max_depth"],
                                   GBDT_HYPER["num_bins"], 1.0, 1.0)

    def one_tree():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build(xb, g, h)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    one_tree()
    out["tree_profile"] = profile_call(one_tree)
    del xb, node, g, h
    print(json.dumps({"gbdt_fit": out}), flush=True)

    # the card against the CPU route at GBDT_CPU_ROWS
    ys = y[:GBDT_CPU_ROWS]
    card, card_hist, card_s = gbdt_fit(xs, ys, dev)
    cpu, cpu_hist, cpu_s = gbdt_fit(xs, ys, "cpu")
    np.testing.assert_allclose(card_hist, cpu_hist, rtol=GBDT_LOSS_RTOL)
    out["card_vs_cpu"] = {
        "rows": GBDT_CPU_ROWS, "card_seconds": card_s, "cpu_seconds": cpu_s,
        "loss_max_rel_diff": float(np.max(np.abs(
            np.array(card_hist) - cpu_hist) / np.abs(cpu_hist))),
        "trees_same_structure": same_structure(tree_bits(card),
                                               tree_bits(cpu)),
        "predict": hold_close("GBDT card vs CPU predictions",
                              card.predict(xs), cpu.predict(xs),
                              GBDT_PRED_MEAN_ATOL)}

    # (b) fit_uri over phase 5's HIGGS file, tokenized on the card
    kernels.reset_launch_counts()
    with count_parts() as parts:
        learner = gbdt.GBDTLearner(device=dev, **GBDT_HYPER)
        t0 = time.perf_counter()
        uri_hist = learner.fit_uri(higgs_file, HIGGS_FEATURES + 1)
        torch.cuda.synchronize()
        uri_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    require(launches["tokenize_boundaries"] == len(parts) > 0,
            "GBDT fit_uri: %d tokenizer launches for %d chunk parts",
            launches["tokenize_boundaries"], len(parts))
    require(np.all(np.isfinite(uri_hist))
            and uri_hist[-1] < uri_hist[0] - MIN_LOSS_FALL,
            "GBDT fit_uri: loss history %s", uri_hist)
    out["fit_uri"] = {"rows": HIGGS_ROWS, "seconds": uri_s,
                      "chunk_parts": len(parts), "launches": launches,
                      "loss_history": uri_hist}
    out["edges"] = first.edges
    out["world1_margin"] = first.predict_margin(xs)
    return out


def drive_group(gbdt_out) -> dict:
    """Phases 14 (c) and 15's group runs: world 2 on the one card over
    gloo (:func:`group_rank`). The ranks' GBDT models must be bit-identical
    and within ``GBDT_PRED_MEAN_ATOL`` of world 1's margins; the
    feature-sharded steps within ``MP_TOL`` of the data-parallel step."""
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "edges.npy"), gbdt_out["edges"])
        spec = {"name": "group_world2", "world": 2,
                "init": f"file://{tmp}/pg", "backend": "gloo",
                "devices": ["cuda:0"] * 2, "seed": 14}
        reports, arrays = run_ranks(spec, tmp, "--group-rank")
    for k in ("feature", "bin", "gain", "leaf", "margin"):
        require(arrays[1][f"gbdt/{k}"].tobytes()
                == arrays[0][f"gbdt/{k}"].tobytes(),
                "GBDT world 2: rank 1's %s differs from rank 0's", k)
    history = reports[0]["gbdt"]["history"]
    require(history == reports[1]["gbdt"]["history"],
            "GBDT world 2: the ranks' loss histories differ")
    seconds = max(r["gbdt"]["seconds"] for r in reports)
    trees = GBDT_HYPER["num_trees"]
    gbdt_report = {
        "seconds": [r["gbdt"]["seconds"] for r in reports],
        "rows_trees_per_s": GBDT_ROWS * trees / seconds,
        "loss_history": history, "ranks_bit_identical": True,
        "margin_vs_world1": hold_close(
            "GBDT world 2 vs world 1 margins", arrays[0]["gbdt/margin"],
            gbdt_out["world1_margin"], GBDT_PRED_MEAN_ATOL)}
    mp_report = {}
    for key in ("mp/1x2", "mp/2x1"):
        errs = {}
        for r in range(2):
            for k in ("w", "b"):
                got, want = arrays[r][f"{key}/{k}"], arrays[r][
                    f"{key}/dp_{k}"]
                require(np.allclose(got, want, **MP_TOL),
                        "%s rank %d: %s differs from the data-parallel "
                        "step's beyond %s", key, r, k, MP_TOL)
                errs[f"rank{r}/{k}"] = float(np.max(np.abs(got - want)))
        mp_report[key] = {"max_abs_err_vs_dp_step": errs,
                          "loss_sum": float(arrays[0][f"{key}/loss_sum"])}
    return {"gbdt_world2_gloo": gbdt_report, "feature_sharded": mp_report}


def drive_sharded(kernels, dev) -> dict:
    """Phase 15 on one process: the sharded SpMV against ``spmv`` on the
    same Criteo batch, each of its sections through ``coo_segment_sum``;
    then ``run_parity(world=2)`` with the single process on the card."""
    from dmlc_tpu_torch.data.row_block import RowBlock
    from dmlc_tpu_torch.device.csr import pad_to_bucket_sharded
    from dmlc_tpu_torch.ops.spmv import make_sharded_spmv, spmv
    from dmlc_tpu_torch.tools.parity import run_parity

    rng = np.random.RandomState(16)
    counts = np.full(CRITEO_BATCH, CRITEO_NNZ)
    counts[-100:] = 0  # a short batch: the last rows padded
    offset = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(offset[-1])
    block = RowBlock(offset=offset, label=np.zeros(CRITEO_BATCH, np.float32),
                     index=rng.randint(1, CRITEO_DIM + 1, nnz).astype(
                         np.uint32),
                     value=rng.randint(-3, 4, nnz).astype(np.float32))
    w = torch.tensor(rng.randint(-2, 3, CRITEO_DIM + 1).astype(np.float32),
                     device=dev)
    rows = torch.tensor(np.repeat(np.arange(CRITEO_BATCH), counts),
                        device=dev)
    want = spmv(torch.tensor(block.value, device=dev),
                torch.tensor(block.index.astype(np.int32), device=dev),
                rows, w, CRITEO_BATCH)
    batch = pad_to_bucket_sharded(block, CRITEO_BATCH, SHARDED_SPMV_SECTIONS)
    local = make_sharded_spmv(CRITEO_BATCH // SHARDED_SPMV_SECTIONS)
    sections = [{k: torch.tensor(v, device=dev) for k, v in
                 batch.section(s).items()}
                for s in range(SHARDED_SPMV_SECTIONS)]
    kernels.reset_launch_counts()
    got = torch.cat([local(sec["values"], sec["indices"], sec["offsets"], w)
                     for sec in sections])
    torch.cuda.synchronize()
    launches = kernels.KERNELS["coo_segment_sum"].launches
    require(launches == SHARDED_SPMV_SECTIONS,
            "sharded spmv: coo_segment_sum launched %d times for %d "
            "sections", launches, SHARDED_SPMV_SECTIONS)
    require(torch.equal(got, want),
            "sharded spmv: the sections' rows differ from spmv's")
    report = {"sharded_spmv": {
        "sections": SHARDED_SPMV_SECTIONS, "nnz_bucket": batch.nnz_bucket,
        "coo_segment_sum_launches": launches, "bits_equal_spmv": True}}
    t0 = time.perf_counter()
    parity = run_parity(world=2)
    report["parity"] = dict(parity, seconds=time.perf_counter() - t0)
    require(parity["single_backend"] == "cuda" and parity["pass"],
            "run_parity(world=2) on the card failed: %s", parity)
    return report


# ---------------------------------------------------------------------------
# phases 16-17: factorization machines, snapshots and resume
# ---------------------------------------------------------------------------


def hold_seg_sum_cols(kernels, dev, name, row_ids, num_rows, cols):
    """The column ``coo_segment_sum`` on ``row_ids`` with seeded integer
    contributions [E, cols]: bit-equal to the plain version, each column
    bit-equal to the [E] call on it, the same bits twice."""
    rng = np.random.RandomState(len(row_ids) + num_rows + cols)
    contrib = torch.tensor(rng.randint(-5, 6, (len(row_ids), cols)).astype(
        np.float32), device=dev)
    ids = torch.tensor(row_ids, device=dev)
    got = kernels.coo_segment_sum(contrib, ids, num_rows)
    again = kernels.coo_segment_sum(contrib, ids, num_rows)
    want = kernels.coo_segment_sum_plain(contrib, ids, num_rows)
    columns = [kernels.coo_segment_sum(contrib[:, c].contiguous(), ids,
                                       num_rows) for c in range(cols)]
    torch.cuda.synchronize()
    require(got.shape == (num_rows, cols), "coo_segment_sum %s [E, %d]: "
            "shape %s", name, cols, tuple(got.shape))
    require(torch.equal(got, want), "coo_segment_sum %s [E, %d]: kernel "
            "and plain differ", name, cols)
    require(torch.equal(got, again), "coo_segment_sum %s [E, %d]: two "
            "runs differ", name, cols)
    for c, col in enumerate(columns):
        require(torch.equal(got[:, c], col), "coo_segment_sum %s: column "
                "%d of [E, %d] differs from the [E] call", name, c, cols)


def fm_learner(device, start):
    """An ``FMLearner`` with ``FM_HYPER`` at the csr path's width, from the
    params ``start`` (numpy)."""
    from dmlc_tpu_torch.models import FMLearner, fm_params_from_numpy

    learner = FMLearner(device=device, num_features=CRITEO_DIM + 1,
                        **FM_HYPER)
    learner.params = fm_params_from_numpy(start, learner.device)
    return learner


def fm_feed(path, device):
    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed

    return DeviceFeed(
        create_parser(path, data_format="libfm", device=device),
        BatchSpec(batch_size=CRITEO_BATCH, layout="csr",
                  num_features=CRITEO_DIM + 1), device=device)


def run_fm_fit(path, device, start, epochs=EPOCHS, learner=None, **fit):
    """(history, params as numpy, seconds) of ``FMLearner.fit_feed`` over
    the libfm file ``path``; ``fit`` passes the snapshot arguments."""
    from dmlc_tpu_torch.models import fm_params_to_numpy

    learner = learner or fm_learner(device, start)
    feed = fm_feed(path, device)
    t0 = time.perf_counter()
    try:
        history = learner.fit_feed(feed, epochs, **fit)
        if device != "cpu":
            torch.cuda.synchronize()
    finally:
        feed.close()
    return history, fm_params_to_numpy(learner.params), \
        time.perf_counter() - t0


def fm_update_rel_err(params, ref, start) -> float:
    """The largest over w, b and v of |params - ref| / |ref - start|: the
    difference read against the reference fit's update (v's random start
    would otherwise hide a fault in its gradient)."""
    worst = 0.0
    for k in ("w", "b", "v"):
        p, r, s = (np.asarray(a[k], np.float64) for a in (params, ref, start))
        worst = max(worst, float(np.linalg.norm(p - r)
                                 / np.linalg.norm(r - s)))
    return worst


@contextlib.contextmanager
def fm_fault(kind: str):
    """Run the block with a known fault in FM's forward: ``"no_q"`` leaves
    the −q term out of the margin; ``"no_self"`` drops the −x·v self term
    from the factor gradient (the per-entry x·v the margin hands back is
    only read there)."""
    from dmlc_tpu_torch.models import fm
    from dmlc_tpu_torch.ops.kernels import coo_segment_sum_plain

    real = fm._fm_margin

    def faulty(params, values, indices, row_ids, num_rows):
        margin, s, xv = real(params, values, indices, row_ids, num_rows)
        if kind == "no_q":
            q = coo_segment_sum_plain(xv * xv, row_ids, num_rows)
            return margin + 0.5 * torch.sum(q, dim=-1), s, xv
        return margin, s, torch.zeros_like(xv)

    fm._fm_margin = faulty
    try:
        yield
    finally:
        fm._fm_margin = real


def drive_fm(kernels, dev, fm_file) -> tuple:
    """Phase 16 (the module docstring); returns (report, kernel row, the
    fits' initial params as numpy)."""
    from dmlc_tpu_torch.models import (fm_params_from_numpy,
                                       fm_params_to_numpy, init_fm_params,
                                       make_fm_train_step, step_batch)
    from dmlc_tpu_torch.ops.spmv import expand_row_ids, feature_segment_sum

    report = {}
    # (a) the column kernel against its plain version
    batch = criteo_batch(dev, 3)
    entries = batch["values"].shape[0]
    row_ids = expand_row_ids(batch["offsets"], entries)
    hold_seg_sum_cols(kernels, dev, "criteo batch", row_ids.cpu().numpy(),
                      CRITEO_BATCH, FM_COLS)
    for name, ids, num_rows in seg_sum_edge_cases():
        for cols in FM_SEG_COLS:
            hold_seg_sum_cols(kernels, dev, name, ids, num_rows, cols)
    # FM's scale (phase 4's): values in [0, 1) times 0.1·N(0, 1), 0 in the
    # padded tail
    rng = np.random.RandomState(16)
    packed = batch["values"][:, None] * torch.tensor(
        0.1 * rng.randn(entries, FM_COLS).astype(np.float32), device=dev)
    got = kernels.coo_segment_sum(packed, row_ids, CRITEO_BATCH)
    want = kernels.coo_segment_sum_plain(packed, row_ids, CRITEO_BATCH)
    seg_err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
            "coo_segment_sum [E, %d] float data: max abs err %g", FM_COLS,
            seg_err)
    # (b) the [E, K] feature sum repeats its bits
    dv = packed[:, :FM_HYPER["num_factors"]].contiguous()
    g1 = feature_segment_sum(dv, batch["indices"], CRITEO_DIM + 1)
    g2 = feature_segment_sum(dv, batch["indices"], CRITEO_DIM + 1)
    torch.use_deterministic_algorithms(True)
    try:
        g_det = feature_segment_sum(dv, batch["indices"], CRITEO_DIM + 1)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    require(torch.equal(g1, g2), "feature_segment_sum [E, K]: two runs "
            "differ in bits")
    require(torch.equal(g1, g_det), "feature_segment_sum [E, K]: bits "
            "differ from torch's deterministic mode")
    report["kernel_checks"] = {"coo_segment_sum_cols_float_max_abs_err":
                               seg_err, "feature_sum_same_bits": True}
    print(json.dumps({"fm_kernel_checks": report["kernel_checks"]}),
          flush=True)
    # (c) the fit on the card, twice, and on the CPU
    start = fm_params_to_numpy(init_fm_params(
        CRITEO_DIM + 1, FM_HYPER["num_factors"], FM_HYPER["init_scale"],
        device="cpu"))
    steps = EPOCHS * (-(-CRITEO_ROWS // CRITEO_BATCH))
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    history, params, seconds = run_fm_fit(fm_file, None, start)
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    require(launches["coo_segment_sum"] == steps,
            "fm path: coo_segment_sum launched %d times for %d steps",
            launches["coo_segment_sum"], steps)
    require(np.all(np.isfinite(history)), "fm path: loss history %s",
            history)
    for k, shape in (("w", (CRITEO_DIM + 1,)), ("b", ()),
                     ("v", (CRITEO_DIM + 1, FM_HYPER["num_factors"]))):
        require(params[k].shape == shape and np.all(np.isfinite(params[k])),
                "fm path: %s of shape %s or not finite", k, params[k].shape)
    require(history[-1] < history[0] - MIN_LOSS_FALL,
            "fm path: loss did not fall by %g: %s", MIN_LOSS_FALL, history)
    again = run_fm_fit(fm_file, None, start)
    require(again[0] == history and all(
        again[1][k].tobytes() == params[k].tobytes() for k in params),
        "fm path: two fits on the card differ in bits")
    cpu_history, cpu_params, cpu_seconds = run_fm_fit(fm_file, "cpu", start)
    np.testing.assert_allclose(history, cpu_history, rtol=FM_LOSS_RTOL)
    rel_err = fm_update_rel_err(params, cpu_params, start)
    require(rel_err <= FM_PARAM_REL, "fm path: params differ from the "
            "CPU's by %g of its update (limit %g)", rel_err, FM_PARAM_REL)
    loss_rel = float(np.max(np.abs(np.subtract(history, cpu_history))
                            / np.abs(cpu_history)))
    # (d) known faults, read against the same limits
    faults = {}
    for kind in ("no_q", "no_self"):
        with fm_fault(kind):
            f_history, f_params, _ = run_fm_fit(fm_file, None, start)
        faults[kind] = {
            "param_rel_err": fm_update_rel_err(f_params, cpu_params, start),
            "loss_rel_err": float(np.max(np.abs(np.subtract(
                f_history, cpu_history)) / np.abs(cpu_history)))}
        require(faults[kind]["param_rel_err"] > FM_PARAM_REL,
                "fm path: the %s fault reads %g, within the limit %g", kind,
                faults[kind]["param_rel_err"], FM_PARAM_REL)
    # (e) one step under torch.profiler
    feed = fm_feed(fm_file, None)
    try:
        one = step_batch(next(iter(feed)), "csr")
    finally:
        feed.close()
    step = make_fm_train_step(None, CRITEO_DIM + 1,
                              objective=FM_HYPER["objective"],
                              learning_rate=FM_HYPER["learning_rate"],
                              donate_batch=True)
    state = {"params": fm_params_from_numpy(start, dev)}

    def one_step():
        t0 = time.perf_counter()
        state["params"], _ = step(state["params"], one)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    one_step()
    report["fit"] = {
        "steps": steps, "launches": launches, "seconds": seconds,
        "feed_only_seconds": feed_seconds(
            fm_file + "?format=libfm", "csr", CRITEO_BATCH, CRITEO_DIM + 1),
        "rows_per_s": EPOCHS * CRITEO_ROWS / seconds,
        "ms_per_step": seconds / steps * 1e3,
        "peak_device_bytes": peak, "loss_history": history,
        "cpu_loss_history": cpu_history, "cpu_seconds": cpu_seconds,
        "loss_rel_err_vs_cpu": loss_rel,
        "param_rel_err_vs_cpu": rel_err, "faults": faults,
        "same_bits_twice": True, "step_profile": profile_call(one_step)}
    # (f) the column kernel timed at FM's shape
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    ids64 = row_ids.long()
    row = {
        "name": "coo_segment_sum_fm", "route": "cuda",
        "source": "dmlc_tpu_torch/ops/csrc/coo_segment_sum.cu",
        "replaces": "dmlc_tpu/ops/pallas_kernels.py:221",
        "launches": launches["coo_segment_sum"], "max_abs_err": seg_err,
        "shape": [entries, FM_COLS, CRITEO_BATCH],
        "ms": time_ms(lambda: kernels.coo_segment_sum(
            packed, row_ids, CRITEO_BATCH), flush),
        "plain_ms": time_ms(lambda: kernels.coo_segment_sum_plain(
            packed, row_ids, CRITEO_BATCH), flush),
        "library_ms": time_ms(lambda: torch.zeros(
            CRITEO_BATCH, FM_COLS, device=dev).index_add_(0, ids64, packed),
            flush),
    }
    row["bound_ms"], row["bound_by"] = bound(
        4 * (entries * FM_COLS + entries + CRITEO_BATCH * FM_COLS),
        entries * FM_COLS)
    del flush
    torch.cuda.synchronize()
    return report, row, start


def snap_linear_fit(path, epochs, **snap):
    """The csr linear fit of phase 6's file on the card: (history, params
    as numpy)."""
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    learner = LinearLearner(objective="logistic")
    history = learner.fit_uri(path, batch_size=CRITEO_BATCH, epochs=epochs,
                              layout="csr", num_features=CRITEO_DIM + 1,
                              **snap)
    torch.cuda.synchronize()
    return history, params_to_numpy(learner.params), learner


def same_fit(what, got, want) -> None:
    require(got[0] == want[0], "%s: loss history %s, uninterrupted %s",
            what, got[0], want[0])
    for k in want[1]:
        require(got[1][k].tobytes() == want[1][k].tobytes(),
                "%s: %s differs from the uninterrupted run's bits", what, k)


def preempted(what, fit) -> None:
    """Run ``fit`` under the injected notice; it must raise Preempted with
    the relaunch code."""
    from dmlc_tpu_torch import resilience
    from dmlc_tpu_torch.resilience import EXIT_PREEMPTED, Preempted, preempt

    resilience.configure(f"preempt.notice:nth={SNAP_NOTICE_POLL}")
    try:
        fit()
    except Preempted as err:
        require(err.code == EXIT_PREEMPTED, "%s: exit code %s", what,
                err.code)
    else:
        raise SmokeFailure(f"{what}: no Preempted at poll {SNAP_NOTICE_POLL}")
    finally:
        resilience.reset()
        preempt.reset()


def snap_rank(spec_path: str) -> int:
    """Phase 17 (b)'s child, run as ``chip_smoke.py --snap-rank SPEC``: the
    csr linear fit of ``spec["epochs"]`` epochs with snapshots armed (and
    ``spec["resume"]``), then ``save`` to ``spec["model"]``. A SIGTERM
    ends it with exit code 75 once the last boundary is committed."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    learner = snap_linear_fit(spec["file"], spec["epochs"],
                              snapshot_uri=spec["snap"],
                              resume=spec["resume"])[2]
    learner.save(spec["model"])
    return 0


def run_snap_child(spec: dict, tmp: str, signal_after_commit: bool):
    """Start a ``--snap-rank`` child; with ``signal_after_commit``, send it
    SIGTERM once its first manifest has committed (it must still be
    running then). Returns (exit code, seconds, the log's tail)."""
    import signal

    path = os.path.join(tmp, "snap_spec.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    log = open(os.path.join(tmp, "snap_child.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--snap-rank", path], stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        if signal_after_commit:
            manifest = os.path.join(spec["snap"], "snap_v1.manifest")
            while not os.path.exists(manifest):
                require(proc.poll() is None, "snapshot child exited with %s "
                        "before its first manifest", proc.returncode)
                require(time.monotonic() < deadline, "no manifest in %d s",
                        RANK_TIMEOUT_S)
                time.sleep(0.01)
            require(proc.poll() is None, "the snapshot child finished "
                    "before the signal: give it more epochs")
            proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    with open(os.path.join(tmp, "snap_child.log")) as fh:
        tail = fh.read()[-4000:]
    return proc.returncode, time.perf_counter() - t0, tail


def drive_snapshots(csr_file, fm_file, start, tmp) -> dict:
    """Phase 17 (the module docstring)."""
    from dmlc_tpu_torch.collective import (JobSnapshot, Snapshotter,
                                           load_snapshot)
    from dmlc_tpu_torch.resilience import preempt

    report = {}
    # (a) the injected notice, in process: csr linear, then FM
    clean = snap_linear_fit(csr_file, SNAP_EPOCHS)
    snap_dir = os.path.join(tmp, "linear_snap")
    preempted("linear", lambda: snap_linear_fit(
        csr_file, SNAP_EPOCHS, snapshot_uri=snap_dir))
    meta = JobSnapshot(snap_dir).restore()[2]
    require(meta.get("epoch") == 1, "linear: the committed snapshot is of "
            "epoch %s, not 1", meta.get("epoch"))
    same_fit("linear resume", snap_linear_fit(
        csr_file, SNAP_EPOCHS, snapshot_uri=snap_dir, resume=True), clean)
    report["linear_injected"] = {"manifest_epoch": meta["epoch"],
                                 "bit_identical": True}

    fm_clean = run_fm_fit(fm_file, None, start, SNAP_EPOCHS)
    fm_dir = os.path.join(tmp, "fm_snap")
    snapper = Snapshotter(JobSnapshot(fm_dir))
    try:
        preempted("fm", lambda: run_fm_fit(fm_file, None, start,
                                           SNAP_EPOCHS, snapshotter=snapper))
        stats = snapper.stats()
    finally:
        snapper.close()
    snap = JobSnapshot(fm_dir)
    snapper = Snapshotter(snap)
    try:
        version, state, meta = load_snapshot(snap)
        require(meta.get("epoch") == 1, "fm: the committed snapshot is of "
                "epoch %s, not 1", meta.get("epoch"))
        learner = fm_learner(None, start)
        learner.restore_snapshot_model(state["model"])
        snapper.mark_restored(state["epoch"])
        resumed = run_fm_fit(fm_file, None, start, SNAP_EPOCHS,
                             learner=learner, snapshotter=snapper,
                             start_epoch=state["epoch"] + 1,
                             history=state["history"])
    finally:
        snapper.close()
        preempt.uninstall()
    same_fit("fm resume", resumed, fm_clean)
    # (c) the cost of a snapshot of FM's table
    report["fm_injected"] = {
        "manifest_epoch": meta["epoch"], "bit_identical": True,
        "v_bytes": int(start["v"].nbytes),
        "capture_ns": stats["capture_ns"], "write_ns": stats["write_ns"],
        "part_bytes": stats["bytes"]}
    print(json.dumps({"snapshot_capture": report["fm_injected"]}),
          flush=True)
    # (b) the real signal, in a child process, then its relaunch
    model = os.path.join(tmp, "uninterrupted.model")
    snap_linear_fit(csr_file, SIGNAL_EPOCHS)[2].save(model)
    spec = {"file": csr_file, "epochs": SIGNAL_EPOCHS,
            "snap": os.path.join(tmp, "signal_snap"),
            "model": os.path.join(tmp, "resumed.model"), "resume": False}
    rc, first_s, tail = run_snap_child(spec, tmp, True)
    require(rc == 75, "the signalled child exited with %s, not 75:\n%s",
            rc, tail)
    meta = JobSnapshot(spec["snap"]).restore()[2]
    rc, second_s, tail = run_snap_child(dict(spec, resume=True), tmp, False)
    require(rc == 0, "the relaunched child exited with %s:\n%s", rc, tail)
    with open(model, "rb") as a, open(spec["model"], "rb") as b:
        require(a.read() == b.read(), "the relaunched run's model file "
                "differs from the uninterrupted run's")
    report["sigterm"] = {"exit_code": 75, "manifest_epoch": meta["epoch"],
                         "first_child_s": first_s,
                         "relaunch_s": second_s,
                         "model_bytes_equal": True}
    return report


# ---------------------------------------------------------------------------
# phase 18: fault-tolerant distributed training
# ---------------------------------------------------------------------------


def process_start_time() -> float:
    """This process's start, unix seconds, from /proc (Linux): its start
    in clock ticks after boot, and the boot from /proc/uptime (10 ms)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        boot = time.time() - float(fh.read().split()[0])
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def recover_rank(spec_path: str) -> int:
    """One rank of phase 18, run as ``chip_smoke.py --recover-rank SPEC``
    by the port's launcher (the socket engine, ``sync="host"``) or by
    :func:`run_device_job`'s per-task loop (the device engine over the
    DMLC_TPU_* env, ``sync="spmd"``): fits ``spec["file"]`` one epoch a
    round under ``run_with_recovery`` for ``RECOVER_EPOCHS`` rounds, each
    round from the shared checkpoint ``spec["ckpt"]`` (epoch, params,
    velocity, loss history, as numpy) on part ``rank()`` of
    ``world_size()``, rank 0 writing the file. Each entry of
    ``spec["crashes"]`` names a rank that exits hard as it starts that
    epoch's round, once a job (the marker it leaves first,
    ``crashed-rank<r>.json``, says it did); the ``worker.step``
    faultpoint, passed rank + 1 times before each round outside the
    recovery, kills the rank it fires on. Prints
    one ``recover_rank`` line (rank, digest of (w, b), version,
    generation, launch counts) and writes the whole report (steps,
    times, rounds) to ``report-rank<r>.json`` beside the spec: the ranks
    share the launcher's stdout, where their writes may interleave."""
    import hashlib

    import torch.distributed as dist
    from dmlc_tpu_torch import collective, resilience
    from dmlc_tpu_torch.models import (LinearLearner, init_linear_params,
                                       params_from_numpy, params_to_numpy)
    from dmlc_tpu_torch.ops import kernels
    from dmlc_tpu_torch.parallel import distributed

    times = {"process_start": process_start_time(), "entry": time.time()}
    with open(spec_path) as fh:
        spec = json.load(fh)
    device_engine = spec["engine"] == "device"
    task = int(os.environ.get("DMLC_TASK_ID", 0))
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", 0))
    dev = torch.device(spec["devices"][task] if device_engine else "cuda:0")
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    times["cuda_ready"] = time.time()
    kernels._lib()  # built by the parent: loaded, never built again
    times["kernels_loaded"] = time.time()
    if device_engine:
        distributed.initialize_from_env(backend=spec["backend"], device=dev)
        collective.init("device")
    else:
        collective.init()  # a warm spare parks here until called up
    times["engine_ready"] = time.time()
    recoveries = []
    collective.on_membership_change(lambda: recoveries.append(time.time()))

    class Learner(LinearLearner):
        steps = 0

        def _ensure(self, num_features, layout):  # once a step
            super()._ensure(num_features, layout)
            self.steps += 1

    learner = Learner(device=dev, sync=spec["sync"], objective="logistic",
                      group=dist.group.WORLD if device_engine else None)
    nf = DIST_NF["csr"]
    start = params_to_numpy(init_linear_params(nf, "cpu"))
    rounds = []

    def marker(name: str, epoch: int) -> None:
        with open(os.path.join(spec["out"], name), "w") as fh:
            json.dump({"task": task, "rank": collective.rank(),
                       "epoch": epoch, "at": time.time()}, fh)

    def round_fn():
        state = collective.load_checkpoint(spec["ckpt"])
        if state is None:
            state = (0, start, {k: np.zeros_like(v) for k, v in start.items()},
                     [])
        epoch, params, velocity, history = state
        if epoch >= RECOVER_EPOCHS:
            return state
        for crash in spec["crashes"]:
            name = "crashed-rank%d.json" % crash["rank"]
            if (collective.rank() == crash["rank"]
                    and epoch == crash["epoch"] and not os.path.exists(
                        os.path.join(spec["out"], name))):
                marker(name, epoch)
                os._exit(17)
        learner.params = params_from_numpy(params, dev)
        learner.velocity = params_from_numpy(velocity, dev)
        rounds.append({"epoch": epoch, "start": time.time(),
                       "rank": collective.rank(),
                       "world": collective.world_size()})
        loss = learner.fit_uri(spec["file"], batch_size=DIST_BATCH["csr"],
                               epochs=1, layout="csr", num_features=nf,
                               drop_remainder=True)
        torch.cuda.synchronize(dev)
        rounds[-1]["end"] = time.time()
        state = (epoch + 1, params_to_numpy(learner.params),
                 params_to_numpy(learner.velocity), list(history) + loss)
        collective.checkpoint(
            state, spec["ckpt"] if collective.rank() == 0 else None)
        return state

    kernels.reset_launch_counts()
    with count_parts() as parts:
        state = (0,)
        while state[0] < RECOVER_EPOCHS:
            for _ in range(collective.rank() + 1):
                try:
                    resilience.faultpoint("worker.step")
                except resilience.InjectedFault:
                    marker("killed.json", state[0])
                    os._exit(1)
            state = collective.run_with_recovery(round_fn, max_attempts=6)
    launches = {k: kernels.KERNELS[k].launches
                for k in ("coo_segment_sum", "tokenize_boundaries")}
    params = state[1]
    rank = collective.rank()
    np.savez(os.path.join(spec["out"], f"params-rank{rank}.npz"), **params)
    report = {
        "task": task, "attempt": attempt, "rank": rank,
        "world": collective.world_size(),
        "spare": os.environ.get("DMLC_TPU_SPARE") == "1",
        "digest": hashlib.sha256(params["w"].tobytes()
                                 + params["b"].tobytes()).hexdigest(),
        "version": collective.version_number(),
        "generation": getattr(collective._engine, "generation", 1),
        "launches": launches, "steps": learner.steps,
        "chunk_parts": len(parts), "history": state[3], "times": times,
        "rounds": rounds, "recoveries": recoveries}
    with open(os.path.join(spec["out"], f"report-rank{rank}.json"),
              "x") as fh:  # one final report a rank: a second one fails
        json.dump(report, fh)
    sys.stdout.write(
        f"recover_rank rank={rank} digest={report['digest']} version="
        f"{report['version']} generation={report['generation']} "
        + " ".join(f"{k}={v}" for k, v in launches.items()) + "\n")
    sys.stdout.flush()
    learner.close()
    collective.finalize()
    distributed.shutdown()
    return 0


def _kill_group(proc) -> None:
    """SIGKILL the process group a job runs in (its ranks included)."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _reports(out: str) -> dict:
    """The final reports of a job's ranks, by rank."""
    reports = {}
    for name in sorted(os.listdir(out)):
        if name.startswith("report-rank"):
            with open(os.path.join(out, name)) as fh:
                rep = json.load(fh)
            reports[rep["rank"]] = rep
    return reports


def _job_spec(tmp: str, name: str, csr_file: str, **spec) -> str:
    out = os.path.join(tmp, name)
    os.makedirs(out)
    spec = dict({"file": csr_file, "ckpt": os.path.join(out, "ckpt.bin"),
                 "out": out, "engine": "socket", "sync": "host",
                 "crashes": []}, **spec)
    path = os.path.join(out, "spec.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    return path


def run_launcher_job(tmp, name, csr_file, launcher_args, faults="",
                     **spec):
    """One job of phase 18 (a)-(c) through the port's launcher,
    ``python -m dmlc_tpu_torch.tracker.submit --cluster local``, in its
    own process group; every process of it is killed on the way out. A
    job that fails or outlasts ``RANK_TIMEOUT_S`` fails the run. Returns
    (the final ``recover_rank`` reports by rank, the job's log, its wall
    seconds, the spec)."""
    spec_path = _job_spec(tmp, name, csr_file, **spec)
    out = os.path.dirname(spec_path)
    env = dict(os.environ, DMLC_TPU_ELASTIC_WINDOW_S="1.0")
    for key in ("DMLC_TPU_FAULTS", "DMLC_TPU_ELASTIC", "DMLC_TPU_SPARE",
                "DMLC_TRACKER_URI", "DMLC_TPU_COORDINATOR"):
        env.pop(key, None)
    if faults:
        env["DMLC_TPU_FAULTS"] = faults
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit",
           "--cluster", "local", "--host-ip", "127.0.0.1", *launcher_args,
           sys.executable, os.path.abspath(__file__), "--recover-rank",
           spec_path]
    log_path = os.path.join(out, "job.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            proc.wait(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pass
        finally:
            code = proc.poll()
            _kill_group(proc)
    seconds = time.perf_counter() - t0
    with open(log_path) as fh:
        text = fh.read()
    require(code == 0, "%s: the launcher %s:\n%s", name,
            "did not finish in %d s" % RANK_TIMEOUT_S if code is None
            else "exited with %s" % code, text[-6000:])
    with open(spec_path) as fh:
        return _reports(out), text, seconds, json.load(fh)


def run_device_job(tmp, name, csr_file, backend, devices, crashes=()):
    """Phase 18 (d): a world of ``len(devices)`` ranks on the device
    engine, each task in a per-task relaunch loop of its own (up to 3
    attempts) that exports DMLC_TPU_COORDINATOR (``host:port``) /
    DMLC_TPU_NUM_PROC / DMLC_TPU_PROC_ID, as a GPU launcher would.
    Returns (the final reports by rank, each task's exit codes, the wall
    seconds, the spec)."""
    import socket

    world = len(devices)
    spec_path = _job_spec(tmp, name, csr_file, engine="device",
                          sync="spmd", backend=backend, devices=devices,
                          crashes=list(crashes))
    out = os.path.dirname(spec_path)
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    codes = {tid: [] for tid in range(world)}
    logs = {tid: [] for tid in range(world)}
    lock = threading.Lock()
    procs = []
    deadline = time.monotonic() + RANK_TIMEOUT_S

    def run_task(tid: int) -> None:
        for attempt in range(3):
            env = dict(os.environ, DMLC_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       DMLC_TPU_NUM_PROC=str(world),
                       DMLC_TPU_PROC_ID=str(tid), DMLC_TASK_ID=str(tid),
                       DMLC_NUM_ATTEMPT=str(attempt),
                       DMLC_TPU_RECOVER_TIMEOUT="60")
            for key in ("DMLC_TPU_FAULTS", "DMLC_TRACKER_URI"):
                env.pop(key, None)
            log_path = os.path.join(out, f"task{tid}.{attempt}.log")
            with open(log_path, "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--recover-rank", spec_path], env=env, stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True)
                with lock:
                    procs.append(proc)
                try:
                    code = proc.wait(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    code = None
            with open(log_path) as fh:
                text = fh.read()
            with lock:
                codes[tid].append(code)
                logs[tid].append(text)
            if code in (0, None):
                return

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run_task, args=(tid,))
               for tid in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for proc in procs:
            _kill_group(proc)
    seconds = time.perf_counter() - t0
    for tid in range(world):
        require(codes[tid][-1] == 0, "%s: task %d exit codes %s:\n%s", name,
                tid, codes[tid], logs[tid][-1][-6000:])
    with open(spec_path) as fh:
        return _reports(out), codes, seconds, json.load(fh)


def hold_recover_job(name, reports, world, digest=None) -> dict:
    """Phase 18's checks of one job's final reports: one a rank, each at
    version ``RECOVER_EPOCHS``, every digest equal (and equal to
    ``digest``), each process's ``coo_segment_sum`` launches equal to the
    steps it ran and its tokenizer launches to its chunk parts."""
    require(sorted(reports) == list(range(world)), "%s: final reports of "
            "ranks %s, want %d", name, sorted(reports), world)
    digests = {rep["digest"] for rep in reports.values()}
    require(len(digests) == 1, "%s: the ranks' digests differ: %s", name,
            digests)
    if digest is not None:
        require(digests == {digest}, "%s: digest %s, the clean run's %s",
                name, digests, digest)
    for r, rep in reports.items():
        require(rep["version"] == RECOVER_EPOCHS, "%s: rank %d ends at "
                "version %d", name, r, rep["version"])
        require(rep["launches"]["coo_segment_sum"] == rep["steps"] > 0,
                "%s: rank %d launched coo_segment_sum %d times for %d "
                "steps", name, r, rep["launches"]["coo_segment_sum"],
                rep["steps"])
        require(rep["launches"]["tokenize_boundaries"]
                == rep["chunk_parts"] > 0, "%s: rank %d launched the "
                "tokenizer %d times for %d chunk parts", name, r,
                rep["launches"]["tokenize_boundaries"], rep["chunk_parts"])
    return {"digest": digests.pop(), "ranks": {
        r: {k: rep[k] for k in ("task", "attempt", "spare", "generation",
                                "version", "launches", "steps",
                                "chunk_parts")}
        for r, rep in reports.items()}}


def fault_marker(spec, name) -> dict:
    with open(os.path.join(spec["out"], name)) as fh:
        return json.load(fh)


def replay_seconds(fault, reports) -> float:
    """Seconds from the fault to the replayed round's start on the last
    rank to reach it: the first replayed step is that round's first
    all-reduce, which waits for every rank. A rank whose final process
    started after that round (it crashed later) has no say."""
    starts = [min(r["start"] for r in rep["rounds"]
                  if r["epoch"] == fault["epoch"] and r["start"] > fault["at"])
              for rep in reports.values()
              if any(r["epoch"] == fault["epoch"] and r["start"] > fault["at"]
                     for r in rep["rounds"])]
    require(starts, "no rank replayed round %d after the fault",
            fault["epoch"])
    return max(starts) - fault["at"]


def relaunch_seconds(fault, rep) -> dict:
    """A relaunched process's start, split: the crash to the process's
    start (the launcher's notice and exec), imports, CUDA, the kernels'
    library (loaded, not built) and the rendezvous."""
    fault_at = fault["at"]
    t = rep["times"]
    return {"to_process_start": t["process_start"] - fault_at,
            "imports": t["entry"] - t["process_start"],
            "cuda_init": t["cuda_ready"] - t["entry"],
            "kernels_load": t["kernels_loaded"] - t["cuda_ready"],
            "rendezvous": t["engine_ready"] - t["kernels_loaded"],
            "total": t["engine_ready"] - fault_at}


def fit_rows_per_s(reports) -> float:
    """All ranks' stepped rows over the slowest rank's round seconds."""
    rows = sum(rep["steps"] for rep in reports.values()) * DIST_BATCH["csr"]
    seconds = max(sum(r["end"] - r["start"] for r in rep["rounds"])
                  for rep in reports.values())
    return rows / seconds


def drive_recovery(csr_file, tmp, parts=("clean", "crash", "elastic",
                                         "device")) -> dict:
    """Phase 18 (the module docstring): the jobs of ``parts``, in order;
    "crash", "elastic" and "device" hold their digests against "clean"."""
    report = {}
    reports, _, clean_s, spec = run_launcher_job(
        tmp, "clean", csr_file, ["-n", "2"])
    clean = hold_recover_job("clean", reports, 2)
    clean_params = dict(np.load(os.path.join(spec["out"],
                                             "params-rank0.npz")))
    report["clean"] = dict(clean, seconds=clean_s,
                           rows_per_s=fit_rows_per_s(reports))
    if "crash" in parts:
        reports, _, secs, spec = run_launcher_job(
            tmp, "crash", csr_file, ["-n", "2", "--max-attempts", "2"],
            crashes=[{"rank": 1, "epoch": RECOVER_CRASH_EPOCH}])
        held = hold_recover_job("crash", reports, 2, clean["digest"])
        relaunched = reports[1]
        require(relaunched["attempt"] == 1 and reports[0]["attempt"] == 0
                and len(reports[0]["recoveries"]) == 1,
                "crash: rank 1 attempt %d, rank 0 attempt %d with %d "
                "recoveries", relaunched["attempt"], reports[0]["attempt"],
                len(reports[0]["recoveries"]))
        fault = fault_marker(spec, "crashed-rank1.json")
        report["crash"] = dict(
            held, seconds=secs, vs_clean=secs / clean_s,
            crash_to_replay_s=replay_seconds(fault, reports),
            relaunch_s=relaunch_seconds(fault, relaunched))
    if "elastic" in parts:
        reports, text, secs, spec = run_launcher_job(
            tmp, "elastic", csr_file,
            ["-n", "2", "--elastic", "--spares", "1"],
            faults=RECOVER_FAULTS)
        held = hold_recover_job("elastic", reports, 2, clean["digest"])
        line = [ln for ln in text.splitlines()
                if "@tracker membership" in ln]
        require(line, "elastic: no membership line in the launcher's log")
        fields = dict(f.split("=", 1) for f in line[-1].split()
                      if "=" in f)
        kinds = set(fields["events"].split(","))
        require(fields["world_version"] == "2" and {"join", "rebuild"}
                <= kinds, "elastic: the tracker's membership %s", line[-1])
        spares = [rep for rep in reports.values() if rep["spare"]]
        require(len(spares) == 1 and all(
            rep["generation"] == 2 for rep in reports.values()),
            "elastic: %d spares in the final world, generations %s",
            len(spares), [rep["generation"] for rep in reports.values()])
        require(spares[0]["launches"]["coo_segment_sum"] > 0
                and spares[0]["launches"]["tokenize_boundaries"] > 0,
                "elastic: the spare launched %s", spares[0]["launches"])
        fault = fault_marker(spec, "killed.json")
        report["elastic"] = dict(
            held, seconds=secs, vs_clean=secs / clean_s,
            world_version=2, events=fields["events"],
            kill_to_replay_s=replay_seconds(fault, reports),
            kill_to_spare_ready_s=(spares[0]["times"]["engine_ready"]
                                   - fault["at"]))
    if "device" in parts:
        report["device"] = {}
        flavors = [("gloo", ["cuda:0", "cuda:0"])]
        if torch.cuda.device_count() >= 2:
            flavors.append(("nccl", ["cuda:0", "cuda:1"]))
        else:
            report["device"]["nccl"] = "skipped: one card (NCCL refuses " \
                                       "two ranks on one GPU)"
        for backend, devices in flavors:
            reports, codes, clean_d_s, spec = run_device_job(
                tmp, f"device_{backend}_clean", csr_file, backend, devices)
            base = hold_recover_job(f"device {backend} clean", reports, 2)
            rel = param_rel_err(dict(np.load(os.path.join(
                spec["out"], "params-rank0.npz"))), clean_params)
            require(rel <= FIT_PARAM_REL, "device %s: the clean spmd fit is "
                    "%g from the host fit's params (limit %g)", backend, rel,
                    FIT_PARAM_REL)
            # rank 0, which serves the store, dies first; then rank 1,
            # and the surviving (relaunched) rank 0 serves it again
            crashes = [{"rank": 0, "epoch": RECOVER_CRASH_EPOCH},
                       {"rank": 1, "epoch": RECOVER_CRASH_EPOCH + 1}]
            reports, codes, secs, spec = run_device_job(
                tmp, f"device_{backend}_crash", csr_file, backend, devices,
                crashes)
            held = hold_recover_job(f"device {backend} crash", reports, 2,
                                    base["digest"])
            # each rank is the survivor of the other's crash, and a
            # fail-stop exit 41 can only end a survivor's re-init
            routes, to_replay, relaunch = {}, {}, {}
            for crash in crashes:
                dead = crash["rank"]
                survivor = reports[1 - dead]
                key = "rank%d_crash" % dead
                require(codes[reports[dead]["task"]].count(17) == 1,
                        "device %s: rank %d exit codes %s", backend, dead,
                        codes[reports[dead]["task"]])
                routes[key] = ("survivor rank %d: %s" % (
                    1 - dead, "fail-stop exit 41, relaunched"
                    if 41 in codes[survivor["task"]]
                    else "re-initialized in process"))
                fault = fault_marker(spec, "crashed-rank%d.json" % dead)
                to_replay[key] = replay_seconds(fault, reports)
                relaunch[key] = relaunch_seconds(fault, reports[dead])
            report["device"][backend] = dict(
                held, exit_codes={rep["rank"]: codes[rep["task"]]
                                  for rep in reports.values()},
                routes=routes, clean_seconds=clean_d_s, seconds=secs,
                vs_clean=secs / clean_d_s, clean_vs_host_rel_err=rel,
                crash_to_replay_s=to_replay, relaunch_s=relaunch)
    return report


# ---------------------------------------------------------------------------
# phase 19: expert-parallel MoE and the GPipe pipeline at Mixtral's widths
# ---------------------------------------------------------------------------


def moe_inputs(dev):
    """Phase 19's MoE params (``init_moe_params`` at Mixtral's widths from
    ``MOE_SEED``) and x [1, MOE_T, MOE_D], drawn on the card: the same bits
    in every process on the card. Leaves that require grad."""
    from dmlc_tpu_torch.ops.moe import init_moe_params

    params = init_moe_params(MOE_E, MOE_D, MOE_H, seed=MOE_SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED + 1)
    x = randn(gen, (1, MOE_T, MOE_D), dev)
    return {k: v.requires_grad_(True) for k, v in params.items()}, \
        x.requires_grad_(True)


def moe_step(fn, params, x) -> tuple:
    """Forward and backward of sum(y²) + aux from fresh gradients:
    (y, aux, {"dx", "dwg", "dw1", "dw2"}), all detached."""
    leaves = {"x": x, **params}
    for v in leaves.values():
        v.grad = None
    y, aux = fn(params, x)
    ((y ** 2).sum() + aux).backward()
    return y.detach(), aux.detach(), {f"d{k}": v.grad
                                      for k, v in leaves.items()}


def moe_flops(tokens: int, capacity: int, ep: int) -> dict:
    """Operations of one rank's MoE layer at Mixtral's widths, forward and
    forward + backward: the router, the dispatch and combine einsums over
    [T, E, C] and the expert FFN over [E / ep, ep·C] rows."""
    router = 2 * tokens * MOE_D * MOE_E
    einsum = 2 * tokens * MOE_E * capacity * MOE_D  # dispatch or combine
    ffn = 2 * 2 * (MOE_E // ep) * ep * capacity * MOE_D * MOE_H
    forward = router + 2 * einsum + ffn
    # backward: the router's two products, x's gradient through dispatch,
    # combine's two operands, and the FFN's activations and weights
    backward = 2 * router + einsum + 2 * einsum + 2 * ffn
    return {"forward": forward, "step": forward + backward,
            "ffn_forward": ffn, "einsums_forward": 2 * einsum}


def rel_err(got, want) -> float:
    """‖got − want‖₂ / ‖want‖₂, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def hold_rel(what, got: dict, want: dict, report: dict) -> None:
    """Hold each tensor of ``got`` against ``want`` by its relative norm
    error (``MOE_REL``); the errors and the largest absolute differences
    go to ``report``."""
    errs = {k: rel_err(got[k], want[k]) for k in got}
    report["rel_err"] = errs
    report["max_abs_err"] = {k: float((got[k] - want[k]).abs().max())
                             for k in got}
    for key, err in errs.items():
        require(err <= MOE_REL, "%s: %s differs by a relative norm of %g "
                "(limit %g)", what, key, err, MOE_REL)


def moe_tensors(result) -> dict:
    """{"y", "aux", "dx", "dwg", "dw1", "dw2"} of a ``moe_step`` result."""
    y, aux, grads = result
    return {"y": y, "aux": aux, **grads}


def drive_moe_world1(dev, flush, tmp) -> dict:
    """Phase 19 (a): the MoE layer over a one-rank group at Mixtral's
    widths, T = MOE_T, top-2, capacity T; forward and backward held
    against the per-expert oracle on the card; ms a step (median of
    MOE_STEPS after a warm-up), peak bytes, one step profiled, and the
    forward's parts timed alone. Saves to ``tmp/moe_world1.pt`` what (c)
    is held to: y, and aux and the gradients of world 2's loss, whose aux
    is the mean of the two token halves' (one rank, the same layer)."""
    import torch.nn.functional as F

    import torch.distributed as dist
    from dmlc_tpu_torch.ops.moe import (_route_topk, make_moe_layer,
                                        moe_dense_oracle)

    report = {"shape": {"B": 1, "T": MOE_T, "D": MOE_D, "H": MOE_H,
                        "E": MOE_E, "top_k": MOE_K, "capacity": MOE_T}}
    params, x = moe_inputs(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/pg1", rank=0,
                            world_size=1)
    try:
        layer = make_moe_layer(dist.group.WORLD, MOE_E, capacity=MOE_T,
                               top_k=MOE_K)
        got = moe_step(layer, params, x)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(MOE_STEPS):
            t0 = time.perf_counter()
            got = moe_step(layer, params, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        report["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        report["step_ms"] = times

        def profiled():
            t0 = time.perf_counter()
            moe_step(layer, params, x)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        report["step_profile"] = profile_call(profiled)

        # (c)'s reference: world 2's loss at one rank, whose aux is the
        # mean of the two token halves' switch losses (each rank balances
        # its own routing), and its gradients
        def world2_loss(p, v):
            halves = v.split(MOE_T // 2, dim=1)
            aux = torch.stack([_route_topk(
                h.reshape(-1, MOE_D), p["wg"], MOE_E, MOE_T // 2, MOE_K)[2]
                for h in halves]).mean()
            return layer(p, v)[0], aux

        world2 = moe_step(world2_loss, params, x)
    finally:
        dist.destroy_process_group()
    flops = moe_flops(MOE_T, MOE_T, 1)
    report["flops"] = flops
    report["step_ms_median"] = statistics.median(times)
    # bytes: params and x read once, y and every gradient written once
    n_params = sum(v.numel() for v in params.values())
    report["step_bound_ms"], report["step_bound_by"] = bound(
        4 * (2 * n_params + 3 * x.numel()), flops["step"])
    report["step_share_of_bound"] = (report["step_bound_ms"]
                                     / report["step_ms_median"])
    want = moe_step(lambda p, v: moe_dense_oracle(p, v, top_k=MOE_K),
                    params, x)
    with torch.no_grad():
        y64, _ = moe_dense_oracle({k: v.detach().double()
                                   for k, v in params.items()},
                                  x.detach().double(), top_k=MOE_K)
        report["y_vs_float64_oracle_rel_err"] = {
            "layer": rel_err(got[0], y64), "oracle": rel_err(want[0], y64)}
        del y64
    report["vs_oracle"] = {}
    hold_rel("moe (a) layer vs oracle", moe_tensors(got), moe_tensors(want),
             report["vs_oracle"])
    del want
    # the forward's parts alone (no autograd): the router, the dispatch
    # and combine einsums, the expert FFN
    with torch.no_grad():
        xt, wg = x.detach().reshape(MOE_T, MOE_D), params["wg"].detach()
        w1, w2 = params["w1"].detach(), params["w2"].detach()
        route = lambda: _route_topk(xt, wg, MOE_E, MOE_T, MOE_K)  # noqa: E731
        dispatch, combine, _ = route()
        xd = torch.einsum("tec,td->ecd", dispatch, xt)
        ffn = lambda: torch.einsum(  # noqa: E731
            "ech,ehd->ecd", F.gelu(torch.einsum("ecd,edh->ech", xd, w1),
                                   approximate="tanh"), w2)
        y = ffn()
        parts = {
            "router_ms": time_ms(route, flush, MOE_STEPS),
            "dispatch_einsum_ms": time_ms(lambda: torch.einsum(
                "tec,td->ecd", dispatch, xt), flush, MOE_STEPS),
            "expert_ffn_ms": time_ms(ffn, flush, MOE_STEPS),
            "combine_einsum_ms": time_ms(lambda: torch.einsum(
                "tec,ecd->td", combine, y), flush, MOE_STEPS)}
        parts["expert_ffn_bound_ms"] = flops["ffn_forward"] \
            / PEAK_F32_FLOPS * 1e3
        parts["einsums_bound_ms"] = flops["einsums_forward"] \
            / PEAK_F32_FLOPS * 1e3
        report["forward_parts"] = parts
        del dispatch, combine, xd, y
    report["forward_bound_ms"] = flops["forward"] / PEAK_F32_FLOPS * 1e3
    torch.save({"y": world2[0].cpu(), "aux": world2[1].cpu(),
                **{k: v.cpu() for k, v in world2[2].items()}},
               os.path.join(tmp, "moe_world1.pt"))
    return report


def drive_moe_block(dev) -> dict:
    """Phase 19 (b): the example's block (ring attention with GQA, the
    MoE FFN, RMSNorm and residuals) at Mixtral's widths, T = MOE_T, one
    rank, forward, against its single-rank reference within the example's
    max|Δ| < 1e-3; ms of each."""
    from dmlc_tpu_torch.examples import moe_transformer as ex

    params = ex.block_params(MOE_D, MOE_HEADS, MOE_KV_HEADS, MOE_E, MOE_H,
                             dev, seed=MOE_SEED)
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED + 2)
    x = randn(gen, (1, MOE_T, MOE_D), dev)
    block = ex.make_block(params, MOE_HEADS, MOE_KV_HEADS, MOE_T, MOE_K)
    with torch.no_grad():
        block(x)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, aux = block(x)
        torch.cuda.synchronize()
        block_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = ex.reference_block(params, x, MOE_HEADS, MOE_KV_HEADS, MOE_K)
        torch.cuda.synchronize()
        ref_ms = (time.perf_counter() - t0) * 1e3
    err = float((got - want).abs().max())
    require(torch.isfinite(got).all() and err < ex.MAX_ABS_DIFF,
            "moe block: max|Δ| %g against the single-rank block (limit %g)",
            err, ex.MAX_ABS_DIFF)
    return {"heads": MOE_HEADS, "kv_heads": MOE_KV_HEADS,
            "head_dim": MOE_D // MOE_HEADS, "T": MOE_T,
            "max_abs_err": err, "limit": ex.MAX_ABS_DIFF,
            "aux": float(aux), "block_ms": block_ms, "reference_ms": ref_ms}


def pipeline_inputs(dev):
    """Phase 19 (c)'s pipeline: the reference's ``_mlp_stage`` stacked for
    PIPE_STAGES stages at D = PIPE_D (w scaled by 1/√D so that tanh stays
    off its rails, b by 0.1) and x [PIPE_BATCH, PIPE_D], drawn on the
    card from MOE_SEED + 3."""
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED + 3)
    params = {"w": randn(gen, (PIPE_STAGES, PIPE_D, PIPE_D), dev)
              .mul_(PIPE_D ** -0.5),
              "b": randn(gen, (PIPE_STAGES, PIPE_D), dev).mul_(0.1)}
    return params, randn(gen, (PIPE_BATCH, PIPE_D), dev)


def mlp_stage(p, x):
    """tests/test_pipeline_parallel.py's ``_mlp_stage``."""
    return torch.tanh(x @ p["w"] + p["b"])


def moe_rank(rank: int, spec_path: str) -> int:
    """One rank of phase 19 (c), run as ``chip_smoke.py --moe-rank RANK
    SPEC`` by :func:`run_ranks` (world 2 over gloo on the one card): the
    MoE layer with its 4 experts and its 2048 tokens, forward and backward
    held against (a)'s saved results, ms a step, the all_to_all timed
    alone; then the 2-stage pipeline against ``pipeline_oracle`` on the
    card, ms a step. Writes ``rank<r>.json`` (and an empty npz) beside the
    spec."""
    import torch.distributed as dist
    from dmlc_tpu_torch.ops.moe import (make_moe_layer, shard_moe_params,
                                        shard_tokens)
    from dmlc_tpu_torch.ops.pipeline_parallel import (make_pipeline,
                                                      pipeline_oracle,
                                                      shard_pipeline_params)
    from dmlc_tpu_torch.parallel import axis, distributed

    with open(spec_path) as fh:
        spec = json.load(fh)
    out = os.path.dirname(spec_path)
    world = spec["world"]
    dev = distributed.initialize(spec["init"], world, rank,
                                 backend=spec["backend"],
                                 device=spec["devices"][rank])
    group = dist.group.WORLD
    report = {"device": str(dev), "backend": dist.get_backend()}
    try:
        whole, x = moe_inputs(dev)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in shard_moe_params(whole, group).items()}
        xs = shard_tokens(x.detach(), group).clone().requires_grad_(True)
        del whole, x
        capacity = MOE_T // world
        layer = make_moe_layer(group, MOE_E, capacity=capacity, top_k=MOE_K)
        got = moe_step(layer, params, xs)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(MOE_STEPS):
            t0 = time.perf_counter()
            got = moe_step(layer, params, xs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        report["moe"] = {"step_ms": times,
                         "step_ms_median": statistics.median(times),
                         "capacity": capacity, "tokens": MOE_T // world}
        ref = torch.load(os.path.join(out, "moe_world1.pt"), mmap=True)
        t_lo, t_hi = rank * MOE_T // world, (rank + 1) * MOE_T // world
        e_lo, e_hi = rank * MOE_E // world, (rank + 1) * MOE_E // world
        want = (ref["y"][:, t_lo:t_hi].to(dev), ref["aux"].to(dev),
                {"dx": ref["dx"][:, t_lo:t_hi].to(dev),
                 "dwg": ref["dwg"].to(dev),
                 "dw1": ref["dw1"][e_lo:e_hi].to(dev),
                 "dw2": ref["dw2"][e_lo:e_hi].to(dev)})
        report["moe"]["vs_world1"] = {}
        hold_rel(f"moe (c) rank {rank} vs world 1", moe_tensors(got),
                 moe_tensors(want), report["moe"]["vs_world1"])
        del ref, want, got
        # the dispatch's all_to_all alone: [ep, E / ep, C, D]
        xd = torch.zeros(world, MOE_E // world, capacity, MOE_D, device=dev)
        a2a = []
        for _ in range(MOE_STEPS + 1):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            axis.all_to_all(xd, group, 0, 0)
            torch.cuda.synchronize()
            a2a.append((time.perf_counter() - t0) * 1e3)
        report["moe"]["all_to_all_ms"] = a2a[1:]
        report["moe"]["all_to_all_bytes"] = xd.numel() * 4
        del xd, params, xs, layer
        torch.cuda.empty_cache()
        # the GPipe pipeline: 2 stages, PIPE_M microbatches
        stacked, x = pipeline_inputs(dev)
        stage = {k: v.clone().requires_grad_(True)
                 for k, v in shard_pipeline_params(stacked, group).items()}
        xp = x.clone().requires_grad_(True)
        pipe = make_pipeline(group, mlp_stage, PIPE_M)

        def pipe_step():
            for v in (xp, *stage.values()):
                v.grad = None
            y = pipe(stage, xp)
            (y ** 2).sum().backward()
            return y.detach()

        pipe_step()  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(MOE_STEPS):
            t0 = time.perf_counter()
            y = pipe_step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        whole = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
        xo = x.clone().requires_grad_(True)
        y_ref = pipeline_oracle(mlp_stage, whole, xo)
        (y_ref ** 2).sum().backward()
        report["pipeline"] = {
            "step_ms": times, "step_ms_median": statistics.median(times),
            "vs_oracle": {}}
        hold_rel(f"pipeline rank {rank} vs pipeline_oracle",
                 {"y": y, "dx": xp.grad,
                  **{f"d{k}": v.grad for k, v in stage.items()}},
                 {"y": y_ref.detach(), "dx": xo.grad,
                  **{f"d{k}": v.grad[rank:rank + 1]
                     for k, v in whole.items()}},
                 report["pipeline"]["vs_oracle"])
    finally:
        distributed.shutdown()
    np.savez(os.path.join(out, f"rank{rank}.npz"))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    return 0


def moe_summary(card, moe) -> dict:
    """The ``moe`` line: phase 19's numbers beside the card."""
    w1, w2 = moe["world1"], moe["world2_gloo"]
    return {
        "card": card, "step_ms": w1["step_ms_median"],
        "step_bound_ms": w1["step_bound_ms"],
        "forward_bound_ms": w1["forward_bound_ms"],
        "step_tflop": w1["flops"]["step"] / 1e12,
        "peak_device_bytes": w1["peak_device_bytes"],
        "idle_share": w1["step_profile"]["idle_share"],
        "forward_parts": w1["forward_parts"],
        "vs_oracle_rel_err": w1["vs_oracle"]["rel_err"],
        "y_vs_float64_oracle_rel_err": w1["y_vs_float64_oracle_rel_err"],
        "block_ms": moe["block"]["block_ms"],
        "block_max_abs_err": moe["block"]["max_abs_err"],
        "world2_step_ms": max(r["step_ms_median"] for r in w2["ranks"]),
        "world2_all_to_all_ms": [statistics.median(r["all_to_all_ms"])
                                 for r in w2["ranks"]],
        "world2_vs_world1_rel_err": [r["vs_world1"]["rel_err"]
                                     for r in w2["ranks"]],
        "phase_seconds": moe["seconds"]}


def drive_moe(dev) -> tuple:
    """Phase 19 (the module docstring): (a) and (b) in this process, (c)
    as two ``--moe-rank`` processes. Returns the ``moe`` and ``pipeline``
    reports."""
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        moe = {"world1": drive_moe_world1(dev, flush, tmp)}
        del flush
        torch.cuda.empty_cache()
        moe["world1"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe["block"] = drive_moe_block(dev)
        torch.cuda.empty_cache()
        moe["block"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        spec = {"name": "moe_world2", "world": 2, "init": f"file://{tmp}/pg",
                "backend": "gloo", "devices": ["cuda:0"] * 2}
        reports, _ = run_ranks(spec, tmp, "--moe-rank")
        world2_s = time.perf_counter() - t0
    moe["world2_gloo"] = {
        "ranks": [r["moe"] for r in reports], "seconds": world2_s,
        "nccl": "not run: NCCL at world 2 needs a second card"}
    bubble = PIPE_M / (PIPE_M + PIPE_STAGES - 1)
    pipeline = {
        "stages": PIPE_STAGES, "D": PIPE_D, "batch": PIPE_BATCH,
        "microbatches": PIPE_M, "bubble_efficiency": bubble,
        "backend": reports[0]["backend"],
        "ranks": [r["pipeline"] for r in reports],
        "step_ms_median": max(r["pipeline"]["step_ms_median"]
                              for r in reports),
        "nccl": "not run: NCCL at world 2 needs a second card"}
    return moe, pipeline


def kernel_times(kernels, dev) -> dict:
    """``--times``: the kernels' times at the main path's shapes (as phases
    7, 10 and 11 take them, the forward twice) beside SDPA's forward,
    ``index_add_`` and the launch floor."""
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
    packed = contrib[:, None].repeat(1, FM_COLS)
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
            "coo_segment_sum_fm": time_ms(lambda: kernels.coo_segment_sum(
                packed, row_ids, CRITEO_BATCH), flush),
            "index_add_fm": time_ms(lambda: torch.zeros(
                CRITEO_BATCH, FM_COLS, device=dev).index_add_(
                    0, ids64, packed), flush),
            "fused_linear_grads": time_ms(lambda: kernels.fused_linear_grads(
                *dense, objective="logistic"), flush),
            "tokenize_boundaries": time_ms(
                lambda: kernels.tokenize_boundaries(chunk), flush),
            "launch_floor_ms": launch_floor_ms(kernels, dev, flush),
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
    if sys.argv[1:2] == ["--fit-rank"] and len(sys.argv) == 4:
        return fit_rank(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--group-rank"] and len(sys.argv) == 4:
        return group_rank(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--snap-rank"] and len(sys.argv) == 3:
        return snap_rank(sys.argv[2])
    if sys.argv[1:2] == ["--recover-rank"] and len(sys.argv) == 3:
        return recover_rank(sys.argv[2])
    if sys.argv[1:2] == ["--moe-rank"] and len(sys.argv) == 4:
        return moe_rank(int(sys.argv[2]), sys.argv[3])
    require(not sys.argv[1:], "unknown arguments %s (only --times)",
            sys.argv[1:])
    # phases 5-6 write the fit files here, and phases 13-14 read them again
    with tempfile.TemporaryDirectory() as fit_dir:
        return smoke(fit_dir)


def smoke(fit_dir: str) -> int:
    """Phases 1-19 (the module docstring), with the fit files in
    ``fit_dir``."""
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
    fused = [n for name, n in spills.items()
             if "fused_linear_grads_kernel" in name]
    require(fused == [0], "fused_linear_grads_kernel: ptxas spills %s",
            fused)
    torch.cuda.synchronize()

    # ---- 3. fused_linear_grads vs plain ------------------------------------
    fused_err = None
    main_args = None
    for rows, features in ((16384, 29), (1000, 29), (4096, 2048)):
        for objective in ("squared", "hinge"):
            fused_case(kernels, dev, rows, features, objective, True, 1)
        err, args = fused_case(kernels, dev, rows, features, "logistic",
                               False, 2)
        report = {"fused_linear_grads": [rows, features],
                  "logistic_max_abs_err": err}
        if (rows, features) == (1000, 29):
            report["lost_last_tile_tol_ratio"] = read_lost_tile(kernels, args)
        print(json.dumps(report), flush=True)
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
    paths, fit_params = {}, {}
    fit_files = {"dense": os.path.join(fit_dir, "higgs.svm"),
                 "csr": os.path.join(fit_dir, "criteo.svm")}
    write_higgs(fit_files["dense"], HIGGS_ROWS, seed=11)
    paths["dense"], fit_params["dense"] = drive_path(
        kernels, "dense", "fused_linear_grads", fit_files["dense"], "dense",
        HIGGS_BATCH, HIGGS_FEATURES + 1, HIGGS_ROWS)
    torch.cuda.synchronize()
    print(json.dumps({"dense": paths["dense"]}), flush=True)
    write_criteo(fit_files["csr"], CRITEO_ROWS, seed=12)
    paths["csr"], fit_params["csr"] = drive_path(
        kernels, "csr", "coo_segment_sum", fit_files["csr"], "csr",
        CRITEO_BATCH, CRITEO_DIM + 1, CRITEO_ROWS)
    torch.cuda.synchronize()
    print(json.dumps({"csr": paths["csr"]}), flush=True)

    # ---- 7. timings ----------------------------------------------------------
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    x, label, weight, w, b = main_args
    rows, features = x.shape
    ops = one_call_ops(lambda: kernels.fused_linear_grads(
        x, label, weight, w, b, "logistic"))
    require_one_kernel(ops, "fused_linear_grads",
                       "fused_linear_grads_kernel")
    if ops["profiler"] is None:
        print("torch.profiler traced no device operation (no CUPTI "
              "activity); the CUDA graph's count stands alone",
              file=sys.stderr, flush=True)
    floor = launch_floor_ms(kernels, dev, flush)
    print(json.dumps({"fused_linear_grads_device_ops": ops,
                      "launch_floor_ms": floor}), flush=True)
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
        "launch_floor_ms": floor,
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

    # ---- 13. the distributed fit -------------------------------------------
    distributed = drive_distributed(kernels, dev, fit_files, fit_params)
    torch.cuda.synchronize()
    print(json.dumps({"distributed": distributed}), flush=True)

    # ---- 14. GBDT on the card ----------------------------------------------
    t0 = time.perf_counter()
    gbdt_out = drive_gbdt(kernels, dev, fit_files["dense"])
    torch.cuda.synchronize()
    # ---- 14 (c) and 15: world 2 over gloo, then the one-process checks -----
    group = drive_group(gbdt_out)
    gbdt_out["world2_gloo"] = group["gbdt_world2_gloo"]
    for k in ("edges", "world1_margin"):
        del gbdt_out[k]
    gbdt_out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"gbdt": gbdt_out}), flush=True)
    t0 = time.perf_counter()
    sharded = drive_sharded(kernels, dev)
    sharded["feature_sharded"] = group["feature_sharded"]
    torch.cuda.synchronize()
    sharded["seconds"] = time.perf_counter() - t0
    print(json.dumps({"data_parallel_rest": sharded}), flush=True)

    # ---- 16. FM on the card ------------------------------------------------
    t0 = time.perf_counter()
    fm_file = os.path.join(fit_dir, "criteo.libfm")
    write_libfm(fm_file, CRITEO_ROWS, seed=12)
    fm_out, fm_row, fm_start = drive_fm(kernels, dev, fm_file)
    fm_out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"fm": fm_out}), flush=True)

    # ---- 17. snapshots and resume ------------------------------------------
    t0 = time.perf_counter()
    snaps = drive_snapshots(fit_files["csr"], fm_file, fm_start, fit_dir)
    torch.cuda.synchronize()
    snaps["seconds"] = time.perf_counter() - t0
    print(json.dumps({"snapshots": snaps}), flush=True)

    # ---- 18. fault-tolerant distributed training ---------------------------
    t0 = time.perf_counter()
    recovery = drive_recovery(fit_files["csr"], fit_dir)
    recovery["seconds"] = time.perf_counter() - t0
    print(json.dumps({"recovery": recovery}), flush=True)

    # ---- 19. expert-parallel MoE and the GPipe pipeline --------------------
    t0 = time.perf_counter()
    moe, pipeline = drive_moe(dev)
    moe["seconds"] = time.perf_counter() - t0
    print(json.dumps({"moe_detail": moe}), flush=True)

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
            ingest["kernel_token_spans"]["seconds"],
        "pipelined_parser": ingest["parsers"]["pipelined"]["mb_per_s"],
        "threaded_parser": ingest["parsers"]["threaded"]["mb_per_s"]}}))
    print(json.dumps({"distributed_rows_per_s": {"card": card, **{
        world: {flavor: {layout: fit["rows_per_s"]
                         for layout, fit in layouts.items()}
                for flavor, layouts in report["fits"].items()}
        for world, report in distributed.items()
        if isinstance(report, dict)}}}))
    print(json.dumps({"gbdt_summary": {
        "card": card, "fit_seconds": gbdt_out["fit"]["seconds"],
        "ms_per_tree": gbdt_out["fit"]["ms_per_tree"],
        "rows_trees_per_s": gbdt_out["fit"]["rows_trees_per_s"],
        "peak_device_bytes": gbdt_out["fit"]["peak_device_bytes"],
        "level_histogram_ms": gbdt_out["level_histogram"]["ms"],
        "level_histogram_bound_ms": gbdt_out["level_histogram"]["bound_ms"],
        "tree_idle_share": gbdt_out["tree_profile"]["idle_share"],
        "fit_uri_seconds": gbdt_out["fit_uri"]["seconds"],
        "world2_rows_trees_per_s":
            gbdt_out["world2_gloo"]["rows_trees_per_s"]}}))
    print(json.dumps({"fm_summary": {
        "card": card, "rows_per_s": fm_out["fit"]["rows_per_s"],
        "ms_per_step": fm_out["fit"]["ms_per_step"],
        "feed_only_seconds": fm_out["fit"]["feed_only_seconds"],
        "peak_device_bytes": fm_out["fit"]["peak_device_bytes"],
        "step_idle_share": fm_out["fit"]["step_profile"]["idle_share"],
        "coo_segment_sum_fm_ms": fm_row["ms"],
        "coo_segment_sum_fm_bound_ms": fm_row["bound_ms"],
        "index_add_fm_ms": fm_row["library_ms"],
        "snapshot_capture_ns": snaps["fm_injected"]["capture_ns"],
        "snapshot_write_ns": snaps["fm_injected"]["write_ns"]}}))
    print(json.dumps({"recovery_summary": {
        "card": card, "clean_rows_per_s": recovery["clean"]["rows_per_s"],
        "clean_s": recovery["clean"]["seconds"],
        "crash_s": recovery["crash"]["seconds"],
        "crash_vs_clean": recovery["crash"]["vs_clean"],
        "crash_to_replay_s": recovery["crash"]["crash_to_replay_s"],
        "relaunch_s": recovery["crash"]["relaunch_s"]["total"],
        "elastic_s": recovery["elastic"]["seconds"],
        "elastic_vs_clean": recovery["elastic"]["vs_clean"],
        "kill_to_replay_s": recovery["elastic"]["kill_to_replay_s"],
        "device_routes": {b: d["routes"] for b, d in
                          recovery["device"].items() if isinstance(d, dict)},
        "device_crash_to_replay_s": {
            b: d["crash_to_replay_s"] for b, d in
            recovery["device"].items() if isinstance(d, dict)},
        "phase_seconds": recovery["seconds"]}}))
    print(json.dumps({"moe": moe_summary(card, moe)}))
    print(json.dumps({"pipeline": dict(pipeline, card=card)}))
    print(json.dumps({"seconds": time.perf_counter() - started}))
    print(json.dumps({"kernels": [fused_row, seg_row] + flash_rows
                      + [token_row, fm_row]}))
    print("card:", card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``dmlc_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and exits non-zero without one. With ``--times``
it only builds the kernels and prints one ``{"times": ...}`` line: each
kernel's cold-L2 CUDA-event time at the main path's shapes beside its
yardstick (``coo_segment_sum`` also at a full bucket), and the launch
floor (``launch_floor_ms``: one and two launches
of an empty kernel, timed the same way), to compare two checkouts in turns
on one card. With ``--remote-read`` it only builds the kernels and prints
one ``{"remote_read": ...}`` line: phase 12's file read
``REMOTE_READ_REPS`` times from the fake ``s3://`` and from the local
disk, in turns, through the InputSplit alone and through
``create_row_block_iter`` on the card (MB/s of each), to compare the
remote read route of two checkouts in turns on one card. With
``--pool-threads`` it only prints one ``{"pool_threads": ...}`` line:
phase 12's file parsed on the card by pools of the parse pool's process
function at 1, 2 and 4 processes, started with the port's one-thread
environment and with the libraries' defaults, in turns (MB/s, seconds a
chunk). Phases, each
ending in ``torch.cuda.synchronize()``; any failure ends the run with a
non-zero exit and no result line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``dmlc_tpu_torch/ops/csrc`` (nvcc, sm_90a)
   and print ptxas's registers and spills of each kernel; every flash
   kernel (``flash_fwd_kernel`` and ``flash_bwd_kernel``, each at D 32, 64
   and 128, causal or not), ``fused_linear_grads``, both
   ``seg_sum_kernel`` variants of ``coo_segment_sum`` ([E] and [E, C])
   and ``sorted_segment_sum``'s ``sorted_sum_kernel`` must show 0 spill
   bytes; where the toolkit has ``cuobjdump``, the warpgroup products
   (``HGMMA``) in each flash kernel variant's SASS (``flash_fwd_kernel``
   and ``flash_bwd_kernel``, 12 in all) are counted and must be there;
   then the native core from ``dmlc_tpu_torch/native/csrc`` (g++, one
   process a source), its seconds and SIMD tier printed, loaded from
   ``native/_build/``;
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
   row 0, ids past the last row, a row longer than 32 x 32 entries, and
   where the kernel's tiles of 1024 entries can go wrong: a tile boundary
   between two rows, an empty row at a tile boundary, a row over three
   tiles, a tile of -1 pad only, the main-path bucket's padded last row of
   8,231 entries, a single ragged tile): bit-equal on integer data, the
   same bits twice; the Criteo batch at ``SEG_WIDE_COLS`` columns (two
   column passes) bit-equal, each column equal to the [E] call; on float
   data the kernel's bits equal ``seg_sum_schedule``'s (its order,
   modelled on the CPU) at the Criteo batch as [E] and [E, 17] and at a
   batch that fills the bucket (40 entries a row); ``spmv_transpose``
   gives the same bits twice, and on integer values and row gradients the
   CPU route's bits; ``sorted_segment_sum`` [E] (a stable sort of the
   ids, then one kernel over the sorted entries) on integer data gives the
   CPU route's bits, the same bits twice and on a second stream, one
   launch a call, every row written, at ``feature_sum_cases`` (no entries,
   one id holding every entry, a run over more than 32 tiles, ids in no
   order) and at one step of the criteo-fm cell (``cell_feature_ids``:
   638,976 Zipf ids of 1,000,001); there, on float data, the bits of its
   order (``sorted_sum_order``: ``index_put_``'s), and its CUDA-event
   time (cold L2) beside the sort's and ``index_put_`` accumulate's
   (``feature_sum_row``);
5. the dense path: ``LinearLearner(objective="logistic").fit_uri`` over a
   seeded HIGGS-shaped LibSVM file (262,144 rows x 28 features), batch
   16384, 2 epochs, on the card and on the CPU, through the native route
   (``NativePipelineParser``, each epoch's batches staged in C++: the
   tokenizer launches 0 times); the launch count of
   ``fused_linear_grads`` must equal the step count; the loss must fall;
   the card's loss history must match the CPU's within rtol 1e-5 and its
   params within a relative norm of 1e-5; the same fit on the CPU at half
   the learning rate (a step whose gradient is halved) is read against
   that limit too, and must fail it; the same batches are then fed to the
   card with no step, to time the host's share;
6. the csr path: the same over a seeded Criteo-shaped file (65,536 rows x
   39 skewed ids in [1, 2^20], labels from a planted sparse rule), batch
   8192, 2^20 + 1 features; the launch counts of ``coo_segment_sum`` and
   ``sorted_segment_sum`` must each equal the step count;
7. one call of ``fused_linear_grads``, and one of ``coo_segment_sum`` at
   the csr [327,680] and FM [327,680, 17] shapes, must each run exactly
   one kernel on the card and nothing else (no memset), counted from a
   CUDA graph captured around the call (after a warm-up call on its
   stream, which makes the wrapper's counters) and, where CUPTI traces the
   card, under torch.profiler too; the launch floor (one and
   two launches of the empty kernel of ``csrc/launch_floor.cu``); per
   kernel: CUDA-event times (cold L2) of the kernel, its plain version and
   the one PyTorch call that computes the same function where there is
   one, beside the least time the card could take (``fused_linear_grads``'s
   row carries the floor as ``launch_floor_ms``);
8. the flash-attention kernels (forward and backward) against their plain
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
10. at the path's shape (1, 16384, 8, 8, 128, causal): the two flash
   kernels held against the plain version on the same inputs (the
   ``max_abs_err`` of their rows) and the one-TF32-pass faults read there,
   and their times beside the plain version's,
   ``scaled_dot_product_attention``'s (its backward alone for the
   backward row) and their bound. Every flash row's ``bound_ms`` is the
   kernels' tensor-core route (3 TF32 products per f32 product at 495
   TFLOP/s; the backward's five products), with the f32 CUDA-core figure
   under ``f32_cuda_core_bound_ms``. One call of each wrapper must run
   exactly one kernel and no memset (``flash_fwd_kernel``,
   ``flash_bwd_kernel``), counted as phase 7 counts
   (``flash_fwd_device_ops``, ``flash_bwd_device_ops``).
   ``flash_timing_extra`` adds
   ``port_bwd_ms`` (delta and the kernel, as the autograd Function runs
   them) beside ``sdpa_bwd_ms``, ``kernels_bwd_ms`` and ``sdpa_backend``,
   which an earlier ``sdpa_backend`` line names from the kernels of one
   torch.profiler step;
11. ``tokenize_boundaries`` against its plain version on the card, masks
   equal bit for bit: the sizes of ``TOKEN_SIZES`` (ragged n, separators
   only, none, an 8 MiB chunk), chunks starting 1-15 bytes into a buffer,
   and the first 8 MiB chunk of a seeded Criteo-shaped file (262,144
   rows, ~120 MB); masks that leave ':' out of the separators must differ
   from the kernel's there. The kernel and its plain version are timed at
   that chunk, and the ``kernel_token_spans`` route step by step;
12. the Python stack's ingest path (``python_stack_parser``: the
   ``PipelinedParser`` over an unthreaded parser that ``create_parser``
   builds where the native route declines): a ``BasicRowIter`` over that
   file on the card and on the CPU must give the same RowBlock, bit for
   bit, and the tokenizer must launch once for each non-empty chunk part
   handed to ``LibSVMParser.parse_chunk`` (counted here); then the same
   through a ``DiskRowIter`` cache, cold (parses, launches) and warm (pages
   only, no launch). MB/s of each route, and the seconds
   ``kernel_token_spans`` takes over all the file's chunks; then the MB/s
   of that ``PipelinedParser`` (chunks parsed whole on its worker threads)
   beside a ``ThreadedParser`` built directly over the same
   ``LibSVMParser`` (each chunk split over its pool): the same rows, one
   tokenizer launch a chunk part;
13. the distributed fit, over phases 5-6's files: world 1 over NCCL
   (``parallel.distributed.initialize``, ``LinearLearner(group=WORLD)``,
   the data-parallel step's ``bucketed_all_reduce``) must give phases
   5-6's bits, with one launch a step and no tokenizer launch (the native
   route), and one step runs under torch.profiler (``step_device_ops``: what the
   NCCL all_reduce puts on the card); world 2 as two rank processes
   (``--fit-rank``) on the one card over gloo (NCCL refuses two ranks on
   one GPU), each reading its own byte range with 3/4 of phases 5-6's
   batch (``DIST_BATCH``): ``sync="spmd"`` and ``sync="host"`` (the port's
   ``RabitTracker`` and socket engine: the dense bucket takes the tree, the
   csr bucket the ring) on the card and ``sync="spmd"`` on the CPU. Both
   ranks must end with the same bits, the two card flavors with the same
   bits, within ``FIT_PARAM_REL`` of the CPU's; each rank launches its
   step's kernel once a step, as many steps as the other, and the
   tokenizer 0 times (the native route). World 2 over NCCL runs where a second card
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
   of equal structure counted; ``fit_uri`` over phase 5's HIGGS file on
   the native route, no tokenizer launch (both passes); then world 2 on the one
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
   ``DeviceFeed(create_parser(format libfm))``, the native route (every
   feed of the phase staged in C++): (a) the column
   ``coo_segment_sum`` at [327,680, 17] (8192 rows) and at
   ``seg_sum_edge_cases`` with C in ``FM_SEG_COLS``, bit-equal to its
   plain version on integer data, each column bit-equal to the [E] call,
   the same bits twice; (b) ``feature_segment_sum`` at [E, 8] the same bits
   twice; phase 4's ``sorted_segment_sum`` checks at [E, 8] and at FM's
   packed [E, 9] (gw apart, beside dv's K columns), and their times at
   the criteo-fm cell's step beside the ``index_put_`` route's; (c) 2
   epochs on the card from params drawn once on the host: one
   ``coo_segment_sum`` and one ``sorted_segment_sum`` launch a step, the
   loss falls by ``MIN_LOSS_FALL``, two fits give the same bits, the loss
   history within ``FM_LOSS_RTOL``
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
   launches. The device engine's world 2 runs in phase 25 (b). In every
   job each process launches ``coo_segment_sum`` once a step and the
   tokenizer 0 times (the native route); (e) rows/s of (a) and the seconds of (b)
   and (c) against (a);
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
   ``KERNELS`` is on this path (the reference computes it with XLA ops);
20. the observability layer on the card (``drive_obs``): (a) phase 5's
   dense fit, phase 6's csr fit, phase 16's FM fit and phase 14's GBDT fit
   (1,048,576 × 28, depth 6, ``OBS_GBDT_TREES`` trees), each once with
   every observability setting
   off and once fully armed (``DMLC_TPU_TRACE``,
   ``DMLC_TPU_METRICS_EXPORT`` as JSONL or Prometheus,
   ``DMLC_TPU_FLIGHTREC``, ``DMLC_TPU_AUDIT=full``, a device-step sample
   every ``OBS_SAMPLE_N`` steps; the cost records forgotten first, so
   each site's first call is recorded under the dispatch mode), the
   launch counts set to 0 before each, both fits of a pair on the Python
   stack (``python_stack_parser``; with the audit armed ``create_parser``
   keeps that stack, checked here): losses, params (trees) and
   launches bit-identical; the kernel of the
   path launched once a step; ``dmlc_fit_steps_total`` = the steps; one
   goodput window an epoch with a binding (the linear and FM windows with
   ``mfu`` and ``hbm_fraction``, whose unrounded values must lie in (0,
   1]); the trace's flow of one chunk through io_read, parse, stage,
   consume and train_step; the exports parse; the audit's epoch
   self-check clean and the two epochs' io_read / parse / batch chains
   equal; the card's chains equal a CPU-route fit's on the dense and csr
   files; (b) ``dmlc_device_hbm_bytes`` = ``memory_allocated`` at the
   sample, ``peak_hbm_bytes()`` > 0, one cost record a site and signature
   and none more over a second epoch, the probed f32 matmul and memory
   rates beside the data sheet's, ``dmlc_step_device_ms`` sampled at
   least twice, one dense step under torch.profiler beside the feed's
   consume time a batch (the goodput ledger's device_step), and a
   ``capture_profile(1.0)`` during a fit whose trace holds CUDA kernels;
   (c) the csr fit in a child process (on the Python stack, whose parse
   workers pass the ``parse.chunk`` faultpoint) with ``OBS_FAULT``
   injected and the recorder armed must die and leave ``fault.injected`` in
   ``flightrec-rank0.json``; (d) rows/s of the dense and csr fits and
   rows·trees/s of the GBDT fit with the defaults, with
   ``DMLC_TPU_METRICS=0`` and fully armed, the median of ``OBS_RUNS`` runs
   each, the linear fits on the Python stack in every setting;
21. the binary ingest formats on the card (``drive_formats``): (a) phase
   12's file converted on the card by ``convert_to_recordio`` (row groups
   of ``REC_ROWS`` rows, then ``build_index``) and by ``bake_dataset``
   (``BAKE_PARTS`` shard files, windows of ``SHARD_ROWS`` rows), both
   parsing on the native route (no tokenizer launch), each file byte-equal
   to the same conversion on the CPU route; (b) ``create_row_block_iter``
   on the card
   over the text, the ``.rec`` (``?format=recordio``), the ``.dtsh`` parts
   (mmap, then ``DMLC_TPU_SHARD_MMAP=0``) and a ``shuffle_chunks`` text
   read, and ``create_parser`` over a text ``#cachefile`` (the native
   row-group cache at ``<cache>.rowrec``) cold and warm: every unshuffled
   route's rows equal the text route's bit for bit, the shuffled read (1 MB
   chunks in a seeded order) holds the same rows in another order, and no
   route launches the tokenizer; (c) phase 6's csr fit from its ``.rec`` and ``.dtsh``: losses
   and params bit-identical to phase 6's text fit on the card,
   ``coo_segment_sum`` once a step, no tokenizer launch; (d) the shuffled
   shard fit (``RESUME_EPOCHS`` epochs) in a ``--snap-rank`` child that
   takes a SIGTERM as it enters epoch ``SIGNAL_AT_EPOCH`` and exits 75,
   relaunched with ``resume=True``: its saved model equals the
   uninterrupted shuffled fit's byte for byte. Seconds of each
   conversion, MB/s and rows/s of each route, rows/s of each fit.

22. remote filesystems on the card (``drive_remote``): the repo's fake
   servers (``tests/fake_object_store.py`` for ``s3://`` and ``gs://``,
   ``tests/fake_webhdfs.py``, ``tests/fake_azure.py``) on 127.0.0.1,
   the port's backends pointed at them through their environment names
   (``no_proxy`` covers the fakes; each must have served requests), the
   files of phases 5, 6 and 12 uploaded, phase 6's and phase 5's as two
   part objects under one prefix: (a) phase 12's file read from
   ``s3://`` by ``create_row_block_iter`` on the card (the native push
   route: the readahead reader pushes the bytes into the native pipeline,
   no tokenizer launch), its rows' digest equal to phase 26's native read
   of the local file, and phase 6's file read
   from ``s3://``, ``hdfs://`` and ``azure://``, rows equal to the local
   read's bit for bit, launches equal; (b) phase 6's csr fit from the
   three and phase 5's dense fit from ``gs://``: losses and params
   bit-identical to phases 6 and 5, ``coo_segment_sum`` /
   ``fused_linear_grads`` once a step, the tokenizer as in phases 5-6 (0);
   (c) the ``s3://`` csr fit again with every response over
   ``REMOTE_FAIL_AFTER`` bytes cut (a dropped connection) and
   ``REMOTE_FAULTS`` armed through ``DMLC_TPU_FAULTS``: the same bits,
   ``io.read`` retries above 0; (d) the csr fit's first epoch committed
   as a job snapshot to ``s3://`` and to a local directory (the parts,
   manifest and LATEST byte-equal), ``fit_uri(resume=True)`` from the
   ``s3://`` snapshot equal to phase 6's fit bit for bit, a
   ``CheckpointManager`` round trip through ``mem://``, and
   ``LinearLearner.save`` to ``s3://`` byte-equal to the local save, its
   ``load`` the same params. MB/s of each read beside phase 12's, rows/s
   of each fit beside the local one, seconds of a commit and a restore,
   the retries of (c).

23. the fault-tolerant data service on the card (``drive_data_service``):
   a ``DataDispatcher`` a fleet in this process, ``python -m
   dmlc_tpu_torch.tools serve --dispatcher`` workers on the card (each
   parses its leased InputSplit parts through ``create_parser`` on the
   card and reports its kernel launches at exit), consumers here; every
   socket on 127.0.0.1, ``DATA_CHUNKS`` chunks a job, a fleet fit one job
   an epoch. (a) phase 12's file through a one-worker and a two-worker
   fleet, drained by one ``RemoteBlockParser``: the rows' order-insensitive
   digest equal to phase 26's native read (each worker parses its leased
   parts on the native route); (b) phase 5's dense and phase 6's csr
   fit fed by the one-worker fleet (a ``DeviceFeed`` over a dispatcher
   consumer, the exactly-once acks back): losses and params bit-identical
   to phases 5 and 6, ``fused_linear_grads`` / ``coo_segment_sum`` once a
   step, chunks in seq order; the csr fit through the two-worker fleet
   bit-identical to a local fit replayed over ``create_parser(file, k,
   N)`` in the order the consumer received the chunks; (c) that fit again
   with ``DATA_CRASH`` in the first worker's environment: the worker exits
   ``EXIT_WORKER_CRASHED`` (43), the dispatcher declares it dead and requeues its
   lease, the consumer fails over; the rows' digest equal to the clean
   run's, the fit bit-identical to its replay, every chunk acked, at least
   one requeued; (d) jobs ``a`` and ``b`` over phase 6's file through one
   worker with the source cache on: both digests equal the local read,
   the worker's tokenizer launches 0, ``chunks_parsed`` N. Every
   clean fleet ends with all chunks acked and none requeued, and no
   worker launches the tokenizer (the native route); each worker's exit code is the one its schedule expects. MB/s
   of each fleet beside phase 12's, rows/s of each fit beside phases 5-6,
   seconds of the crashed fit beside the clean one. The consumers' feeds
   run inline (``host_prefetch=0``), as this phase first measured them.
24. the feed's producer thread and transfer window (``drive_feed``): (a)
   phases 5-6's fits over a ``DeviceFeed`` at each ``FEED_MODES`` entry
   (depth 0 and the default 2 in turns 0, 2, 2, 0, the csr fit also at
   window 2): losses and params bit-identical to phases 5-6,
   ``fused_linear_grads`` / ``coo_segment_sum`` once a step, the
   tokenizer as in phases 5-6; rows/s, the last epoch's
   ``stall_breakdown`` and the pool's allocated / reused counts of each
   turn; (b) phase 23's fleet-fed fits (one and two
   workers, clean and with ``DATA_CRASH``) with the consumers' feeds at
   the default depth, held as phase 23 holds them: rows/s beside phase
   23's, requeues, each worker's tokenizer launches; (c) in process,
   through their ``main(argv)``: ``parse``, ``dataiter`` and ``strtonum``
   over a ``FEED_SLICE_BYTES`` slice of phase 12's file and
   ``boosted_trees.py`` over phase 5's first ``GBDT_EXAMPLE_ROWS`` rows
   (the native route: each exits 0 with no tokenizer launch), ``strtonum
   --route python`` (the tokenizer), ``criteo_sparse.py`` over phase 6's
   file (``coo_segment_sum``) and ``long_context.py`` at T =
   ``LONG_CONTEXT_T`` (``flash_attention_fwd``): each exits 0 having
   launched its kernel.
25. the status plane and the launchers on the card
   (``drive_status_plane``): jobs of ``python -m
   dmlc_tpu_torch.tracker.submit`` whose ranks are ``chip_smoke.py
   --plane-rank`` or ``--recover-rank`` processes. (a) ``--cluster gpu
   --gpu-hosts localhost -n 1 --status-port P`` with ``DMLC_TPU_TRACE``
   and ``DMLC_TPU_AUDIT=full``: phase 6's csr fit over a one-rank NCCL
   group from the launcher's coordinator; while it runs every endpoint
   of the plane answers 200 with its content type (an unknown path 404),
   ``/profile?seconds=3`` sent before its first heartbeat makes the rank
   capture ``torch.profiler`` at its first epoch boundary, and the
   window's trace must hold ``coo_segment_sum``'s CUDA kernel; /workers,
   the merged /trace and /metrics show the rank, /audit has no fork,
   /goodput a window; ``obs-top --once`` shows rank 0 and ``obs-report
   --status`` exits 0 against the live server, ``obs-report --trace`` /
   ``--diff`` over the merged and the rank's own trace after the job; the
   armed audit keeps the rank on the Python stack: losses and params
   bit-identical to phase 26's Python-stack csr fit, ``coo_segment_sum``
   once a step, the tokenizer once a chunk part; (b) ``--cluster gpu
   --gpu-hosts localhost,localhost --max-attempts 3 --status-port P``:
   phase 18's ranks on the device engine (``sync="spmd"`` over gloo, both
   ranks on the one card), clean and with rank 0 crashing as it starts
   round ``RECOVER_CRASH_EPOCH`` and rank 1 a round later, relaunched by
   the launcher: every digest equal to phase 18 (a)'s, /workers both ranks
   (a relaunched rank's publisher counts its epochs from 1 again), the
   merged /trace spans of both ranks in one monotonic timeline, /metrics
   both ``rank=`` labels, each survivor's route and the seconds from a
   crash to the replayed round; (c) ``python -m dmlc_tpu_torch.tools
   dispatch - --status-port 0`` with jobs ``csr0``, ``csr1`` (phase 6's
   file) and ``tail``, one ``serve`` worker: phase 6's csr fit one job an
   epoch, bit-identical to phase 6, then /data shows both jobs' lease
   tables acked; ``tail`` drained; the worker launched no tokenizer (the
   native route); (d) ``--cluster ssh`` with a fake ``ssh``
   on a temporary PATH that runs the remote command with ``bash -c``
   here: one epoch of phase 6's fit, bit-identical to the same epoch in
   process; (e) one job launched as in (a) (no trace, no audit), its rank
   fitting in turns ``PLANE_COST_TURNS``, publishing to the plane only in
   the 1 turns (a rank of a job without ``--status-port`` never
   publishes): every turn bit-identical to phase 6, rows/s of each, no
   threshold.

26. the native route beside the Python stack (``drive_native``; it runs
   after phase 16, whose files it reads, and phases 22, 23 and 25 read
   its results): (a) phase 12's file through ``create_parser`` on the
   card (a ``NativePipelineParser``, no tokenizer launch, its ``stats()``
   seven counters) and on the CPU, bit for bit; against phase 12's
   Python-stack RowBlock within the JAX package's limits for the two
   engines (offsets, indices equal; labels rtol 1e-6; values rtol 1e-5 /
   atol 1e-7: the native number scan is not correctly rounded for every
   string), with the share of values equal in bits; MB/s of both routes;
   (b) phases 5-6's dense and csr fits again on the Python stack:
   ``fused_linear_grads`` / ``coo_segment_sum`` once a step, the tokenizer
   once a chunk part, the loss histories within rtol 1e-5 of phases 5-6's
   native ones; rows/s and feed-only seconds of both routes; (c) phase
   16's FM fit on the Python stack (``LibFMParser``) beside phase 16's
   native one, loss histories within ``FM_LOSS_RTOL``; (d) a ``.rec``
   converted from phase 12's file and a libsvm ``#cachefile`` (cold, then
   warm) read on the native route, each the native text read's rows bit
   for bit, MB/s of each.
27. the Python stack's process parse pool (``drive_pool``; after phase
   26, whose Python-stack csr fit it repeats): (a) one ``spawn`` process
   alone (``probe_child``): the seconds to its first call (the
   interpreter and torch's import) and to its CUDA context, and the card
   memory the context holds (``torch.cuda.mem_get_info`` here before and
   while it lives); (b) phase 12's file through its ``PipelinedParser``
   on the card with its threads, then with ``procs=2`` and ``procs=4``
   (as many worker threads), two epochs each (``before_first`` keeps the
   pool): each epoch's block equal to phase 12's CPU route's bit for bit
   (its digest), one tokenizer launch for each non-empty chunk, made in a
   pool process on the card (none in this process), no process left
   after ``close()``; MB/s of each epoch (the first with the pool's
   start), seconds to the first block and the card memory the pool's
   contexts hold (free memory before the parser and after its first
   block); (c) phase 6's
   csr fit through ``create_parser(procs=2)`` → ``DeviceFeed`` →
   ``fit_feed``: losses and params bit-identical to phase 26's
   Python-stack csr fit, ``coo_segment_sum`` once a step, the tokenizer
   once a chunk; rows/s.

The native route is ``create_parser``'s for local files and one remote
filesystem (phases 5-6, 13-18, 21-24, and 25 but (a)); phase 12, phase
20's paired fits, phase 25 (a) (its audit armed) and phase 26's
comparisons run the Python stack, where the tokenizer launches once a
chunk part. The ``{"kernels": [...]}`` line has a row a kernel at its main
path's shape, ``coo_segment_sum_fm``, the same kernel at FM's [E, 17]
(launches from phase 16's fit), and ``coo_segment_sum_full_bucket``, the
csr shape with no padded tail (40 entries a row; launches the csr path's),
which keeps the padded tail's cost on record; the tokenizer's row adds
``pool_launches`` (phase 27's pooled reads) and ``coo_segment_sum``'s
``pool_fit_launches`` (phase 27's pooled fit). Before the last lines come the ``moe``
and ``pipeline`` lines (phase 19), the ``obs`` line (phase 20), the
``formats`` line (phase 21), the ``remote`` line (phase 22), the
``data_service`` line (phase 23), the ``feed`` line (phase 24), the
``plane`` line (phase 25), the ``native`` line (phase 26: MB/s, rows/s
and feed-only seconds of the native route beside the Python stack's, the
build's seconds and the SIMD tier), the ``pool`` line (phase 27: MB/s
of each epoch at 0, 2 and 4 processes, the seconds to the first block,
the contexts' card memory, a child's start and the pooled fit's rows/s),
the ``fleet_rounds`` line (the fleet-fed csr
fit's consumer in phases 23, 24 (b) and 25 (c), three fleet rounds of one
process: each epoch's feed stage times and fetch seconds) and
``phase_seconds`` (each phase's wall seconds); the last lines are the
``kernels`` line, the card line again, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
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
# tensor cores (csrc/flash_mma.cuh, the split; csrc/flash_hopper.cuh, wgmma)
TF32_PASSES = 3
# the one-TF32-pass faults must fail OUT_TOL (forward) and GRAD_TOL
# (backward) from this T on; below it (T = 33) they are only recorded
TF32_FAULT_MIN_T = 512

HIGGS_ROWS, HIGGS_FEATURES, HIGGS_BATCH = 262_144, 28, 16_384
CRITEO_ROWS, CRITEO_NNZ, CRITEO_DIM, CRITEO_BATCH = 65_536, 39, 1 << 20, 8192
# the feed's entry bucket of a Criteo batch (device/csr.round_up_bucket of
# 8192 x 39): the padded tail lands on the last row
SEG_BUCKET = 327_680
# one step of the criteo-fm benchmark configuration
# (perfbench/configs/criteo-fm.json): rows a batch, ids 0 .. 1,000,000,
# and the distinct values of each of the 39 fields
CELL_ROWS, CELL_FEATURES = 16_384, 1_000_001
CELL_FIELD_VALUES = (470,) * 13 + (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)
# FM's feature-direction sums: dv's K columns, and the packed call of gw
# beside them (``first_apart``)
FM_PACKED_COLS = 9
FEATURE_SUM_COLS = (8, FM_PACKED_COLS)
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
# a width that takes coo_segment_sum two passes of kColChunk (24) columns
SEG_WIDE_COLS = 40
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
# world-2 batch; (b) and phase 25 (b) crash a rank as it starts round 2,
# after two committed checkpoints, and phase 25 (b) crashes the other rank
# as it starts round 3; (c) kills rank 1 as it starts round 3: rank r
# passes the worker.step faultpoint r + 1 times before each round, so its
# 8th pass is rank 1's before round 3 (and no other rank reaches 8). Not
# fewer rounds: at 3, with the kill before round 1, the warm spare was
# still starting when rank 1 died and the job went on at world 1
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
# phase 21: phase 12's file converted to row groups of REC_ROWS rows and
# baked to BAKE_PARTS shard files of windows of SHARD_ROWS rows (the JAX
# package's defaults); the shuffled reads' seed; the resumed shard fit's
# epochs, the child paused (then signalled) as it enters SIGNAL_AT_EPOCH
REC_ROWS, SHARD_ROWS, BAKE_PARTS = 1024, 4096, 2
SHUFFLE_SEED = 7
RESUME_EPOCHS, SIGNAL_AT_EPOCH = 3, 2
# phase 22: each response of the faulted fit longer than REMOTE_FAIL_AFTER
# bytes is cut there (the ranged reader reconnects from the byte where it
# stopped), and one range-read attempt in ten fails by injection
REMOTE_FAIL_AFTER = 6 << 20
REMOTE_FAULTS = "io.read:p=0.1:seed=5"
REMOTE_READ_REPS = 3  # --remote-read: reads of each route, in turns
# phase 23: chunks a job (DMLC_TPU_DATA_CHUNKS's default); the crashing
# worker's fault (its third lease); the crash fleet's heartbeat-silence
# limit (the requeue waits for it); the tenants' worker's source cache,
# large enough to hold phase 6's whole file
DATA_CHUNKS = 16
DATA_CRASH = "service.worker_crash:nth=3"
DATA_CRASH_DEAD_S = 2.0
DATA_TENANT_CACHE_MB = 4096


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


@contextlib.contextmanager
def count_chunks():
    """The lengths of the non-empty chunks parsers read
    (``Parser.next_chunk``, on the consumer's thread) while the block runs:
    a pooled ``PipelinedParser`` hands each whole to a pool process, which
    launches the tokenizer once for it (``count_parts`` sees none of it)."""
    from dmlc_tpu_torch.data.parsers import Parser

    chunks, real = [], Parser.next_chunk

    def counting(self):
        chunk = real(self)
        if chunk:
            chunks.append(len(chunk))
        return chunk

    Parser.next_chunk = counting
    try:
        yield chunks
    finally:
        Parser.next_chunk = real


def hold_tokens(what, launches, parts, native=True) -> None:
    """The tokenizer on a read's route: the native route
    (``NativePipelineParser``) hands no chunk part to
    ``LibSVMParser.parse_chunk`` and launches it 0 times; the Python stack
    launches it once for each non-empty chunk part."""
    if native:
        require(launches == parts == 0, "%s: the native route launched the "
                "tokenizer %d times over %d chunk parts", what, launches,
                parts)
    else:
        require(launches == parts > 0, "%s: %d tokenizer launches for %d "
                "chunk parts", what, launches, parts)


@contextlib.contextmanager
def native_feeds():
    """The parsers whose batches the feed staged in C++
    (``DeviceFeed._host_batches_native``) while the block runs: a fit on the
    native route must show one a feed epoch."""
    from dmlc_tpu_torch.device import feed as feed_mod

    seen, real = [], feed_mod.DeviceFeed._host_batches_native

    def counting(self):
        seen.append(type(self._parser).__name__)
        return real(self)

    feed_mod.DeviceFeed._host_batches_native = counting
    try:
        yield seen
    finally:
        feed_mod.DeviceFeed._host_batches_native = real


def python_stack_parser(uri, device, part=0, nparts=1, data_format="auto",
                        nthread=2, procs=0):
    """The Python stack over ``uri``, as ``create_parser`` built it before
    the native route (and still builds it where that route declines): the
    unthreaded parser on ``device`` behind a ``PipelinedParser`` (with a
    pool of ``procs`` processes, and as many worker threads, if > 0)."""
    from dmlc_tpu_torch.data import PipelinedParser, create_parser

    return PipelinedParser(create_parser(uri, part, nparts, data_format,
                                         nthread=nthread, threaded=False,
                                         device=device), nthread=nthread,
                           procs=procs)


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


def sass_hgmma(library: str):
    """{kernel entry (mangled): HGMMA instructions} of every
    ``flash_fwd_kernel`` and ``flash_bwd_kernel`` variant in ``cuobjdump
    -sass`` of the kernels' library: the warpgroup products the build kept.
    None where the toolkit has no cuobjdump."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", library], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=300).stdout
    counts, entry = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            entry = line.split("Function :", 1)[1].strip()
            if "flash_fwd_kernel" in entry or "flash_bwd_kernel" in entry:
                counts[entry] = 0
            else:
                entry = None
        elif entry is not None and "HGMMA" in line:
            counts[entry] += 1
    return counts


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


def criteo_batch(dev, seed, per_row=CRITEO_NNZ):
    """A padded Criteo batch as the feed builds it: 8192 rows of 39
    entries (319,488) in a 327,680-entry bucket; at ``per_row`` = 40 the
    entries fill the bucket, with no padded tail."""
    from dmlc_tpu_torch.data.row_block import RowBlock
    from dmlc_tpu_torch.device.csr import pad_to_bucket

    rng = np.random.RandomState(seed)
    rows = CRITEO_BATCH
    counts = np.full(rows, per_row)
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
        # where the kernel's tiles of 1024 entries can go wrong
        ("a tile boundary between two rows",
         runs((0, 1024), (1, 1024), (2, 5)), 3),
        ("an empty row at a tile boundary", runs((0, 1024), (2, 100)), 4),
        ("a row over three tiles", runs((0, 10), (1, 3000), (2, 7)), 3),
        ("a tile of -1 pad only", runs((-1, 2048), (0, 5), (1, 3)), 2),
        ("the padded last row of the main-path bucket",
         runs(*[(r, CRITEO_NNZ) for r in range(CRITEO_BATCH - 1)],
              (CRITEO_BATCH - 1, SEG_BUCKET - (CRITEO_BATCH - 1)
               * CRITEO_NNZ)), CRITEO_BATCH),
        ("a single ragged tile", runs((0, 300), (1, 200)), 3),
    ]


def seg_sum_constants() -> dict:
    """The ``constexpr int`` constants of csrc/coo_segment_sum.cu
    (kThreads, kPerThread, kColChunk, ...), read from the source."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "dmlc_tpu_torch", "ops", "csrc", "coo_segment_sum.cu")
    with open(src) as f:
        return {m.group(1): int(m.group(2)) for m in re.finditer(
            r"constexpr int (k\w+) = (\d+);", f.read())}


def seg_sum_schedule(contrib, row_ids, num_rows: int):
    """``coo_segment_sum`` summed on the CPU in the order of the CUDA
    kernel (csrc/coo_segment_sum.cu; its note describes the schedule):
    returns (y, writes), ``writes[r]`` the times row r was written.

    ``contrib`` is an f32 CPU tensor [E] or [E, C], ``row_ids`` int32
    numpy ids that never decrease. Per tile: each thread's run pieces in
    entry order, the warp's Kogge-Stone segmented scan, complete runs
    written, warp pieces added in warp order, the rows with no entries
    zeroed; then each run over tiles summed from its tile pieces in tile
    order, column pass by column pass as the kernel takes them. Every f32
    add is the kernel's, so on the card the kernel gives these bits."""
    k = seg_sum_constants()
    threads, per, chunk = k["kThreads"], k["kPerThread"], k["kColChunk"]
    tile_n, wn = threads * per, 32 * per
    warps = threads // 32
    vals = contrib.reshape(contrib.shape[0], -1 if contrib.numel() else
                           (1 if contrib.dim() == 1 else contrib.shape[1]))
    entries, cols = vals.shape
    ids_all = np.asarray(row_ids, dtype=np.int64)
    tiles = max(1, -(-entries // tile_n))
    out = torch.full((num_rows, cols), float("nan"))
    writes = np.zeros(num_rows, dtype=np.int64)
    edges = torch.full((tiles, 2, cols), float("nan"))
    chains = {}  # start tile -> the tiles that arrived, and the row

    def inr(r):
        return 0 <= r < num_rows

    def write(r, value):
        out[r] = value
        writes[r] += 1

    lane = np.arange(threads) % 32
    warp = np.arange(threads) // 32
    for b in range(tiles):
        base = b * tile_n
        real = min(tile_n, max(entries - base, 0))
        ids = np.full(tile_n, 2**31 - 1, dtype=np.int64)
        ids[:real] = ids_all[base:base + real]
        v = torch.zeros(tile_n, cols)
        v[:real] = vals[base:base + real]
        prev = ids_all[base - 1] if b > 0 else ids[0] ^ 1
        nxt = ids_all[base + tile_n] if base + tile_n < entries \
            else ids[-1] ^ 1
        ext = np.concatenate([[prev], ids, [nxt]])  # ext[i + 1] = ids[i]
        # the rows with no entries
        for e in range(real):
            nx = ids_all[base + e + 1] if base + e + 1 < entries else num_rows
            lo, hi = max(ids[e] + 1, 0), min(nx, num_rows)
            if lo < hi:
                out[lo:hi] = 0.0
                writes[lo:hi] += 1
        if b == 0:
            hi = min(max(ids[0], 0), num_rows) if entries else num_rows
            out[:hi] = 0.0
            writes[:hi] += 1
        idt = ids.reshape(threads, per)
        prev_id = ext[per * np.arange(threads)]
        next_id = ext[per * np.arange(threads) + per + 1]
        tile_open_s = b > 0 and prev == ids[0]
        tile_open_e = base + tile_n < entries and nxt == ids[-1]
        warp_open_s = [tile_open_s] + [ids[w * wn - 1] == ids[w * wn]
                                       for w in range(1, warps)]
        warp_open_e = [ids[(w + 1) * wn - 1] == ids[(w + 1) * wn]
                       for w in range(warps - 1)] + [tile_open_e]
        link = warp_open_e[:-1]
        single = [ids[w * wn] == ids[(w + 1) * wn - 1] for w in range(warps)]
        head = (lane == 0) | (idt[:, -1] != prev_id)
        add = []
        for s in range(5):
            d = 1 << s
            add.append(torch.tensor((lane >= d) & ~head)[:, None])
            head = np.where(lane >= d, head | np.roll(head, d), head)
        cont = torch.tensor((lane[:, None] > 0) & (idt == prev_id[:, None]))
        same = torch.tensor(idt[:, 1:] == idt[:, :-1])
        # the thread's entries j that end a run or the warp
        nexts = np.concatenate([idt[:, 1:], next_id[:, None]], axis=1)
        ends = np.argwhere((idt != nexts) | ((lane[:, None] == 31)
                                             & (np.arange(per) == per - 1)))
        for c0 in range(0, cols, chunk):
            vt = v[:, c0:c0 + chunk].reshape(threads, per, -1)
            loc = [vt[:, 0]]
            for j in range(1, per):
                loc.append(torch.where(same[:, j - 1, None],
                                       loc[-1] + vt[:, j], vt[:, j]))
            s = loc[-1]
            for m in range(5):
                s = torch.where(add[m], torch.roll(s, 1 << m, 0) + s, s)
            carry = torch.roll(s, 1, 0)
            value = torch.where(cont[..., None], carry[:, None]
                                + torch.stack(loc, 1), torch.stack(loc, 1))
            piece = torch.full((warps, 2, value.shape[2]), float("nan"))
            for t, j in ends:
                r, w = idt[t, j], warp[t]
                if not inr(r):
                    continue
                os_ = r == ids[w * wn] and warp_open_s[w]
                oe = lane[t] == 31 and j == per - 1 and warp_open_e[w]
                val = value[t, j]
                if not os_ and not oe:
                    out[r, c0:c0 + chunk] = val
                    writes[r] += c0 == 0
                elif (os_ and w > 0) or (oe and w < warps - 1):
                    if os_:
                        piece[w, 0] = val
                    if oe:
                        piece[w, 1] = val
                else:
                    edges[b, 0 if os_ else 1, c0:c0 + chunk] = val
            for a in range(warps - 1):
                r = ids[(a + 1) * wn - 1]
                if not link[a] or (a > 0 and link[a - 1] and single[a]) \
                        or not inr(r):
                    continue
                acc, w = piece[a, 1], a + 1
                while True:
                    acc = acc + piece[w, 0]
                    if w < warps - 1 and link[w] and single[w]:
                        w += 1
                    else:
                        break
                os_ = a == 0 and single[0] and tile_open_s
                oe = w == warps - 1 and single[w] and tile_open_e
                if not os_ and not oe:
                    out[r, c0:c0 + chunk] = acc
                    writes[r] += c0 == 0
                if os_:
                    edges[b, 0, c0:c0 + chunk] = acc
                if oe:
                    edges[b, 1, c0:c0 + chunk] = acc
        first, last = ids[0], ids[tile_n - 1]
        through = tile_open_s and tile_open_e and first == last
        if tile_open_s and inr(first):
            a = b - 1
            while a >= 1 and ids_all[a * tile_n - 1] == first:
                a -= 1
            chains.setdefault(a, ([], first))[0].append(b)
        if tile_open_e and not through and inr(last):
            chains.setdefault(b, ([], last))[0].append(b)
    for a, (arrived, r) in chains.items():
        require(sorted(arrived) == list(range(a, max(arrived) + 1))
                and len(arrived) >= 2,
                "seg_sum_schedule: chain %d arrivals %s", a, arrived)
        acc = edges[a, 1]
        for k in range(a + 1, max(arrived) + 1):
            acc = acc + edges[k, 0]
        write(r, acc)
    shape = (num_rows,) + tuple(contrib.shape[1:])
    return out.reshape(shape), writes


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


def hold_seg_schedule(kernels, name, contrib, row_ids, num_rows):
    """coo_segment_sum on the card against ``seg_sum_schedule`` (its
    order, on the CPU) on the same float inputs: the same bits. Returns
    the kernel's result."""
    got = kernels.coo_segment_sum(contrib, row_ids, num_rows)
    want, writes = seg_sum_schedule(contrib.cpu(), row_ids.cpu().numpy(),
                                    num_rows)
    require(bool((writes == 1).all()), "seg_sum_schedule %s: rows written "
            "other than once", name)
    require(torch.equal(got.cpu(), want), "coo_segment_sum %s [%s]: the "
            "kernel's bits differ from its schedule's (max abs diff %g)",
            name, list(contrib.shape), float((got.cpu() - want).abs().max()))
    return got


def cell_feature_ids(seed: int) -> np.ndarray:
    """[CELL_ROWS x 39] int32 feature ids of one step of the criteo-fm cell,
    row by row as a batch holds them: field j's value of rank r (0 the
    commonest) drawn with chance ~1 / (r + 1), r = floor((c + 1)^u) - 1
    for u uniform, and hashed into a range of ids of its own; the ranges,
    each as large as its field up to one cap, fill [1, CELL_FEATURES). The
    commonest id, of the 3-valued field, holds ~1.28 % of the entries (8,192
    of 638,976), as in the cell; the benchmark's generator also folds rare
    values into one token a field, which this leaves out."""
    c = np.asarray(CELL_FIELD_VALUES, np.int64)
    lo, hi = 1, int(c.max())
    while lo < hi:  # the largest cap at which the ranges fit
        cap = (lo + hi + 1) // 2
        if np.minimum(c, cap).sum() <= CELL_FEATURES - 1:
            lo = cap
        else:
            hi = cap - 1
    sizes = np.minimum(c, lo)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    u = np.random.RandomState(seed).rand(CELL_ROWS, len(c))
    rank = np.minimum(np.floor(np.exp(u * np.log1p(c))).astype(np.int64) - 1,
                      c - 1)
    return (1 + starts + rank % sizes).astype(np.int32).ravel()


def feature_sum_cases():
    """(name, ids, num_features) where a sorted, entry-balanced feature sum
    can go wrong: no entries, one id holding every entry, a run over more
    than 32 tiles of 1024 entries (the chain's start found 32 tiles at a
    time), and ids in no order at all with untouched features between and
    after them."""
    rng = np.random.RandomState(26)
    long_run = np.concatenate([rng.randint(0, 5000, 20_000),
                               np.full(40_000, 777), rng.randint(0, 5000,
                                                                 9_000)])
    return [
        ("no entries", np.zeros(0, dtype=np.int32), 9),
        ("one id holds every entry", np.full(50_000, 3, dtype=np.int32), 7),
        ("a run over more than 32 tiles",
         rng.permutation(long_run).astype(np.int32), 5001),
        ("ids in no order, gaps between and after",
         (rng.randint(0, 3000, 70_000) * 3).astype(np.int32), 12_000),
    ]


def hold_feature_sum(kernels, dev, name, ids, num_features, cols):
    """``sorted_segment_sum`` on ``ids`` with seeded integer contributions
    ([E] at ``cols`` 0, else [E, cols]; FM's packed call, gw apart, at
    ``FM_PACKED_COLS``): bit-equal to its plain version (the CPU route),
    the same bits twice and on a second stream, one launch a call, every
    row written. Returns the result."""
    rng = np.random.RandomState(len(ids) + num_features + cols)
    shape = (len(ids),) + ((cols,) if cols else ())
    contrib = torch.tensor(rng.randint(-5, 6, shape).astype(np.float32),
                           device=dev)
    ids_t = torch.tensor(ids, device=dev)
    # NaN in the memory the output will likely take (the caching
    # allocator hands it out again): a row left unwritten would read NaN
    torch.full((num_features,) + shape[1:], float("nan"), device=dev)
    apart = cols == FM_PACKED_COLS
    before = kernels.sorted_segment_sum.launches
    got = kernels.sorted_segment_sum(contrib, ids_t, num_features, apart)
    again = kernels.sorted_segment_sum(contrib, ids_t, num_features, apart)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        other = kernels.sorted_segment_sum(contrib, ids_t, num_features,
                                           apart)
    torch.cuda.synchronize()
    want = kernels.sorted_segment_sum_plain(contrib.cpu(), ids_t.cpu(),
                                            num_features)
    require(kernels.sorted_segment_sum.launches == before + 3,
            "sorted_segment_sum %s: %d launches for 3 calls", name,
            kernels.sorted_segment_sum.launches - before)
    require(torch.equal(got.cpu(), want), "sorted_segment_sum %s [%s]: "
            "card and CPU routes differ on integer data", name, shape)
    require(torch.equal(got, again) and torch.equal(got, other),
            "sorted_segment_sum %s: runs differ in bits", name)
    return got


def sorted_sum_order(contrib, ids, num_rows: int,
                     vector_cols=None) -> np.ndarray:
    """``sorted_segment_sum`` on the CPU in the order of its CUDA kernel
    (csrc/sorted_segment_sum.cu: ``index_put_``'s), over each feature's
    run of n stably sorted entries. The first ``vector_cols`` columns (all
    by default) as vectors: 32 lane sums of the first 32·floor(n/32)
    entries (lane l takes l, l + 32, ... from 0), a shuffle-down tree into
    lane 0 (offsets 16, 8, 4, 2, 1), the last n mod 32 added in order; the
    other columns in entry order from 0; and 0.0 plus each sum.
    ``contrib`` is float32 numpy [E] or [E, C], ``ids`` int numpy [E];
    every add is an f32 add of the kernel's, so on the card the kernel
    gives these bits. Ids outside [0, num_rows) contribute nothing."""
    contrib = np.asarray(contrib, np.float32)
    ids = np.asarray(ids)
    x = contrib.reshape(len(ids), contrib.shape[1] if contrib.ndim > 1
                        else 1)
    vc = x.shape[1] if vector_cols is None else vector_cols
    order = np.argsort(ids, kind="stable")
    sid, xs = ids[order], x[order]
    out = np.zeros((num_rows, x.shape[1]), np.float32)
    cuts = np.concatenate([[0], np.flatnonzero(np.diff(sid)) + 1,
                           [len(sid)]]) if len(sid) else [0]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        r = int(sid[lo])
        if not 0 <= r < num_rows:
            continue
        run = xs[lo:hi]
        whole = (hi - lo) // 32 * 32
        g = np.zeros((32, vc), np.float32)
        for i in range(0, whole, 32):
            g = g + run[i:i + 32, :vc]
        for d in (16, 8, 4, 2, 1):
            g[:d] = g[:d] + g[d:2 * d]
        acc = g[0]
        for e in range(whole, hi - lo):
            acc = acc + run[e, :vc]
        out[r, :vc] = np.float32(0.0) + acc
        # the rows' columns: one add at a time (cumsum is serial)
        out[r, vc:] = np.float32(0.0) + np.cumsum(run[:, vc:], axis=0,
                                                  dtype=np.float32)[-1]
    return out.reshape((num_rows,) + contrib.shape[1:])


def index_put_route(contrib, ids, num_features, first_apart=False):
    """The feature sums as the route before ``sorted_segment_sum`` took
    them: ``index_put_`` with ``accumulate=True``, FM's packed [E, 1 + K]
    as an [E] and an [E, K] call (``first_apart``)."""
    def put(c):
        return c.new_zeros((num_features,) + tuple(c.shape[1:])).index_put_(
            (ids.long(),), c, accumulate=True)
    if not first_apart:
        return put(contrib)
    return torch.cat([put(contrib[:, 0].contiguous())[:, None],
                      put(contrib[:, 1:].contiguous())], dim=1)


def feature_sum_row(kernels, dev, flush, cols, seed=3) -> dict:
    """CUDA-event times (cold L2) of the feature-direction sum at one step
    of the criteo-fm cell (``cell_feature_ids``): the csr fit's [E] at
    ``cols`` 0, dv's [E, 8], FM's packed [E, 9] (gw apart); the route,
    ``sorted_segment_sum`` (a sort, then the kernel reading the rows
    through the permutation); the sort alone; and the ``index_put_`` route
    before it; beside the byte bound (E·C·4 + E·4 + F·C·4). On float data
    the kernel's bits must be ``sorted_sum_order``'s;
    ``index_put_bits_equal`` says whether they are the route's before."""
    ids = torch.tensor(cell_feature_ids(seed), device=dev)
    entries = ids.shape[0]
    shape = (entries,) + ((cols,) if cols else ())
    apart = cols == FM_PACKED_COLS
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    contrib = torch.randn(shape, generator=gen, device=dev)

    def route():
        return kernels.sorted_segment_sum(contrib, ids, CELL_FEATURES, apart)

    got = route()
    require(got.cpu().numpy().tobytes() == sorted_sum_order(
        contrib.cpu().numpy(), ids.cpu().numpy(), CELL_FEATURES,
        kernels.vector_columns(contrib, apart)).tobytes(),
            "sorted_segment_sum [%s]: the kernel's bits differ from its "
            "order's (sorted_sum_order)", shape)
    width = max(cols, 1)
    row = {
        "shape": [entries, width, CELL_FEATURES], "first_apart": apart,
        "ms": time_ms(route, flush),
        "sort_ms": time_ms(lambda: torch.sort(ids, stable=True), flush),
        "index_put_ms": time_ms(lambda: index_put_route(
            contrib, ids, CELL_FEATURES, apart), flush),
        "index_put_bits_equal": bool(torch.equal(got, index_put_route(
            contrib, ids, CELL_FEATURES, apart))),
        "longest_run": int(torch.unique(ids, return_counts=True)[1].max()),
    }
    row["bound_ms"], row["bound_by"] = bound(
        4 * (entries * width + entries + CELL_FEATURES * width),
        entries * width)
    return row


def seg_sum_row(kernels, dev, flush, name, contrib, row_ids, launches,
                err) -> dict:
    """The ``kernels`` line's row of ``coo_segment_sum`` at ``contrib``
    [E] or [E, C]: times of the kernel, its plain version and
    ``index_add_``, beside its byte bound (E·C·4 + E·4 + rows·C·4)."""
    entries = contrib.shape[0]
    cols = 1 if contrib.dim() == 1 else contrib.shape[1]
    ids64 = row_ids.long()
    row = {
        "name": name, "route": "cuda",
        "source": "dmlc_tpu_torch/ops/csrc/coo_segment_sum.cu",
        "replaces": "dmlc_tpu/ops/pallas_kernels.py:221",
        "launches": launches, "max_abs_err": err,
        "shape": [entries, cols, CRITEO_BATCH],
        "ms": time_ms(lambda: kernels.coo_segment_sum(
            contrib, row_ids, CRITEO_BATCH), flush),
        "plain_ms": time_ms(lambda: kernels.coo_segment_sum_plain(
            contrib, row_ids, CRITEO_BATCH), flush),
        "library_ms": time_ms(lambda: torch.zeros(
            (CRITEO_BATCH,) + tuple(contrib.shape[1:]), device=dev
        ).index_add_(0, ids64, contrib), flush),
    }
    row["bound_ms"], row["bound_by"] = bound(
        4 * (entries * cols + entries + CRITEO_BATCH * cols),
        entries * cols)
    return row


def run_fit(path, layout, batch_size, num_features, device,
            learning_rate=0.1, group=None, epochs=EPOCHS, **fit):
    """The linear fit of phases 5-6 (``fit``: more ``fit_uri`` arguments,
    such as a snapshot uri): (history, params as numpy, seconds)."""
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    learner = LinearLearner(device=device, group=group, objective="logistic",
                            learning_rate=learning_rate)
    t0 = time.perf_counter()
    history = learner.fit_uri(path, batch_size=batch_size, epochs=epochs,
                              layout=layout, num_features=num_features,
                              **fit)
    if str(device) != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return history, params_to_numpy(learner.params), seconds


def feed_seconds(path, layout, batch_size, num_features,
                 python_stack=False):
    """Seconds to read, parse, pad and copy to the card the batches of
    EPOCHS epochs with no step: the host's share of the fit, on
    ``create_parser``'s route or the Python stack."""
    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.utils.device import resolve_device

    parser = (python_stack_parser(path, resolve_device(None)) if python_stack
              else create_parser(path))
    feed = DeviceFeed(parser, BatchSpec(
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
    with count_parts() as parts, native_feeds() as feeds:
        history, params, seconds = run_fit(path, layout, batch_size,
                                           num_features, None)
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    feed_only = feed_seconds(path, layout, batch_size, num_features)
    # the csr step's gradient is one sorted_segment_sum launch too
    for kernel in (kernel_name,) + (("sorted_segment_sum",)
                                    if layout == "csr" else ()):
        require(launches[kernel] == steps,
                "%s path: %s launched %d times for %d steps", name, kernel,
                launches[kernel], steps)
    require(feeds == ["NativePipelineParser"] * EPOCHS,
            "%s path: the feed staged natively over %s", name, feeds)
    hold_tokens("%s path" % name, launches["tokenize_boundaries"],
                len(parts))
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
    """(out, lse, dq, dk, dv) from the two flash kernels."""
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
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
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
    """Phase 10: the two flash kernels at the path's shape, held against
    the plain version on the same inputs and timed beside it,
    scaled_dot_product_attention and their bound; the one-TF32-pass fault
    read there; one backward call's device operations (one kernel, no
    memset); the port's whole backward (delta and the kernel) beside
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
        "flash_attention_bwd": time_ms(
            lambda: kernels.flash_attention_bwd(
                q, k, v, dout, lse, delta, True), flush, 10),
    }
    fwd_ops = one_call_ops(lambda: kernels.flash_attention_fwd(
        q, k, v, True))
    require_one_kernel(fwd_ops, "flash_attention_fwd", "flash_fwd_kernel")
    print(json.dumps({"flash_fwd_device_ops": fwd_ops}), flush=True)
    bwd_ops = one_call_ops(lambda: kernels.flash_attention_bwd(
        q, k, v, dout, lse, delta, True))
    require_one_kernel(bwd_ops, "flash_attention_bwd", "flash_bwd_kernel")
    print(json.dumps({"flash_bwd_device_ops": bwd_ops}), flush=True)
    # the backward as the autograd Function runs it: delta, the kernel
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
        "flash_attention_bwd": max(report["dq_max_abs_err"],
                                   report["dk_max_abs_err"],
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
             "kernels_bwd_ms": ms["flash_attention_bwd"],
             "flash_fwd_device_ops": fwd_ops,
             "flash_bwd_device_ops": bwd_ops,
             "sdpa_backend": backend["backend"]}
    del flush, leaves, o
    torch.cuda.empty_cache()

    pairs = b * h * t * (t + 1) / 2  # causal (query, key) pairs
    qkv = 4 * b * t * h * d  # bytes of one [B, T, H, D] f32 tensor
    rows_lse = 4 * b * h * t
    work = {  # (bytes moved once, f32 flops): 2 flops a pair a product
        # forward: S, P V; q, k, v read, out written, lse written
        "flash_attention_fwd": (4 * qkv + rows_lse, 2 * 2 * d * pairs),
        # backward: S, dP, dV, dK, dQ; q, k, v, dout read, dq, dk, dv
        # written, lse and delta read
        "flash_attention_bwd": (7 * qkv + 2 * rows_lse, 5 * 2 * d * pairs),
    }
    sources = {
        "flash_attention_fwd": (
            "dmlc_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            "dmlc_tpu/ops/sequence_parallel.py:423"),
        "flash_attention_bwd": (
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


def block_digest(block) -> str:
    """sha256 over a block's arrays (dtype, shape and bytes, in a fixed
    order): equal digests are equal blocks, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for name in ("offset", "label", "index", "value", "weight", "qid",
                 "field"):
        a = getattr(block, name)
        h.update(name.encode())
        if a is not None:
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


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
    """Phase 12, the Python stack's ingest: row-block iterators over
    :func:`python_stack_parser` (the route ``create_row_block_iter`` took
    before the native route) on the Criteo-shaped file, on the card and on
    the CPU, bit for bit, with one tokenizer launch a chunk part; then
    through a #cachefile (``DiskRowIter``), cold and warm. Returns the
    report and the CPU route's RowBlock (phase 26 holds the native route
    against it)."""
    from dmlc_tpu_torch.data.row_iter import BasicRowIter, DiskRowIter

    nbytes = os.path.getsize(path)
    result = {"file_bytes": nbytes}

    def timed(uri, device):
        kernels.reset_launch_counts()
        with count_parts() as parts:
            t0 = time.perf_counter()
            src, _, cache = uri.partition("#")
            it = (DiskRowIter(lambda: python_stack_parser(src, device),
                              cache) if cache
                  else BasicRowIter(python_stack_parser(src, device)))
            block, ncol = read_all(it)
            seconds = time.perf_counter() - t0
        return block, ncol, seconds, len(parts), \
            kernels.tokenize_boundaries.launches

    card, ncol, sec, parts, launches = timed(path, dev)
    hold_tokens("ingest", launches, parts, native=False)
    cpu, cpu_ncol, cpu_sec, _, cpu_launches = timed(path, "cpu")
    require(cpu_launches == 0, "ingest: the CPU route launched a kernel")
    same_blocks("ingest on the card", card, cpu)
    result["card_digest"] = block_digest(card)
    result["card_rows_digest"] = rows_digest([row_fingerprints(card)])
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
    # the Python stack's PipelinedParser (chunks parsed whole on its worker
    # threads) beside a ThreadedParser built directly over the same
    # LibSVMParser (each chunk split over its pool): the same rows, and one
    # tokenizer launch a non-empty chunk part either way
    from dmlc_tpu_torch.data import (LibSVMParser, PipelinedParser,
                                     RowBlockContainer, ThreadedParser)
    from dmlc_tpu_torch.data.parsers import DEFAULT_NTHREAD
    from dmlc_tpu_torch.io import create_input_split

    makers = {
        "pipelined": lambda: python_stack_parser(path, dev),
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
                "the %s maker built %s", name, type(parser).__name__)
        same_blocks("ingest through the %s parser" % name, whole, cpu)
        launches = kernels.tokenize_boundaries.launches
        hold_tokens("%s parser" % name, launches, len(parts), native=False)
        result["parsers"][name] = {
            "seconds": seconds, "mb_per_s": nbytes / 1e6 / seconds,
            "launches": launches, "nthread": DEFAULT_NTHREAD}
        del whole, cont
    del card, block
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
    return result, cpu


def read_native(path, device):
    """(block, seconds, the pipeline's stats, tokenizer launches, chunk
    parts) of one read through ``create_parser``, which must take the
    native route."""
    from dmlc_tpu_torch.data import RowBlockContainer, create_parser
    from dmlc_tpu_torch.data.parsers import NativePipelineParser
    from dmlc_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    with count_parts() as parts:
        t0 = time.perf_counter()
        parser = create_parser(path, device=device)
        cont = RowBlockContainer()
        try:
            for block in parser:
                cont.push_block(block)
            stats = parser.stats()
        finally:
            parser.close()
        whole = cont.to_block()
        seconds = time.perf_counter() - t0
    require(isinstance(parser, NativePipelineParser), "%s: create_parser "
            "gave %s, not the native route", path, type(parser).__name__)
    return whole, seconds, stats, kernels.tokenize_boundaries.launches, \
        len(parts)


def hold_routes(what, native, python) -> dict:
    """The native route's rows against the Python stack's within the JAX
    package's limits for the two engines (tests/test_native.py): offsets,
    indices and qids equal, labels within rtol 1e-6, values and weights
    within rtol 1e-5 / atol 1e-7 — the native number scan is not correctly
    rounded for every string (cpp/parse_common.h), numpy's is. Returns the
    share of values equal bit for bit."""
    for name in ("offset", "index", "qid"):
        g, w = getattr(native, name), getattr(python, name)
        require((g is None) == (w is None)
                and (g is None or np.array_equal(g, w)),
                "%s: %s differs between the routes", what, name)
    require(np.allclose(native.label, python.label, rtol=1e-6, atol=0),
            "%s: labels differ past rtol 1e-6", what)
    for name in ("value", "weight"):
        g, w = getattr(native, name), getattr(python, name)
        require((g is None) == (w is None) and (g is None or np.allclose(
            g, w, rtol=1e-5, atol=1e-7)), "%s: %s differs between the "
            "routes past rtol 1e-5 / atol 1e-7", what, name)
    return {"values_bit_equal_share": float(np.mean(
        native.value.view(np.int32) == python.value.view(np.int32)))}


def drive_native(kernels, dev, ingest_file, python_block, ingest, fit_files,
                 paths, fit_params, fm_file, fm_out, fm_start, tmp) -> dict:
    """Phase 26 (the module docstring): the native route on the card, at
    the fits' full widths, beside the Python stack. Returns the report and
    the Python stack's fits, {layout: (history, params)}."""
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.data import convert_to_recordio
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    nbytes = os.path.getsize(ingest_file)
    mb = nbytes / 1e6
    report = {"file_bytes": nbytes}

    # (a) ingest of phase 12's file on the native route, card and CPU
    card, sec, stats, launches, parts = read_native(ingest_file, dev)
    hold_tokens("native ingest", launches, parts)
    require(sorted(stats) == sorted(native.STATS_KEYS) and stats["bytes_read"]
            == nbytes and stats["chunks"] > 0, "native ingest: stats %s",
            stats)
    cpu, cpu_sec, _, cpu_launches, _ = read_native(ingest_file, "cpu")
    require(cpu_launches == 0, "native ingest on the CPU launched a kernel")
    same_blocks("native ingest on the card", card, cpu)
    require(len(card) == INGEST_ROWS, "native ingest: %d rows", len(card))
    agree = hold_routes("native ingest against phase 12's Python stack",
                        card, python_block)
    ingest["native"] = {
        "digest": block_digest(card),
        "rows_digest": rows_digest([row_fingerprints(card)]),
        "card_mb_per_s": mb / sec}
    report["ingest"] = dict(
        agree, card_seconds=sec, card_mb_per_s=mb / sec,
        cpu_seconds=cpu_sec, cpu_mb_per_s=mb / cpu_sec, stats=stats,
        tokenize_launches=launches,
        python_stack_card_mb_per_s=ingest["card_mb_per_s"],
        python_stack_pipelined_mb_per_s=(
            ingest["parsers"]["pipelined"]["mb_per_s"]),
        python_stack_tokenize_launches=ingest["launches"])
    del cpu, python_block

    # (b) the dense and csr fits on the Python stack, beside phases 5-6's
    # native fits: the same kernels once a step, the tokenizer once a
    # chunk part, the loss histories within rtol 1e-5 of the native ones
    # (the inputs agree within the limits of hold_routes)
    fits, python_fits = {}, {}
    for layout, batch, nf, rows, kernel in (
            ("dense", HIGGS_BATCH, HIGGS_FEATURES + 1, HIGGS_ROWS,
             "fused_linear_grads"),
            ("csr", CRITEO_BATCH, CRITEO_DIM + 1, CRITEO_ROWS,
             "coo_segment_sum")):
        steps = EPOCHS * (-(-rows // batch))
        learner = LinearLearner(device=dev, objective="logistic",
                                learning_rate=0.1)
        kernels.reset_launch_counts()
        with count_parts() as fit_parts:
            feed = DeviceFeed(python_stack_parser(fit_files[layout], dev),
                              BatchSpec(batch_size=batch, layout=layout,
                                        num_features=nf), device=dev)
            t0 = time.perf_counter()
            try:
                history = learner.fit_feed(feed, epochs=EPOCHS)
                torch.cuda.synchronize()
            finally:
                feed.close()
            seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
        require(launches[kernel] == steps, "%s on the Python stack: %s "
                "launched %d times for %d steps", layout, kernel,
                launches[kernel], steps)
        hold_tokens("%s fit on the Python stack" % layout,
                    launches["tokenize_boundaries"], len(fit_parts),
                    native=False)
        native_fit = paths[layout]
        np.testing.assert_allclose(history, native_fit["loss_history"],
                                   rtol=FIT_LOSS_RTOL)
        params = params_to_numpy(learner.params)
        python_fits[layout] = (history, params)
        fits[layout] = {
            "steps": steps, kernel + "_launches": launches[kernel],
            "native_rows_per_s": native_fit["rows_per_s"],
            "native_feed_only_seconds": native_fit["feed_only_seconds"],
            "native_seconds": native_fit["seconds"],
            "native_tokenize_launches": native_fit["tokenize_launches"],
            "python_rows_per_s": EPOCHS * rows / seconds,
            "python_seconds": seconds,
            "python_feed_only_seconds": feed_seconds(
                fit_files[layout], layout, batch, nf, python_stack=True),
            "python_tokenize_launches": launches["tokenize_boundaries"],
            "python_chunk_parts": len(fit_parts),
            "loss_history_native": native_fit["loss_history"],
            "loss_history_python": history,
            "param_rel_err_python_vs_native": param_rel_err(
                params, fit_params[layout])}
    report["fits"] = fits
    print(json.dumps({"native_fits": fits}), flush=True)

    # (c) FM over libfm: phase 16's fits took the native route; the same
    # fit on the Python stack (LibFMParser) beside it
    kernels.reset_launch_counts()
    history, _, seconds = run_fm_fit(fm_file, None, fm_start,
                                     python_stack=True)
    steps = EPOCHS * (-(-CRITEO_ROWS // CRITEO_BATCH))
    require(kernels.coo_segment_sum.launches == steps
            and kernels.tokenize_boundaries.launches == 0,
            "FM on the Python stack: coo_segment_sum %d for %d steps, "
            "tokenizer %d", kernels.coo_segment_sum.launches, steps,
            kernels.tokenize_boundaries.launches)
    native_fm = fm_out["fit"]
    np.testing.assert_allclose(history, native_fm["loss_history"],
                               rtol=FM_LOSS_RTOL)
    report["fm"] = {
        "native_rows_per_s": native_fm["rows_per_s"],
        "native_feed_only_seconds": native_fm["feed_only_seconds"],
        "native_feeds": fm_out["native_feeds"],
        "python_rows_per_s": EPOCHS * CRITEO_ROWS / seconds,
        "python_seconds": seconds,
        "loss_history_native": native_fm["loss_history"],
        "loss_history_python": history}

    # (d) a .rec read and a libsvm #cachefile, cold then warm, on the
    # native route: each the native text read's rows, bit for bit
    rec = os.path.join(tmp, "native_criteo.rec")
    t0 = time.perf_counter()
    convert_to_recordio(ingest_file, rec, rows_per_group=REC_ROWS,
                        device=dev)
    convert_s = time.perf_counter() - t0
    cache = os.path.join(tmp, "native_criteo.cache")
    binary = {"rec_convert_seconds": convert_s}
    for name, uri, size in (
            ("rec", rec + "?format=recordio", os.path.getsize(rec)),
            ("cachefile_cold", ingest_file + "#" + cache, nbytes),
            ("cachefile_warm", ingest_file + "#" + cache, None)):
        block, sec, _, launches, parts = read_native(uri, dev)
        hold_tokens("native %s read" % name, launches, parts)
        same_blocks("native %s read (against the native text read)" % name,
                    block, card)
        size = size or os.path.getsize(cache + ".rowrec")
        binary[name] = {"seconds": sec, "bytes": size,
                        "mb_per_s": size / 1e6 / sec,
                        "text_mb_per_s": mb / sec}
        del block
    report["binary"] = binary
    del card
    return report, python_fits


# ---------------------------------------------------------------------------
# phase 27: the process parse pool
# ---------------------------------------------------------------------------


def child_probe(t_submit: float) -> dict:
    """Run in a fresh ``spawn`` process: the seconds from the parent's
    submit to this call (the process's start and its imports, torch's
    among them: this module's own) and those its CUDA context takes to
    make (one element on the card), and what torch reserved there."""
    t_start = time.time()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    return {"start_s": t_start - t_submit,
            "cuda_init_s": time.time() - t_start,
            "reserved_bytes": torch.cuda.memory_reserved()}


def probe_child() -> dict:
    """One ``spawn`` process's cost: its start (the interpreter, torch's
    import), its CUDA context's making, and the card memory the context
    holds (``mem_get_info`` here before it starts and while it lives)."""
    import concurrent.futures
    import multiprocessing

    free_before = torch.cuda.mem_get_info()[0]
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        report = pool.submit(child_probe, time.time()).result()
        report["context_bytes"] = free_before - torch.cuda.mem_get_info()[0]
    return report


def pooled_read(kernels, dev, path, procs) -> tuple:
    """(the two epochs' block digests, report) of two epochs of ``path``
    on the card through one ``PipelinedParser`` with ``procs`` processes
    (0: its threads), the second after ``before_first`` (the same pool,
    started): each epoch's seconds and MB/s, the seconds to the first
    block (the pool's start), the non-empty chunks and the tokenizer's
    launches, and the card's free memory before the parser, after its
    first block and after its close."""
    import multiprocessing

    from dmlc_tpu_torch.data import RowBlockContainer

    kernels.reset_launch_counts()
    free = {"before": torch.cuda.mem_get_info()[0]}
    digests, seconds = [], []
    with count_chunks() as chunks, count_parts() as parts:
        t0 = time.perf_counter()
        parser = python_stack_parser(path, dev, procs=procs)
        try:
            for epoch in range(2):
                if epoch:
                    parser.before_first()
                    t0 = time.perf_counter()
                cont = RowBlockContainer()
                for block in parser:
                    if "first_block" not in free:
                        first = time.perf_counter() - t0
                        free["first_block"] = torch.cuda.mem_get_info()[0]
                    cont.push_block(block)
                seconds.append(time.perf_counter() - t0)
                digests.append(block_digest(cont.to_block()))
                del cont
            stats = parser.stats()
        finally:
            parser.close()
    free["closed"] = torch.cuda.mem_get_info()[0]
    require(multiprocessing.active_children() == [],
            "procs=%d: processes outlived close(): %s", procs,
            multiprocessing.active_children())
    require(stats["procs"] == procs, "procs=%d: stats %s", procs, stats)
    launches = kernels.tokenize_boundaries.launches
    if procs:
        # the pool parses every chunk whole in a process: none in this one
        require(launches == len(chunks) > 0 and not parts,
                "procs=%d: %d tokenizer launches for %d chunks (%d parts "
                "parsed here)", procs, launches, len(chunks), len(parts))
    else:
        hold_tokens("the threads' read", launches, len(parts), native=False)
    nbytes = os.path.getsize(path)
    return digests, {
        "procs": procs, "nthread": stats["nthread"],
        "first_block_seconds": first,
        "epoch1_seconds": seconds[0], "epoch2_seconds": seconds[1],
        "epoch1_mb_per_s": nbytes / 1e6 / seconds[0],
        "epoch2_mb_per_s": nbytes / 1e6 / seconds[1],
        "chunks": len(chunks), "tokenize_launches": launches,
        "children_context_bytes": free["before"] - free["first_block"],
        "held_after_close_bytes": free["before"] - free["closed"]}


def drive_pool(kernels, dev, ingest_file, ingest, fit_files, python_fits):
    """Phase 27 (the module docstring): the Python stack's process parse
    pool on the card."""
    from dmlc_tpu_torch.data import PipelinedParser, create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    report = {"child": probe_child()}
    print(json.dumps({"pool_child": report["child"]}), flush=True)
    # (a) phase 12's file: the threads, then the pool at 2 and 4 processes
    reads = {}
    for procs in (0, 2, 4):
        digests, reads[procs] = pooled_read(kernels, dev, ingest_file, procs)
        require(digests == [ingest["card_digest"]] * 2,
                "procs=%d: a block differs from phase 12's CPU route's",
                procs)
        print(json.dumps({"pool_read": reads[procs]}), flush=True)
    report["reads"] = {str(k): v for k, v in reads.items()}
    report["pool_launches"] = sum(reads[p]["tokenize_launches"]
                                  for p in (2, 4))

    # (b) the csr fit through create_parser(procs=2): phase 26's Python
    # stack fit, bit for bit
    steps = EPOCHS * (-(-CRITEO_ROWS // CRITEO_BATCH))
    learner = LinearLearner(device=dev, objective="logistic",
                            learning_rate=0.1)
    kernels.reset_launch_counts()
    with count_chunks() as chunks:
        parser = create_parser(fit_files["csr"], device=dev, procs=2)
        require(isinstance(parser, PipelinedParser)
                and parser.stats()["procs"] == 2,
                "create_parser(procs=2) gave %s", type(parser).__name__)
        feed = DeviceFeed(parser, BatchSpec(batch_size=CRITEO_BATCH,
                                            layout="csr",
                                            num_features=CRITEO_DIM + 1),
                          device=dev)
        t0 = time.perf_counter()
        try:
            history = learner.fit_feed(feed, epochs=EPOCHS)
            torch.cuda.synchronize()
        finally:
            feed.close()
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    require(launches["coo_segment_sum"] == steps, "pooled csr fit: "
            "coo_segment_sum launched %d times for %d steps",
            launches["coo_segment_sum"], steps)
    require(launches["tokenize_boundaries"] == len(chunks) > 0,
            "pooled csr fit: %d tokenizer launches for %d chunks",
            launches["tokenize_boundaries"], len(chunks))
    want_history, want = python_fits["csr"]
    got = params_to_numpy(learner.params)
    require(history == want_history and all(
        np.array_equal(got[k], want[k]) for k in want),
        "pooled csr fit: not phase 26's Python-stack fit, bit for bit")
    report["fit"] = {
        "steps": steps, "coo_segment_sum_launches": launches[
            "coo_segment_sum"],
        "tokenize_launches": launches["tokenize_boundaries"],
        "chunks": len(chunks), "seconds": seconds,
        "rows_per_s": EPOCHS * CRITEO_ROWS / seconds}
    print(json.dumps({"pool_fit": report["fit"]}), flush=True)
    return report


def timed_proc_parse(spec, chunk, pause: float = 0.0) -> tuple:
    """Run in a pool process: (pid, seconds) of one chunk's
    ``data.pipeline._proc_parse``, after ``pause`` seconds (so that the
    warm-up chunks of a pool land on separate processes)."""
    from dmlc_tpu_torch.data import pipeline

    time.sleep(pause)
    t0 = time.perf_counter()
    pipeline._proc_parse(spec, chunk)
    return os.getpid(), time.perf_counter() - t0


def pool_thread_times(dev) -> dict:
    """``--pool-threads``: phase 12's file (written here) in its 8 MiB
    chunks, parsed on the card by ``spawn`` pools of
    ``data.pipeline._proc_parse`` at 1, 2 and 4 processes, each started
    with the environment the port gives a pool process
    (``data.pipeline._PROC_ENV``: one torch and one BLAS thread) and with
    the libraries' defaults, in turns; each pool warmed by a chunk a
    process before its timed pass over every chunk: MB/s and the mean and
    largest seconds of one chunk's parse."""
    import concurrent.futures
    import multiprocessing

    from dmlc_tpu_torch.data import LibSVMParser, pipeline
    from dmlc_tpu_torch.io import create_input_split

    out = {"cores": len(os.sched_getaffinity(0))}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "criteo_ingest.svm")
        write_criteo(path, INGEST_ROWS, seed=13)
        split = create_input_split(path, 0, 1, "text", threaded=False)
        chunks = []
        while (chunk := split.next_chunk()) is not None:
            chunks.append(chunk)
        spec = pipeline._proc_spec(LibSVMParser(split, 1, dev))
        split.close()
    nbytes = sum(map(len, chunks))
    for env in ("port", "defaults", "defaults", "port"):
        for procs in (1, 2, 4):
            saved = {k: os.environ.pop(k, None) for k in pipeline._PROC_ENV}
            if env == "port":
                os.environ.update(pipeline._PROC_ENV)
            try:
                with concurrent.futures.ProcessPoolExecutor(
                        procs, mp_context=multiprocessing.get_context(
                            "spawn")) as pool:
                    warm = [pool.submit(timed_proc_parse, spec, chunks[i],
                                        2.0) for i in range(procs)]
                    pids = {f.result()[0] for f in warm}
                    t0 = time.perf_counter()
                    timed = [f.result() for f in [
                        pool.submit(timed_proc_parse, spec, c)
                        for c in chunks]]
                    wall = time.perf_counter() - t0
            finally:
                for k, v in saved.items():
                    os.environ.pop(k, None)
                    if v is not None:
                        os.environ[k] = v
            require(len(pids) == procs, "%d of %d processes warmed",
                    len(pids), procs)
            parse = [t for _, t in timed]
            out.setdefault(env + "_" + str(procs), []).append({
                "mb_per_s": nbytes / 1e6 / wall,
                "chunk_parse_s_mean": sum(parse) / len(parse),
                "chunk_parse_s_max": max(parse)})
    return out


def pool_summary(card, report) -> dict:
    """The ``pool`` line: phase 27's MB/s at 0 (threads), 2 and 4
    processes (the first epoch, with the pool's start, and the second),
    the seconds to the first block, the card memory the
    children's contexts hold, a child's start, and the pooled fit's
    rows/s."""
    reads = report["reads"]
    return {
        "card": card,
        "epoch1_mb_per_s": {k: r["epoch1_mb_per_s"]
                            for k, r in reads.items()},
        "epoch2_mb_per_s": {k: r["epoch2_mb_per_s"]
                            for k, r in reads.items()},
        "first_block_seconds": {k: r["first_block_seconds"]
                                for k, r in reads.items()},
        "children_context_bytes": {k: r["children_context_bytes"]
                                   for k, r in reads.items()},
        "child": report["child"],
        "fit_rows_per_s": report["fit"]["rows_per_s"],
        "seconds": report["seconds"]}


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
                    hold_tokens("%s %s rank %d" % (name, key, r),
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
                hold_tokens("world 1 %s" % layout,
                            launches["tokenize_boundaries"], len(parts))
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

    # (b) fit_uri over phase 5's HIGGS file, on the native route
    kernels.reset_launch_counts()
    with count_parts() as parts:
        learner = gbdt.GBDTLearner(device=dev, **GBDT_HYPER)
        t0 = time.perf_counter()
        uri_hist = learner.fit_uri(higgs_file, HIGGS_FEATURES + 1)
        torch.cuda.synchronize()
        uri_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    hold_tokens("GBDT fit_uri", launches["tokenize_boundaries"],
                len(parts))
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


def fm_feed(path, device, python_stack=False):
    """The FM fit's csr feed over the libfm file: ``create_parser``'s
    native route, or the Python stack (``LibFMParser``)."""
    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed

    parser = (python_stack_parser(path, device, data_format="libfm")
              if python_stack else
              create_parser(path, data_format="libfm", device=device))
    return DeviceFeed(parser, BatchSpec(batch_size=CRITEO_BATCH,
                                        layout="csr",
                                        num_features=CRITEO_DIM + 1),
                      device=device)


def run_fm_fit(path, device, start, epochs=EPOCHS, learner=None,
               python_stack=False, **fit):
    """(history, params as numpy, seconds) of ``FMLearner.fit_feed`` over
    the libfm file ``path``; ``fit`` passes the snapshot arguments."""
    from dmlc_tpu_torch.models import fm_params_to_numpy

    learner = learner or fm_learner(device, start)
    feed = fm_feed(path, device, python_stack)
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
    # (b) the [E, K] and [E, 1 + K] feature sums repeat their bits, and
    # give the CPU route's on integer data, at phase 4's cases and at the
    # criteo-fm cell's step, beside index_put_'s time
    dv = packed[:, :FM_HYPER["num_factors"]].contiguous()
    g1 = feature_segment_sum(dv, batch["indices"], CRITEO_DIM + 1)
    g2 = feature_segment_sum(dv, batch["indices"], CRITEO_DIM + 1)
    torch.cuda.synchronize()
    require(torch.equal(g1, g2), "feature_segment_sum [E, K]: two runs "
            "differ in bits")
    cell_ids = cell_feature_ids(16)
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    feature_rows = {}
    for cols in FEATURE_SUM_COLS:
        for name, ids, num_features in feature_sum_cases():
            hold_feature_sum(kernels, dev, name, ids, num_features, cols)
        hold_feature_sum(kernels, dev, "criteo-fm step", cell_ids,
                         CELL_FEATURES, cols)
        feature_rows[cols] = feature_sum_row(kernels, dev, flush, cols)
    del flush
    report["kernel_checks"] = {"coo_segment_sum_cols_float_max_abs_err":
                               seg_err, "feature_sum_same_bits": True,
                               "feature_sum_integer_bits_equal_cpu": True,
                               "feature_sum_ms": feature_rows}
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
    for name in ("coo_segment_sum", "sorted_segment_sum"):
        require(launches[name] == steps,
                "fm path: %s launched %d times for %d steps", name,
                launches[name], steps)
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
    row = seg_sum_row(kernels, dev, flush, "coo_segment_sum_fm", packed,
                      row_ids, launches["coo_segment_sum"], seg_err)
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
    if spec.get("pause_epoch"):
        pause_feed_at(spec["pause_epoch"], spec["marker"])
    learner = snap_linear_fit(spec["file"], spec["epochs"],
                              snapshot_uri=spec["snap"],
                              resume=spec["resume"])[2]
    learner.save(spec["model"])
    return 0


def pause_feed_at(epoch: int, marker: str) -> None:
    """In a ``--snap-rank`` child: the feed, entering ``epoch``, writes
    ``marker`` and waits for ``marker + ".sent"`` (the parent's SIGTERM has
    been sent by then), so that the signal lands in that epoch while the
    fit still runs."""
    from dmlc_tpu_torch.device import DeviceFeed

    real, calls = DeviceFeed.before_first, [0]

    def before_first(self):
        real(self)
        calls[0] += 1
        if calls[0] == epoch:
            open(marker, "w").close()
            deadline = time.monotonic() + RANK_TIMEOUT_S
            while not os.path.exists(marker + ".sent"):
                require(time.monotonic() < deadline, "no signal in %d s",
                        RANK_TIMEOUT_S)
                time.sleep(0.01)

    DeviceFeed.before_first = before_first


def run_snap_child(spec: dict, tmp: str, signal_after_commit: bool):
    """Start a ``--snap-rank`` child; with ``signal_after_commit``, send it
    SIGTERM once its first manifest has committed, or, when the spec names
    a ``marker``, once the child has written it (it must still be running
    then). Returns (exit code, seconds, the log's tail)."""
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
            wait_for = spec.get("marker") or os.path.join(
                spec["snap"], "snap_v1.manifest")
            while not os.path.exists(wait_for):
                require(proc.poll() is None, "snapshot child exited with %s "
                        "before %s", proc.returncode, wait_for)
                require(time.monotonic() < deadline, "no %s in %d s",
                        wait_for, RANK_TIMEOUT_S)
                time.sleep(0.01)
            require(proc.poll() is None, "the snapshot child finished "
                    "before the signal: give it more epochs")
            proc.send_signal(signal.SIGTERM)
            if spec.get("marker"):
                open(spec["marker"] + ".sent", "w").close()
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
    """One rank of phases 18 and 25 (b), run as ``chip_smoke.py
    --recover-rank SPEC`` by the port's launcher: ``--cluster local``
    (the socket engine, ``sync="host"``) or ``--cluster gpu`` (the device
    engine over the launcher's DMLC_TPU_* env, ``sync="spmd"``; it ends
    with one rendezvous with the tracker, after ``spec["hold"]`` appears,
    so the launcher's job ends): fits ``spec["file"]`` one epoch a
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
    if device_engine and os.environ.get("DMLC_TRACKER_URI"):
        # launched by a tracker (``--cluster gpu``), which the device
        # engine never told anything: one rendezvous and shutdown a rank
        # end its job, once the smoke has read the live status plane
        if spec.get("hold"):
            wait_for(spec["hold"], "the smoke's release")
        collective.init("socket")
        collective.finalize()
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
        hold_tokens("%s rank %d" % (name, r),
                    rep["launches"]["tokenize_boundaries"],
                    rep["chunk_parts"])
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


def drive_recovery(csr_file, tmp, parts=("clean", "crash",
                                         "elastic")) -> dict:
    """Phase 18 (the module docstring): the jobs of ``parts``, in order;
    "crash" and "elastic" hold their digests against "clean"."""
    report = {}
    reports, _, clean_s, spec = run_launcher_job(
        tmp, "clean", csr_file, ["-n", "2"])
    clean = hold_recover_job("clean", reports, 2)
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
        require(spares[0]["launches"]["coo_segment_sum"] > 0,
                "elastic: the spare launched %s", spares[0]["launches"])
        hold_tokens("elastic: the spare",
                    spares[0]["launches"]["tokenize_boundaries"],
                    spares[0]["chunk_parts"])
        fault = fault_marker(spec, "killed.json")
        report["elastic"] = dict(
            held, seconds=secs, vs_clean=secs / clean_s,
            world_version=2, events=fields["events"],
            kill_to_replay_s=replay_seconds(fault, reports),
            kill_to_spare_ready_s=(spares[0]["times"]["engine_ready"]
                                   - fault["at"]))
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


# ---------------------------------------------------------------------------
# phase 20: the observability layer on the card
# ---------------------------------------------------------------------------

#: every observability setting off (the reference's names)
OBS_OFF = {"DMLC_TPU_METRICS": "0", "DMLC_TPU_DEVICE_TELEMETRY": "0",
           "DMLC_TPU_AUDIT": "off", "DMLC_TPU_STEP_SAMPLE_N": "0",
           "DMLC_TPU_TRACE": None, "DMLC_TPU_METRICS_EXPORT": None,
           "DMLC_TPU_FLIGHTREC": None}
#: the defaults: metrics and device telemetry on, trace, export, flight
#: recorder and audit off
OBS_DEFAULT = {k: None for k in OBS_OFF}
#: a step sampled every 8th step: phase 5's 32 dense steps sample 4 times,
#: phase 6's 16 csr and phase 16's 16 FM steps twice
OBS_SAMPLE_N = 8
OBS_RUNS = 3  # (d): the median of 3 runs a setting
#: the GBDT fit of (a) and (d): phase 14's rows and depth, fewer trees
OBS_GBDT_TREES = 5
OBS_PROFILE_STEPS = 20  # (b): dense steps under torch.profiler
#: (c): the csr fit's child dies at its 3rd chunk's parse
OBS_FAULT = "parse.chunk:nth=3"
_PROM_LINE = re.compile(
    r'^[a-z_][a-z0-9_]*(\{([a-z_]+="([^"\\]|\\.)*",?)*\})? \S+$')


def obs_armed(tmp: str, tag: str, export: str) -> dict:
    """Every observability setting on, its files under ``tmp``."""
    return {"DMLC_TPU_METRICS": "1", "DMLC_TPU_DEVICE_TELEMETRY": "1",
            "DMLC_TPU_AUDIT": "full",
            "DMLC_TPU_STEP_SAMPLE_N": str(OBS_SAMPLE_N),
            "DMLC_TPU_TRACE": os.path.join(tmp, tag + ".trace.json"),
            "DMLC_TPU_METRICS_EXPORT": os.path.join(tmp, tag + export),
            "DMLC_TPU_FLIGHTREC": os.path.join(tmp, tag + ".rec")}


@contextlib.contextmanager
def obs_env(settings: dict):
    """Run the block under ``settings`` (None unsets a name), with the
    process's cached auditor, flight recorder and trace buffer reset so
    they re-read them; the environment is restored after."""
    from dmlc_tpu_torch.obs import audit, flight, trace

    saved = {k: os.environ.get(k) for k in settings}

    def apply(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        audit.reset_auditor()
        flight.reset()
        trace.clear()

    apply(settings)
    try:
        yield
    finally:
        apply(saved)


class ObsTap:
    """Collects, while installed, the goodput windows the ledgers close,
    each epoch's data chains as the auditor rolls them, and the cost
    record each instrumented site of the fit runs under (a reading aid of
    this script: the port's functions are wrapped, not changed)."""

    def __init__(self):
        from dmlc_tpu_torch.obs import audit, goodput, xla_cost

        self.windows, self.epochs, self.costs = [], [], {}
        self._orig = (goodput.GoodputLedger.tick, audit.Auditor.roll_epoch,
                      xla_cost.note_compile)
        tick, roll, note = self._orig
        tap = self

        def tapped_note(fn_name, *a, **k):
            out, rec = note(fn_name, *a, **k)
            tap.costs[fn_name] = rec
            return out, rec

        def tapped_tick(ledger, *a, **k):
            win = tick(ledger, *a, **k)
            tap.windows.append(win)
            return win

        def tapped_roll(auditor, epoch):
            with auditor._lock:
                tap.epochs.append({s: dict(auditor._chains.get(s, {}))
                                   for s in audit.DATA_STAGES})
            return roll(auditor, epoch)

        goodput.GoodputLedger.tick = tapped_tick
        audit.Auditor.roll_epoch = tapped_roll
        xla_cost.note_compile = tapped_note

    def close(self):
        from dmlc_tpu_torch.obs import audit, goodput, xla_cost

        (goodput.GoodputLedger.tick, audit.Auditor.roll_epoch,
         xla_cost.note_compile) = self._orig


def obs_linear_fit(path, layout, batch_size, nf, device=None, epochs=EPOCHS,
                   python_stack=False):
    """(history, params as numpy, launches, seconds) of phase 5/6's fit,
    the launch counts set to 0 just before it and read just after:
    ``fit_uri`` (its route by the parser's rules), or with
    ``python_stack`` a ``fit_feed`` over the Python stack's parser."""
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy
    from dmlc_tpu_torch.ops import kernels

    learner = LinearLearner(device=device, objective="logistic",
                            learning_rate=0.1)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if python_stack:
        feed = DeviceFeed(python_stack_parser(path, learner.device),
                          BatchSpec(batch_size=batch_size, layout=layout,
                                    num_features=nf),
                          device=learner.device)
        try:
            history = learner.fit_feed(feed, epochs=epochs)
        finally:
            feed.close()
    else:
        history = learner.fit_uri(path, batch_size=batch_size,
                                  epochs=epochs, layout=layout,
                                  num_features=nf)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    return history, params_to_numpy(learner.params), launches, seconds


def obs_fm_fit(path, start, python_stack=False):
    from dmlc_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    history, params, seconds = run_fm_fit(path, None, start,
                                          python_stack=python_stack)
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    return history, params, launches, seconds


def obs_gbdt_fit(x, y, dev):
    from dmlc_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    learner, history, seconds = gbdt_fit(x, y, dev,
                                         num_trees=OBS_GBDT_TREES)
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    return history, tree_bits(learner), launches, seconds


def same_bits(what, off, armed) -> None:
    """Phase 20 (a): the armed fit's losses, params and launches must be
    the fit-with-everything-off's, bit for bit."""
    h0, p0, l0, _ = off
    h1, p1, l1, _ = armed
    require(list(h0) == list(h1), "%s: loss history differs with the "
            "observability layer armed: %s vs %s", what, h0, h1)
    for k in p0:
        require(np.asarray(p0[k]).tobytes() == np.asarray(p1[k]).tobytes(),
                "%s: %s differs with the observability layer armed", what, k)
    require(l0 == l1, "%s: launches differ with the layer armed: %s vs %s",
            what, l0, l1)


def flow_chain(events) -> list:
    """The slice names one chunk's flow points sit in (a flow point binds
    to the slice open on its thread at its time), for the first flow that
    reaches a train_step."""
    slices = [e for e in events if e.get("ph") == "X"]
    flows = {}
    for e in events:
        if e.get("cat") == "dataflow":
            flows.setdefault(e["id"], []).append(e)
    best = []
    for points in flows.values():
        names = []
        for p in sorted(points, key=lambda e: e["ts"]):
            inside = [s for s in slices if s["tid"] == p["tid"]
                      and s["ts"] <= p["ts"] <= s["ts"] + s["dur"]]
            names += sorted({s["name"] for s in inside})
        if "train_step" in names:
            return names
        best = best or names
    return best


def read_exports(path: str) -> int:
    """Parse the metrics export (JSONL: every line an object with
    ``metrics``; Prometheus: every line a comment or a sample); returns
    the number of samples read."""
    text = open(path).read()
    if path.endswith(".prom"):
        samples = [line for line in text.splitlines()
                   if line and not line.startswith("#")]
        for line in samples:
            require(_PROM_LINE.match(line), "unparseable Prometheus line %r",
                    line)
            float(line.rsplit(" ", 1)[1])
        return len(samples)
    n = 0
    for line in text.splitlines():
        n += len(json.loads(line)["metrics"])
    return n


def hold_armed(what, model, steps, epochs, settings, tap, flat0,
               feed=True) -> dict:
    """Phase 20 (a): what an armed fit must leave: fit counters, one
    goodput window an epoch with a binding (and mfu / hbm_fraction on the
    step-instrumented fits), the flow chain in the trace, parseable
    exports and a clean audit over equal epochs."""
    from dmlc_tpu_torch import obs
    from dmlc_tpu_torch.obs import audit, xla_cost

    flat = obs.registry().flat_values()
    delta = {k: v - flat0.get(k, 0.0) for k, v in flat.items()}
    got = delta.get('dmlc_fit_steps_total{model="%s"}' % model)
    require(got == steps, "%s: dmlc_fit_steps_total %s for %d steps", what,
            got, steps)
    wins = tap.windows
    require(len(wins) == epochs and all(w.get("binding") for w in wins),
            "%s: %d goodput windows for %d epochs", what, len(wins), epochs)
    report = {"bindings": [w["binding"] for w in wins],
              "goodput_ratio": [w["goodput"]["ratio"] for w in wins],
              "budget_s": wins[-1]["budget_s"]}
    consume = [sum(v for k, v in delta.items()
                   if k.startswith("dmlc_feed_consume_ns{")
                   and k.endswith(suffix)) for suffix in (":sum", ":count")]
    if consume[1]:
        # device_step's budget a batch: the consumer's host time
        report["consume_ms_per_batch"] = consume[0] / consume[1] / 1e6
    if model in ("linear", "fm"):
        rec = tap.costs[model + ".step"]
        peak = xla_cost.probed_peak_flops()
        gbps = xla_cost.probed_hbm_gbps()
        mfu, hbm = [], []
        for w in wins:
            require("mfu" in w and "hbm_fraction" in w and "compute" in w,
                    "%s: a window lacks mfu / hbm_fraction: %s", what,
                    sorted(w))
            # the verdict takes the largest *.step site's costs in the
            # registry (every model this process fitted) and rounds to 4
            # places: the fractions of this fit's own step, unrounded
            steps_w = w["counters"]["steps"]
            mfu.append(steps_w * rec["flops"] / w["window_s"] / peak)
            hbm.append(steps_w * rec["bytes_accessed"] / w["window_s"]
                       / (gbps * 1e9))
        require(all(0 < v <= 1 for v in mfu + hbm),
                "%s: mfu %s / hbm_fraction %s outside (0, 1]", what, mfu,
                hbm)
        report.update(mfu=mfu, hbm_fraction=hbm,
                      mfu_verdict=[w["mfu"] for w in wins],
                      hbm_fraction_verdict=[w["hbm_fraction"] for w in wins],
                      step_cost={k: rec[k] for k in
                                 xla_cost.FIELDS + ("bucket", "extract_ms")})
    obs.flush_trace()
    events = json.load(open(settings["DMLC_TPU_TRACE"]))["traceEvents"]
    names = {e["name"] for e in events if e.get("ph") == "X"}
    if feed:
        chain = flow_chain(events)
        want = ["io_read", "parse", "stage", "consume", "train_step"]
        require(all(n in chain for n in want),
                "%s: one chunk's flow passes %s, not %s", what, chain, want)
        report["flow_chain"] = chain
    else:
        require("fit" in names, "%s: no fit span in the trace", what)
    report["trace_events"] = len(events)
    report["export_samples"] = read_exports(
        settings["DMLC_TPU_METRICS_EXPORT"])
    snap = audit.auditor().snapshot()
    require(not snap["divergences"], "%s: audit divergences %s", what,
            snap["divergences"])
    if feed:
        require(len(tap.epochs) == epochs, "%s: %d audit rolls", what,
                len(tap.epochs))
        for stage in audit.DATA_STAGES:
            require(tap.epochs[0][stage]
                    and tap.epochs[0][stage] == tap.epochs[-1][stage],
                    "%s: the %s chain differs between epochs", what, stage)
        report["audit_chain_lengths"] = {
            s: len(tap.epochs[0][s]) for s in audit.DATA_STAGES}
    return report, tap.epochs


def run_armed(what, model, steps, epochs, fit, tmp, tag, export,
              feed=True):
    """(fit result, report) of one fit with everything armed. The cost
    records are forgotten first, so the fit's first call of each site is
    recorded under the dispatch mode (its bits and launches are then held
    against the fit with the layer off)."""
    from dmlc_tpu_torch import obs
    from dmlc_tpu_torch.obs import device_telemetry, xla_cost

    settings = obs_armed(tmp, tag, export)
    with obs_env(settings):
        tap = ObsTap()
        try:
            device_telemetry.reset()
            flat0 = obs.registry().flat_values()
            result = fit()
            recorded = xla_cost.extraction_count()
            require(recorded >= len(tap.costs) > 0,
                    "%s: %d cost recordings for the sites %s", what,
                    recorded, sorted(tap.costs))
            report, chains = hold_armed(what, model, steps, epochs,
                                        settings, tap, flat0, feed=feed)
            report["recorded_sites"] = sorted(tap.costs)
        finally:
            tap.close()
    return result, report, chains


def cpu_chains(path, layout, batch_size, nf, tmp) -> list:
    """The data chains of a CPU-route fit of one epoch on ``path``."""
    settings = dict(OBS_DEFAULT, DMLC_TPU_AUDIT="full")
    with obs_env(settings):
        tap = ObsTap()
        try:
            obs_linear_fit(path, layout, batch_size, nf, device="cpu",
                           epochs=1, python_stack=True)
        finally:
            tap.close()
    return tap.epochs


# the csr fit on the Python stack, whose parse workers pass the
# OBS_FAULT faultpoint (the native route parses in C++)
_FLIGHT_CHILD = r"""
import sys
from dmlc_tpu_torch import collective
from dmlc_tpu_torch.data import PipelinedParser, create_parser
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.models import LinearLearner
collective.init()
learner = LinearLearner()
feed = DeviceFeed(PipelinedParser(create_parser(sys.argv[1], threaded=False,
                                                device=learner.device)),
                  BatchSpec(batch_size=int(sys.argv[2]), layout="csr",
                            num_features=int(sys.argv[3])),
                  device=learner.device)
learner.fit_feed(feed, epochs=1)
"""


def drive_flight_child(csr_file, tmp) -> dict:
    """Phase 20 (c): the csr fit in a child with ``OBS_FAULT`` injected
    and the recorder armed must die and leave ``fault.injected`` in
    ``flightrec-rank0.json``."""
    out_dir = os.path.join(tmp, "flight_child")
    env = dict(os.environ, DMLC_TPU_FLIGHTREC=out_dir,
               DMLC_TPU_FAULTS=OBS_FAULT,
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.abspath(__file__))]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _FLIGHT_CHILD, csr_file, str(CRITEO_BATCH),
         str(CRITEO_DIM + 1)], env=env, capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    require(proc.returncode != 0 and "InjectedFault" in proc.stderr,
            "flight child: exit %d, no InjectedFault:\n%s", proc.returncode,
            proc.stderr[-2000:])
    path = os.path.join(out_dir, "flightrec-rank0.json")
    require(os.path.exists(path), "flight child left no %s", path)
    dump = json.load(open(path))
    fired = [r for r in dump["records"] if r["kind"] == "fault.injected"]
    require([(r["site"], r["n"]) for r in fired] == [("parse.chunk", 3)],
            "flight dump: fault.injected records %s", fired)
    return {"exit_code": proc.returncode, "reason": dump["reason"],
            "records": len(dump["records"]),
            "kinds": sorted({r["kind"] for r in dump["records"]}),
            "seconds": seconds}


def drive_obs(kernels, dev, fit_files, fm_file, fm_start, tmp) -> dict:
    """Phase 20 (the module docstring): the observability layer on the
    card."""
    from dmlc_tpu_torch import obs
    from dmlc_tpu_torch.obs import device_telemetry, xla_cost

    out = {}
    dense = (fit_files["dense"], "dense", HIGGS_BATCH, HIGGS_FEATURES + 1)
    csr = (fit_files["csr"], "csr", CRITEO_BATCH, CRITEO_DIM + 1)
    steps = {"dense": EPOCHS * (HIGGS_ROWS // HIGGS_BATCH),
             "csr": EPOCHS * (CRITEO_ROWS // CRITEO_BATCH),
             "fm": EPOCHS * (CRITEO_ROWS // CRITEO_BATCH),
             "gbdt": OBS_GBDT_TREES}
    path_kernel = {"dense": "fused_linear_grads", "csr": "coo_segment_sum",
                   "fm": "coo_segment_sum"}

    # (a) the four fits with everything off, then armed. An armed audit
    # keeps create_parser on the Python stack (the native route has no
    # io_read / parse digest points), so both fits of a pair read through
    # the Python stack: the same route, the same bits
    from dmlc_tpu_torch.data import PipelinedParser, create_parser

    with obs_env(obs_armed(tmp, "route", ".jsonl")):
        parser = create_parser(dense[0])
        try:
            require(isinstance(parser, PipelinedParser), "phase 20: with "
                    "the audit armed create_parser gave %s",
                    type(parser).__name__)
        finally:
            parser.close()
    t0 = time.perf_counter()
    fits = {"dense": lambda: obs_linear_fit(*dense, python_stack=True),
            "csr": lambda: obs_linear_fit(*csr, python_stack=True),
            "fm": lambda: obs_fm_fit(fm_file, fm_start, python_stack=True)}
    exports = {"dense": ".jsonl", "csr": ".prom", "fm": ".jsonl",
               "gbdt": ".prom"}
    armed, card_chains = {}, {}
    for name, fit in fits.items():
        with obs_env(OBS_OFF):
            off = fit()
        model = "fm" if name == "fm" else "linear"
        on, report, card_chains[name] = run_armed(
            "phase 20 " + name, model, steps[name], EPOCHS, fit, tmp, name,
            exports[name])
        same_bits("phase 20 " + name, off, on)
        launches = on[2]
        # every libsvm read tokenizes on the card; FM reads libfm
        require(launches[path_kernel[name]] == steps[name]
                and (name == "fm") != (launches["tokenize_boundaries"] > 0),
                "phase 20 %s: launches %s for %d steps", name, launches,
                steps[name])
        report.update(launches=launches, seconds_off=off[3],
                      seconds_armed=on[3])
        armed[name] = report
    x, y = gbdt_data(GBDT_ROWS, seed=14)
    with obs_env(OBS_OFF):
        off = obs_gbdt_fit(x, y, dev)
    on, report, _ = run_armed("phase 20 gbdt", "gbdt", steps["gbdt"], 1,
                              lambda: obs_gbdt_fit(x, y, dev), tmp, "gbdt",
                              exports["gbdt"], feed=False)
    same_bits("phase 20 gbdt", off, on)
    report.update(launches=on[2], seconds_off=off[3], seconds_armed=on[3])
    armed["gbdt"] = report
    # the armed card fits' first-epoch chains against a CPU-route fit's on
    # the same files
    for name, spec in (("dense", dense), ("csr", csr)):
        card = card_chains[name][0]
        cpu = cpu_chains(*spec, tmp)[0]
        for stage in ("io_read", "parse", "batch"):
            require(card[stage] and card[stage] == cpu[stage],
                    "phase 20 %s: the card's %s chain differs from the CPU "
                    "route's", name, stage)
        armed[name]["cpu_chains_equal"] = True
    out["fits"] = armed
    out["a_seconds"] = time.perf_counter() - t0

    # (b) device telemetry
    t0 = time.perf_counter()
    tele = {}
    keep = torch.empty(1 << 24, device=dev)  # 64 MiB held across the read
    torch.cuda.synchronize()
    sampled = device_telemetry.sample()
    allocated = torch.cuda.memory_allocated(dev)
    label = "cuda:%d" % dev.index
    require(sampled["hbm"].get(label) == allocated,
            "dmlc_device_hbm_bytes %s != memory_allocated %d", sampled,
            allocated)
    require(device_telemetry.peak_hbm_bytes() > 0, "peak_hbm_bytes is 0")
    del keep
    tele.update(hbm_bytes=sampled["hbm"][label],
                live_bytes=sampled["live"][label],
                peak_hbm_bytes=device_telemetry.peak_hbm_bytes())
    recs = xla_cost.records()
    keys = [(r["fn"], r["bucket"]) for r in recs]
    require(len(keys) == len(set(keys)) == xla_cost.extraction_count(),
            "cost records are not one a site and signature: %s", keys)
    # a second epoch records nothing: epoch 1 alone, then epoch 2 on the
    # same learner (its steps' signatures are all seen)
    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import LinearLearner

    with obs_env(dict(OBS_DEFAULT)):
        device_telemetry.reset()
        learner = LinearLearner(objective="logistic")
        feed = DeviceFeed(create_parser(dense[0]), BatchSpec(
            batch_size=HIGGS_BATCH, layout="dense",
            num_features=HIGGS_FEATURES + 1))
        try:
            learner.fit_feed(feed, epochs=1)
            first = xla_cost.extraction_count()
            feed.before_first()
            learner.fit_feed(feed, epochs=2, start_epoch=1)
        finally:
            feed.close()
        require(first > 0 and xla_cost.extraction_count() == first,
                "cost records: %d after epoch 1, %d after epoch 2", first,
                xla_cost.extraction_count())
    tele["records_after_epoch_1"] = first
    tele["records"] = {f"{r['fn']}|{r['bucket']}": {
        k: r[k] for k in xla_cost.FIELDS} for r in xla_cost.records()}
    flops = xla_cost.probed_peak_flops()
    gbps = xla_cost.probed_hbm_gbps()
    tele["probed_peak_flops"] = flops
    tele["probed_hbm_gbps"] = gbps
    # beside the H100 SXM data sheet's f32 and memory rates
    tele["sheet_f32_flops"] = PEAK_F32_FLOPS
    tele["sheet_hbm_gbps"] = PEAK_BYTES_PER_S / 1e9
    tele["probed_over_sheet"] = {"flops": flops / PEAK_F32_FLOPS,
                                 "hbm": gbps * 1e9 / PEAK_BYTES_PER_S}
    step_ms = {}
    for model in ("linear", "fm"):
        hist = obs.registry().histogram("dmlc_step_device_ms", model=model)
        step_ms[model] = {"count": hist.count, "sum_ms": hist.sum,
                          "p50_ms": hist.quantile(0.5)}
    require(step_ms["linear"]["count"] >= 2 and step_ms["fm"]["count"] >= 2,
            "dmlc_step_device_ms sampled %s", step_ms)
    tele["step_device_ms"] = step_ms
    # device_step books the consumer's host time; one dense step's device
    # time under torch.profiler, beside it
    from dmlc_tpu_torch.models import (init_linear_params,
                                       make_linear_train_step)

    step = make_linear_train_step(None, objective="logistic",
                                  layout="dense",
                                  num_features=HIGGS_FEATURES + 1)
    gen = torch.Generator(device=dev).manual_seed(20)
    batch = {"x": torch.randn(HIGGS_BATCH, HIGGS_FEATURES + 1, device=dev,
                              generator=gen),
             "label": (torch.rand(HIGGS_BATCH, device=dev, generator=gen)
                       > 0.5).float(),
             "weight": torch.ones(HIGGS_BATCH, device=dev)}
    params = init_linear_params(HIGGS_FEATURES + 1, dev)
    velocity = {k: torch.zeros_like(v) for k, v in params.items()}
    step(params, velocity, batch)
    torch.cuda.synchronize()

    def steps():
        t = time.perf_counter()
        for _ in range(OBS_PROFILE_STEPS):
            step(params, velocity, batch)
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        return host_ms

    prof = profile_call(steps)
    tele["dense_step_profile"] = prof
    tele["dense_step_host_ms"] = prof["wall_ms"] / OBS_PROFILE_STEPS
    tele["dense_step_device_busy_ms"] = (
        None if prof["device_busy_ms"] is None
        else prof["device_busy_ms"] / OBS_PROFILE_STEPS)
    prof_dir = os.path.join(tmp, "profile")
    th = device_telemetry.capture_profile(1.0, out_dir=prof_dir)
    obs_linear_fit(*dense, epochs=1)
    th.join()
    trace_path = os.path.join(prof_dir, "profile-rank0-req0", "trace.json")
    require(os.path.exists(trace_path), "capture_profile wrote no trace")
    captured = json.load(open(trace_path))
    cuda_kernels = [e for e in captured.get("traceEvents", [])
                    if e.get("cat") == "kernel"]
    require(cuda_kernels, "capture_profile's trace holds no CUDA kernel")
    tele["profile_kernels"] = len(cuda_kernels)
    tele["profile_kernel_names"] = sorted(
        {e["name"][:40] for e in cuda_kernels})[:12]
    out["telemetry"] = tele
    out["b_seconds"] = time.perf_counter() - t0

    # (c) the flight recorder in a child
    out["flight"] = drive_flight_child(fit_files["csr"], tmp)

    # (d) what the layer costs: rows/s (GBDT: rows·trees/s), the median
    # of OBS_RUNS runs, every setting on the Python stack (the route the
    # armed audit keeps)
    t0 = time.perf_counter()
    cost = {}
    for name, fit, rows in (
            ("dense", lambda: obs_linear_fit(*dense, python_stack=True),
             EPOCHS * HIGGS_ROWS),
            ("csr", lambda: obs_linear_fit(*csr, python_stack=True),
             EPOCHS * CRITEO_ROWS),
            ("gbdt", lambda: obs_gbdt_fit(x, y, dev),
             GBDT_ROWS * OBS_GBDT_TREES)):
        cost[name] = {}
        for setting in ("default", "metrics_off", "armed"):
            env = {"default": OBS_DEFAULT,
                   "metrics_off": dict(OBS_DEFAULT, DMLC_TPU_METRICS="0"),
                   "armed": obs_armed(tmp, "cost_" + name, ".jsonl")
                   }[setting]
            runs = []
            for _ in range(OBS_RUNS):
                with obs_env(env):
                    runs.append(fit()[3])
            cost[name][setting] = {
                "rows_per_s": rows / statistics.median(runs),
                "seconds": runs}
    out["cost"] = cost
    out["d_seconds"] = time.perf_counter() - t0
    return out


def obs_summary(card, report) -> dict:
    """The ``obs`` line: phase 20's numbers beside the card."""
    fits = report["fits"]
    tele = report["telemetry"]
    return {
        "card": card,
        "bindings": {k: v["bindings"] for k, v in fits.items()},
        "mfu": {k: v.get("mfu") for k, v in fits.items()},
        "hbm_fraction": {k: v.get("hbm_fraction") for k, v in fits.items()},
        "seconds_off_vs_armed": {k: [v["seconds_off"], v["seconds_armed"]]
                                 for k, v in fits.items()},
        "probed_peak_flops": tele["probed_peak_flops"],
        "probed_hbm_gbps": tele["probed_hbm_gbps"],
        "sheet_f32_flops": tele["sheet_f32_flops"],
        "sheet_hbm_gbps": tele["sheet_hbm_gbps"],
        "step_device_ms": tele["step_device_ms"],
        "peak_hbm_bytes": tele["peak_hbm_bytes"],
        "rows_per_s": {k: {s: v[s]["rows_per_s"] for s in v}
                       for k, v in report["cost"].items()},
        "flight": {k: report["flight"][k] for k in ("reason", "records")},
        "phase_seconds": report["seconds"],
    }


# ---------------------------------------------------------------------------
# phase 21: the binary ingest formats on the card
# ---------------------------------------------------------------------------


def row_fingerprints(block) -> np.ndarray:
    """One uint64 a row of (label, ids, values), sorted: equal for two
    blocks holding the same rows in any order."""
    ids = block.index.astype(np.uint64)
    vals = block.value.view(np.uint32).astype(np.uint64)
    mixed = (ids * np.uint64(0x9E3779B97F4A7C15)) ^ (
        vals * np.uint64(0xBF58476D1CE4E5B9))
    rows = np.zeros(len(block), dtype=np.uint64)
    nonempty = np.diff(block.offset) > 0
    starts = block.offset[:-1][nonempty]
    rows[nonempty] = np.add.reduceat(mixed, starts)
    return np.sort(rows ^ block.label.view(np.uint32).astype(np.uint64))


def files_equal(a: str, b: str) -> bool:
    import filecmp

    return filecmp.cmp(a, b, shallow=False)


def drive_formats(kernels, dev, ingest_file, csr_file, csr_path, csr_params,
                  tmp) -> dict:
    """Phase 21 (the module docstring)."""
    from dmlc_tpu_torch.collective import JobSnapshot
    from dmlc_tpu_torch.data import (RowBlockContainer, convert_to_recordio,
                                     create_parser, create_row_block_iter)
    from dmlc_tpu_torch.io import build_index
    from dmlc_tpu_torch.tools.bake import bake_dataset, part_path

    report = {"file_bytes": os.path.getsize(ingest_file)}
    card_dir, cpu_dir = os.path.join(tmp, "card"), os.path.join(tmp, "cpu")
    os.makedirs(card_dir)
    os.makedirs(cpu_dir)

    def tokenized(what, fn):
        """(fn's result, seconds, tokenizer launches): every route here
        (the native text, recordio and cache routes, the shard parser)
        hands no chunk part to the libsvm parser and launches the
        tokenizer 0 times."""
        kernels.reset_launch_counts()
        with count_parts() as parts:
            t0 = time.perf_counter()
            out = fn()
            seconds = time.perf_counter() - t0
        launches = kernels.tokenize_boundaries.launches
        hold_tokens(what, launches, len(parts))
        return out, seconds, launches

    # (a) text -> .rec (+ index) and .dtsh on the card, byte-equal to the
    # CPU route's files
    rec = os.path.join(card_dir, "criteo.rec")
    dtsh = os.path.join(card_dir, "criteo.dtsh")
    rows, rec_s, rec_launches = tokenized(
        "convert_to_recordio", lambda: convert_to_recordio(
            ingest_file, rec, rows_per_group=REC_ROWS, device=dev))
    require(rows == INGEST_ROWS, "convert_to_recordio wrote %d rows", rows)
    t0 = time.perf_counter()
    groups = build_index(rec, rec + ".idx")
    index_s = time.perf_counter() - t0
    # a group never spans two parsed blocks (chunks): at least one a
    # REC_ROWS rows
    require(groups >= -(-INGEST_ROWS // REC_ROWS), "build_index: %d records",
            groups)
    baked, bake_s, bake_launches = tokenized(
        "bake", lambda: bake_dataset(ingest_file, dtsh, nparts=BAKE_PARTS,
                                     rows_per_window=SHARD_ROWS, device=dev))
    require(baked["rows"] == INGEST_ROWS and not baked["skipped"],
            "bake: %s", baked)
    cpu_rec = os.path.join(cpu_dir, "criteo.rec")
    cpu_dtsh = os.path.join(cpu_dir, "criteo.dtsh")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    convert_to_recordio(ingest_file, cpu_rec, rows_per_group=REC_ROWS,
                        device="cpu")
    cpu_rec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bake_dataset(ingest_file, cpu_dtsh, nparts=BAKE_PARTS,
                 rows_per_window=SHARD_ROWS, device="cpu")
    cpu_bake_s = time.perf_counter() - t0
    require(kernels.tokenize_boundaries.launches == 0,
            "the CPU route's conversions launched a kernel")
    require(files_equal(rec, cpu_rec),
            "the card's .rec differs from the CPU route's")
    dtsh_files = [part_path(dtsh, k, BAKE_PARTS) for k in range(BAKE_PARTS)]
    for k, path in enumerate(dtsh_files):
        require(files_equal(path, part_path(cpu_dtsh, k, BAKE_PARTS)),
                "the card's shard part %d differs from the CPU route's", k)
    mb = report["file_bytes"] / 1e6
    report["convert"] = {
        "rec": {"seconds": rec_s, "text_mb_per_s": mb / rec_s,
                "tokenize_launches": rec_launches, "groups": groups,
                "index_seconds": index_s, "cpu_seconds": cpu_rec_s,
                "bytes": os.path.getsize(rec), "byte_equal_to_cpu": True},
        "dtsh": {"seconds": bake_s, "text_mb_per_s": mb / bake_s,
                 "tokenize_launches": bake_launches, "parts": BAKE_PARTS,
                 "cpu_seconds": cpu_bake_s, "bytes": baked["bytes"],
                 "byte_equal_to_cpu": True}}
    print(json.dumps({"formats_convert": report["convert"]}), flush=True)

    # (b) every route through create_row_block_iter / create_parser on the
    # card
    def read_iter(uri):
        return read_all(create_row_block_iter(uri, device=dev))[0]

    def read_parser(uri):
        parser = create_parser(uri, device=dev)
        cont = RowBlockContainer()
        try:
            for block in parser:
                cont.push_block(block)
        finally:
            parser.close()
        return cont.to_block()

    dtsh_uri = os.path.join(card_dir, r"criteo-.*\.dtsh")
    cache = os.path.join(tmp, "criteo.chunks")
    # the native #cachefile keeps its row groups at <cache>.rowrec
    routes = (
        ("text", lambda: read_iter(ingest_file), ingest_file),
        ("rec", lambda: read_iter(rec + "?format=recordio"), rec),
        ("dtsh_mmap", lambda: read_iter(dtsh_uri), dtsh_files),
        ("dtsh_read", lambda: read_iter(dtsh_uri), dtsh_files),
        ("text_shuffle_chunks", lambda: read_iter(
            "%s?shuffle_chunks=%d" % (ingest_file, SHUFFLE_SEED)),
         ingest_file),
        ("text_cachefile_cold", lambda: read_parser(ingest_file + "#" + cache),
         ingest_file),
        ("text_cachefile_warm", lambda: read_parser(ingest_file + "#" + cache),
         cache + ".rowrec"),
    )
    ingest, text = {}, None
    for name, read, files in routes:
        if name == "dtsh_read":
            os.environ["DMLC_TPU_SHARD_MMAP"] = "0"
        try:
            block, seconds, launches = tokenized(name, read)
        finally:
            os.environ.pop("DMLC_TPU_SHARD_MMAP", None)
        nbytes = sum(os.path.getsize(f) for f in
                     ([files] if isinstance(files, str) else files))
        if text is None:
            text = block
        elif name == "text_shuffle_chunks":
            require(len(block) == len(text) and not (
                np.array_equal(block.offset, text.offset)
                and np.array_equal(block.index, text.index)),
                "the shuffled read kept the text order (%d rows)",
                len(block))
            require(np.array_equal(row_fingerprints(block),
                                   row_fingerprints(text)),
                    "the shuffled read holds other rows than the text's")
        else:
            same_blocks("ingest from %s (against the text route)" % name,
                        block, text)
        ingest[name] = {"seconds": seconds, "bytes": nbytes,
                        "mb_per_s": nbytes / 1e6 / seconds,
                        "rows_per_s": len(block) / seconds,
                        "tokenize_launches": launches}
        del block
    require(len(text) == INGEST_ROWS, "the text route read %d rows",
            len(text))
    del text
    report["ingest"] = ingest
    print(json.dumps({"formats_ingest": ingest}), flush=True)

    # (c) phase 6's csr fit from .rec and .dtsh: phase 6's bits
    fit_rec = os.path.join(card_dir, "criteo_fit.rec")
    fit_dtsh = os.path.join(card_dir, "criteo_fit.dtsh")
    convert_to_recordio(csr_file, fit_rec, rows_per_group=REC_ROWS,
                        device=dev)
    bake_dataset(csr_file, fit_dtsh, rows_per_window=SHARD_ROWS, device=dev)
    steps = EPOCHS * (-(-CRITEO_ROWS // CRITEO_BATCH))
    fits = {"text_rows_per_s": csr_path["rows_per_s"]}
    for name, uri in (("rec", fit_rec + "?format=recordio"),
                      ("dtsh", fit_dtsh)):
        kernels.reset_launch_counts()
        history, params, seconds = run_fit(uri, "csr", CRITEO_BATCH,
                                           CRITEO_DIM + 1, None)
        seg = kernels.coo_segment_sum.launches
        tok = kernels.tokenize_boundaries.launches
        require(seg == steps and tok == 0, "%s fit: coo_segment_sum %d for "
                "%d steps, tokenizer %d", name, seg, steps, tok)
        same_fit("%s fit vs phase 6's text fit" % name, (history, params),
                 (csr_path["loss_history"], csr_params))
        fits[name] = {"seconds": seconds, "steps": steps,
                      "rows_per_s": EPOCHS * CRITEO_ROWS / seconds,
                      "coo_segment_sum_launches": seg,
                      "bit_identical_to_text": True}
    report["fit"] = fits
    print(json.dumps({"formats_fit": fits}), flush=True)

    # (d) a shuffled shard fit SIGTERM'd in a child as it enters epoch
    # SIGNAL_AT_EPOCH, resumed in another: the uninterrupted run's bits
    uri = "%s?shuffle_chunks=%d" % (fit_dtsh, SHUFFLE_SEED)
    t0 = time.perf_counter()
    whole = snap_linear_fit(uri, RESUME_EPOCHS)
    whole_s = time.perf_counter() - t0
    plain = snap_linear_fit(fit_dtsh, RESUME_EPOCHS)
    require(whole[0] != plain[0], "the shuffled fit's losses equal the "
            "unshuffled fit's: the shuffle did not move a window")
    model = os.path.join(tmp, "shuffled.model")
    whole[2].save(model)
    spec = {"file": uri, "epochs": RESUME_EPOCHS,
            "snap": os.path.join(tmp, "shuffle_snap"),
            "model": os.path.join(tmp, "shuffle_resumed.model"),
            "resume": False, "pause_epoch": SIGNAL_AT_EPOCH,
            "marker": os.path.join(tmp, "shuffle_epoch%d" % SIGNAL_AT_EPOCH)}
    rc, first_s, tail = run_snap_child(spec, tmp, True)
    require(rc == 75, "the signalled shard child exited with %s, not 75:\n%s",
            rc, tail)
    meta = JobSnapshot(spec["snap"]).restore()[2]
    require(meta.get("epoch") == SIGNAL_AT_EPOCH - 1, "the shard child "
            "committed epoch %s, not %d", meta.get("epoch"),
            SIGNAL_AT_EPOCH - 1)
    resumed = dict(spec, resume=True, pause_epoch=0)
    rc, second_s, tail = run_snap_child(resumed, tmp, False)
    require(rc == 0, "the resumed shard child exited with %s:\n%s", rc, tail)
    require(files_equal(model, spec["model"]), "the resumed shuffled shard "
            "fit's model differs from the uninterrupted run's")
    report["resume"] = {"epochs": RESUME_EPOCHS, "exit_code": 75,
                        "manifest_epoch": meta["epoch"],
                        "uninterrupted_s": whole_s,
                        "first_child_s": first_s, "resumed_child_s": second_s,
                        "model_bytes_equal": True}
    print(json.dumps({"formats_resume": report["resume"]}), flush=True)
    return report


def formats_summary(card, report) -> dict:
    """The ``formats`` line: phase 21's seconds, MB/s and rows/s."""
    conv, fit = report["convert"], report["fit"]
    return {
        "card": card,
        "convert_seconds": {k: v["seconds"] for k, v in conv.items()},
        "convert_cpu_seconds": {k: v["cpu_seconds"] for k, v in conv.items()},
        "ingest_mb_per_s": {k: v["mb_per_s"]
                            for k, v in report["ingest"].items()},
        "ingest_rows_per_s": {k: v["rows_per_s"]
                              for k, v in report["ingest"].items()},
        "fit_rows_per_s": {"text": fit["text_rows_per_s"],
                           "rec": fit["rec"]["rows_per_s"],
                           "dtsh": fit["dtsh"]["rows_per_s"]},
        "resume_bit_identical": report["resume"]["model_bytes_equal"],
        "phase_seconds": report["seconds"]}


# ---------------------------------------------------------------------------
# phase 22: remote filesystems on the card
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def remote_fakes():
    """The repo's fake servers on 127.0.0.1 (``s3://`` and ``gs://`` each
    on its own ``fake_object_store``, ``hdfs://``, ``azure://``), the
    port's backends pointed at them through their environment names and
    registered again (each cached instance reads its environment once).
    Yields {"s3": store, "gs": store, "hdfs": fake, "azure": store,
    "hdfs_root": uri}; restores the environment after."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests"))
    import fake_azure
    import fake_object_store
    import fake_webhdfs

    from dmlc_tpu_torch.io import filesystem
    from dmlc_tpu_torch.io.azure import AzureBlobFileSystem
    from dmlc_tpu_torch.io.object_store import GCSFileSystem, S3FileSystem
    from dmlc_tpu_torch.io.webhdfs import _factory as hdfs_factory

    s3_server, s3, s3_base = fake_object_store.serve()
    gs_server, gs, gs_base = fake_object_store.serve()
    az_server, az, az_base = fake_azure.serve()
    hdfs = fake_webhdfs.FakeWebHDFS()
    hosts = "127.0.0.1,localhost"
    env = {"S3_ENDPOINT": s3_base, "GCS_ENDPOINT_URL": gs_base,
           "AZURE_STORAGE_ENDPOINT": az_base,
           "no_proxy": ",".join(filter(None, [os.environ.get("no_proxy"),
                                              hosts])),
           "NO_PROXY": ",".join(filter(None, [os.environ.get("NO_PROXY"),
                                              hosts]))}
    cleared = ("AWS_ENDPOINT_URL", "AWS_ACCESS_KEY_ID",
               "AWS_SECRET_ACCESS_KEY", "S3_ACCESS_KEY", "S3_SECRET_KEY",
               "GCS_OAUTH_TOKEN", "AZURE_STORAGE_ACCOUNT",
               "AZURE_STORAGE_ACCESS_KEY", "AZURE_STORAGE_KEY",
               "AZURE_STORAGE_SAS_TOKEN", "DMLC_WEBHDFS_ENDPOINT",
               "HADOOP_USER_NAME", "DMLC_TPU_FAULTS")
    saved = {k: os.environ.get(k) for k in list(env) + list(cleared)}
    os.environ.update(env)
    for k in cleared:
        os.environ.pop(k, None)
    backends = {"s3://": lambda uri: S3FileSystem(),
                "gs://": lambda uri: GCSFileSystem(),
                "hdfs://": hdfs_factory,
                "azure://": lambda uri: AzureBlobFileSystem()}
    for proto, factory in backends.items():
        filesystem.register_filesystem(proto, factory)
    try:
        yield {"s3": s3, "gs": gs, "azure": az, "hdfs": hdfs,
               "hdfs_root": f"hdfs://127.0.0.1:{hdfs.port}"}
    finally:
        for server in (s3_server, gs_server, az_server):
            server.shutdown()
            server.server_close()
        hdfs.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for proto, factory in backends.items():
            filesystem.register_filesystem(proto, factory)


def halves(path: str):
    """The file's bytes cut in two at the line break nearest its middle."""
    with open(path, "rb") as fh:
        data = fh.read()
    cut = data.index(b"\n", len(data) // 2) + 1
    return data[:cut], data[cut:]


def drive_remote(kernels, dev, ingest_file, ingest, fit_files, paths,
                 fit_params, tmp) -> dict:
    """Phase 22 (the module docstring)."""
    from dmlc_tpu_torch import resilience
    from dmlc_tpu_torch.collective import CheckpointManager, JobSnapshot
    from dmlc_tpu_torch.data import create_row_block_iter
    from dmlc_tpu_torch.models import (LinearLearner, params_from_numpy,
                                       params_to_numpy)
    from dmlc_tpu_torch.resilience import preempt, retry

    report = {}
    csr_fit = ("csr", CRITEO_BATCH, CRITEO_DIM + 1)
    dense_fit = ("dense", HIGGS_BATCH, HIGGS_FEATURES + 1)
    with remote_fakes() as fakes:
        root = {"s3": "s3://bkt", "gs": "gs://bkt",
                "azure": "azure://cont", "hdfs": fakes["hdfs_root"]}
        with open(ingest_file, "rb") as fh:
            fakes["s3"].objects[("bkt", "ingest/criteo.svm")] = fh.read()
        for i, part in enumerate(halves(fit_files["csr"])):
            fakes["s3"].objects[("bkt", f"csr/part-{i}")] = part
            fakes["azure"].blobs[("cont", f"csr/part-{i}")] = part
            fakes["hdfs"].files[f"/csr/part-{i}"] = part
        for i, part in enumerate(halves(fit_files["dense"])):
            fakes["gs"].objects[("bkt", f"higgs/part-{i}")] = part

        def read(uri):
            """(block, seconds, tokenizer launches) of one read on the
            card: the native route (the remote bytes pushed into the
            native pipeline), no tokenizer launch."""
            kernels.reset_launch_counts()
            with count_parts() as parts:
                t0 = time.perf_counter()
                block = read_all(create_row_block_iter(uri, device=dev))[0]
                seconds = time.perf_counter() - t0
            launches = kernels.tokenize_boundaries.launches
            hold_tokens(uri, launches, len(parts))
            return block, seconds, launches

        # (a) reads, each against the local read of the same bytes on the
        # same route: phase 26's native read of phase 12's file
        nbytes = os.path.getsize(ingest_file)
        block, seconds, launches = read("s3://bkt/ingest/criteo.svm")
        native = ingest["native"]
        require(block_digest(block) == native["digest"],
                "the s3:// read of phase 12's file: its rows differ from "
                "the local native read's")
        reads = {"ingest_s3": {"mb_per_s": nbytes / 1e6 / seconds,
                               "seconds": seconds, "launches": launches,
                               "local_mb_per_s": native["card_mb_per_s"]}}
        del block
        nbytes = os.path.getsize(fit_files["csr"])
        local, seconds, local_launches = read(fit_files["csr"])
        reads["csr_local"] = {"mb_per_s": nbytes / 1e6 / seconds,
                              "seconds": seconds, "launches": local_launches}
        for scheme in ("s3", "hdfs", "azure"):
            block, seconds, launches = read(f"{root[scheme]}/csr")
            same_blocks(f"the {scheme}:// read of phase 6's two parts "
                        "(against the local read)", block, local)
            require(launches == local_launches, "%s:// read: %d tokenizer "
                    "launches, the local read %d", scheme, launches,
                    local_launches)
            reads[f"csr_{scheme}"] = {"mb_per_s": nbytes / 1e6 / seconds,
                                      "seconds": seconds,
                                      "launches": launches}
        del local, block
        report["reads"] = reads
        print(json.dumps({"remote_reads": reads}), flush=True)

        # (b) the fits, phases 5 and 6's bits
        def held_fit(what, uri, fit, kernel_name, rows, want_path,
                     want_params):
            steps = EPOCHS * (-(-rows // fit[1]))
            kernels.reset_launch_counts()
            history, params, seconds = run_fit(uri, *fit, dev)
            launches = kernels.KERNELS[kernel_name].launches
            tokens = kernels.tokenize_boundaries.launches
            require(launches == steps and
                    tokens == want_path["tokenize_launches"],
                    "%s: %s %d times in %d steps, tokenizer %d (local %d)",
                    what, kernel_name, launches, steps, tokens,
                    want_path["tokenize_launches"])
            same_fit(what, (history, params),
                     (want_path["loss_history"], want_params))
            return {"seconds": seconds,
                    "rows_per_s": EPOCHS * rows / seconds,
                    "local_rows_per_s": want_path["rows_per_s"],
                    kernel_name + "_launches": launches,
                    "tokenize_launches": tokens, "bit_identical": True}

        fits = {}
        for scheme in ("s3", "hdfs", "azure"):
            fits[f"csr_{scheme}"] = held_fit(
                f"the csr fit from {scheme}://", f"{root[scheme]}/csr",
                csr_fit, "coo_segment_sum", CRITEO_ROWS, paths["csr"],
                fit_params["csr"])
        fits["dense_gs"] = held_fit(
            "the dense fit from gs://", f"{root['gs']}/higgs", dense_fit,
            "fused_linear_grads", HIGGS_ROWS, paths["dense"],
            fit_params["dense"])
        report["fits"] = fits
        print(json.dumps({"remote_fits": fits}), flush=True)

        # (c) the s3:// fit through dropped connections and injected
        # read faults
        before = dict(retry.stats()["attempts"])
        fakes["s3"].fail_after_bytes = REMOTE_FAIL_AFTER
        os.environ["DMLC_TPU_FAULTS"] = REMOTE_FAULTS
        resilience.reset()  # the faultpoints read DMLC_TPU_FAULTS again
        try:
            fired0 = len(resilience.faults.stats()["fired"])
            faulted = held_fit("the faulted csr fit from s3://",
                               f"{root['s3']}/csr", csr_fit,
                               "coo_segment_sum", CRITEO_ROWS, paths["csr"],
                               fit_params["csr"])
            injected = len(resilience.faults.stats()["fired"]) - fired0
        finally:
            fakes["s3"].fail_after_bytes = None
            os.environ.pop("DMLC_TPU_FAULTS", None)
            resilience.reset()
        after = retry.stats()["attempts"]
        retries = after.get("io.read", 0) - before.get("io.read", 0)
        require(retries > 0 and injected > 0, "the faulted fit retried %d "
                "reads, %d faults injected", retries, injected)
        faulted.update(io_read_retries=retries, injected_faults=injected,
                       giveups=retry.stats()["giveups"].get("io.read", 0))
        report["faulted"] = faulted
        print(json.dumps({"remote_faulted": faulted}), flush=True)

        # (d) snapshots, checkpoints and saved models
        snap_uri = f"{root['s3']}/snap"
        local_snap = os.path.join(tmp, "remote_local_snap")
        try:
            run_fit(f"{root['s3']}/csr", *csr_fit, dev, epochs=1,
                    snapshot_uri=snap_uri)
            run_fit(fit_files["csr"], *csr_fit, dev, epochs=1,
                    snapshot_uri=local_snap)
            for name in ("snap_v1.rank0", "snap_v1.manifest", "LATEST"):
                with open(os.path.join(local_snap, name), "rb") as fh:
                    want = fh.read()
                require(fakes["s3"].objects.get(("bkt", f"snap/{name}"))
                        == want, "the s3:// snapshot's %s differs from the "
                        "local commit's", name)
            kernels.reset_launch_counts()
            history, params, resume_s = run_fit(
                f"{root['s3']}/csr", *csr_fit, dev, snapshot_uri=snap_uri,
                resume=True)
        finally:
            preempt.uninstall()
        same_fit("the csr fit resumed from the s3:// snapshot",
                 (history, params), (paths["csr"]["loss_history"],
                                     fit_params["csr"]))
        require(kernels.coo_segment_sum.launches == CRITEO_ROWS
                // CRITEO_BATCH, "the resumed fit stepped %d times",
                kernels.coo_segment_sum.launches)
        t0 = time.perf_counter()
        version, state, meta = JobSnapshot(snap_uri).restore()
        restore_s = time.perf_counter() - t0
        require(version == 2 and meta.get("epoch") == 1,
                "the s3:// snapshot restored v%d epoch %s", version,
                meta.get("epoch"))
        t0 = time.perf_counter()
        JobSnapshot(f"{root['s3']}/snap_copy").commit(state, meta=meta)
        commit_s = time.perf_counter() - t0
        mgr = CheckpointManager("mem://ckpt/phase22")
        mgr.checkpoint(fit_params["csr"])
        got = CheckpointManager("mem://ckpt/phase22").load_checkpoint()[1]
        require(all(got[k].tobytes() == fit_params["csr"][k].tobytes()
                    for k in ("w", "b")),
                "the mem:// checkpoint changed the params")
        learner = LinearLearner(device=dev, objective="logistic")
        learner.params = params_from_numpy(params, dev)
        learner.save(f"{root['s3']}/model/csr.model")
        local_model = os.path.join(tmp, "remote_local.model")
        learner.save(local_model)
        with open(local_model, "rb") as fh:
            require(fakes["s3"].objects[("bkt", "model/csr.model")]
                    == fh.read(), "the s3:// model differs from the local "
                    "save")
        back = LinearLearner(device=dev)
        back.load(f"{root['s3']}/model/csr.model")
        same_fit("the model loaded from s3://",
                 (history, params_to_numpy(back.params)), (history, params))
        report["checkpoints"] = {
            "resume_seconds": resume_s, "restore_seconds": restore_s,
            "commit_seconds": commit_s,
            "part_bytes": len(fakes["s3"].objects[("bkt",
                                                   "snap/snap_v2.rank0")]),
            "bytes_equal_to_local": True, "resume_bit_identical": True}
        print(json.dumps({"remote_checkpoints": report["checkpoints"]}),
              flush=True)
        served = {"s3": fakes["s3"].request_count,
                  "gs": fakes["gs"].request_count,
                  "azure": fakes["azure"].request_count,
                  "hdfs": len(fakes["hdfs"].open_requests)}
        require(all(served.values()), "a fake served no request (a proxy "
                "in the way?): %s", served)
        report["requests_served"] = served
    return report


def remote_summary(card, report) -> dict:
    """The ``remote`` line: phase 22's MB/s, rows/s, seconds and
    retries."""
    reads, fits = report["reads"], report["fits"]
    return {
        "card": card,
        "read_mb_per_s": {k: v["mb_per_s"] for k, v in reads.items()},
        "local_native_card_mb_per_s": reads["ingest_s3"]["local_mb_per_s"],
        "fit_rows_per_s": {k: v["rows_per_s"] for k, v in fits.items()},
        "local_fit_rows_per_s": {"csr": fits["csr_s3"]["local_rows_per_s"],
                                 "dense": fits["dense_gs"]
                                 ["local_rows_per_s"]},
        "faulted_rows_per_s": report["faulted"]["rows_per_s"],
        "io_read_retries": report["faulted"]["io_read_retries"],
        "injected_faults": report["faulted"]["injected_faults"],
        "commit_seconds": report["checkpoints"]["commit_seconds"],
        "restore_seconds": report["checkpoints"]["restore_seconds"],
        "resume_seconds": report["checkpoints"]["resume_seconds"],
        "phase_seconds": report["seconds"]}


# ---------------------------------------------------------------------------
# phase 23: the fault-tolerant data service on the card
# ---------------------------------------------------------------------------


def rows_digest(fingerprints) -> str:
    """sha256 of a read's sorted row fingerprints (``row_fingerprints``
    of each block, joined): equal for the same rows in any order."""
    import hashlib

    rows = np.sort(np.concatenate(fingerprints)) if fingerprints else \
        np.zeros(0, dtype=np.uint64)
    return hashlib.sha256(rows.tobytes()).hexdigest()


class Worker:
    """One ``python -m dmlc_tpu_torch.tools serve --dispatcher`` process on
    the card: started, read up to its ``serving HOST PORT`` line
    (registered by then), and at the end its exit code and its
    ``{"worker": ...}`` report (tokenizer launches, chunks parsed)."""

    def __init__(self, address, tmp: str, name: str, device, **env):
        self.name = name
        self.log = os.path.join(tmp, name + ".log")
        root = os.path.dirname(os.path.abspath(__file__))
        full = dict(os.environ)
        full.pop("DMLC_TPU_FAULTS", None)
        full.update({k: str(v) for k, v in env.items()})
        self._err = open(self.log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dmlc_tpu_torch.tools", "serve",
             "--dispatcher", "%s:%d" % tuple(address), "--host",
             "127.0.0.1", "--port", "0", "--grace", "30", "--device",
             str(device)],
            cwd=root, env=full, stdout=subprocess.PIPE,
            stderr=self._err, text=True)
        self.report = None

    def serving(self) -> None:
        import select

        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    RANK_TIMEOUT_S)
        line = self.proc.stdout.readline() if ready else ""
        require(line.startswith("serving "), "worker %s did not start: "
                "%r\n%s", self.name, line, self.tail())

    def tail(self) -> str:
        with open(self.log) as fh:
            return fh.read()[-4000:]

    def finish(self, expect_rc: int) -> dict:
        try:
            out, _ = self.proc.communicate(timeout=RANK_TIMEOUT_S)
        finally:
            self.kill()
        require(self.proc.returncode == expect_rc, "worker %s exited with "
                "%s, expected %d:\n%s", self.name, self.proc.returncode,
                expect_rc, self.tail())
        lines = [json.loads(line)["worker"] for line in out.splitlines()
                 if line.startswith('{"worker"')]
        require(len(lines) == 1, "worker %s printed no report: %r",
                self.name, out)
        self.report = lines[0]
        return self.report

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._err.close()


def served_read(address, job: str, dev):
    """Drain ``job`` through one ``RemoteBlockParser``: (the rows' digest,
    bytes of the blocks, seconds of the drain, seqs in arrival order)."""
    from dmlc_tpu_torch.data import RemoteBlockParser

    t0 = time.perf_counter()
    parser = RemoteBlockParser(address, dispatcher=True, job=job,
                               device=dev)
    try:
        blocks = list(parser)
    finally:
        parser.close()
    seconds = time.perf_counter() - t0
    return (rows_digest([row_fingerprints(b) for b in blocks]),
            parser.bytes_read, seconds, [b.seq_id for b in blocks])


class ChunkReplay:
    """Parser over chunks ``order`` of ``path``: ``create_parser(path, k,
    N)`` blocks on the card, concatenated in that order. The local fit
    over it is what a fleet-fed fit that received the chunks in that
    order must equal."""

    def __init__(self, path, order, nchunks, dev):
        self._path, self._order, self._n, self._dev = path, order, nchunks, \
            dev
        self.bytes_read = 0

    def __iter__(self):
        from dmlc_tpu_torch.data import create_parser

        for part in self._order:
            parser = create_parser(self._path, part, self._n,
                                   device=self._dev)
            try:
                yield from parser
            finally:
                parser.close()

    def before_first(self):
        raise SmokeFailure("a chunk replay is one pass")

    def close(self):
        pass


def fleet_fit(kernels, address, dev, layout, batch_size, nf, epochs,
              parser_of, host_prefetch=None):
    """The linear fit of phases 5-6, one epoch a job: epoch e reads
    ``parser_of(e)`` (a dispatcher consumer of job ``<layout>e``, or a
    replay) through a DeviceFeed (its producer thread at
    ``host_prefetch``, None for the default) and continues the same
    learner. Returns (history, params as numpy, seconds, launches, seq
    orders, each epoch's rows digest, the consumer's trace). The trace has
    one entry an epoch: the feed's stage times (``DeviceFeed.stats``, ns)
    and, where the epoch reads a dispatcher's job, the seconds each
    ``next_block`` of the consumer took (the fetch of a served chunk):
    count, sum, median and max."""
    from dmlc_tpu_torch.data import RemoteBlockParser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    class Recorder(RemoteBlockParser):
        """The consumer, noting each chunk's seq and rows as they land."""

        def next_block(self):
            t0 = time.perf_counter()
            block = super().next_block()
            fetches[-1].append(time.perf_counter() - t0)
            if block is not None:
                orders[-1].append(block.seq_id)
                prints[-1].append(row_fingerprints(block))
            return block

    learner = LinearLearner(device=dev, objective="logistic",
                            learning_rate=0.1)
    history, orders, prints, fetches, trace = [], [], [], [], []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for epoch in range(epochs):
        orders.append([])
        prints.append([])
        fetches.append([])
        parser = parser_of(epoch) if parser_of is not None else Recorder(
            address, dispatcher=True, job="%s%d" % (layout, epoch),
            device=dev)
        feed = DeviceFeed(parser, BatchSpec(
            batch_size=batch_size, layout=layout, num_features=nf),
            device=dev, host_prefetch=host_prefetch)
        try:
            history = learner.fit_feed(feed, epochs=epoch + 1,
                                       start_epoch=epoch, history=history)
            stats = feed.stats()
        finally:
            feed.close()
        took = sorted(fetches[-1])
        trace.append({
            "stages_ns": {k: stats.get(k) for k in (
                "batches", "host_batch_ns", "dispatch_ns", "host_wait_ns",
                "consume_ns")},
            "fetch_s": {"count": len(took), "sum": sum(took),
                        "median": statistics.median(took) if took else None,
                        "max": took[-1] if took else None}})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    return history, params_to_numpy(learner.params), seconds, launches, \
        orders, [rows_digest(p) for p in prints], trace


def same_fit_bits(what, got, want) -> None:
    """Histories and params equal bit for bit."""
    require(list(got[0]) == list(want[0]), "%s: loss history %s, expected "
            "%s", what, got[0], want[0])
    for k in ("w", "b"):
        require(np.array_equal(got[1][k], want[1][k]),
                "%s: %s differs from the reference fit's bits", what, k)


def hold_ledger(what, snap, job_totals, requeued_min=0, requeued_max=0):
    """Every job's chunks acked, none left queued, leased or delivered,
    and the requeue count within [min, max]."""
    for name, total in job_totals.items():
        chunks = snap["jobs"][name]["chunks"]
        require(chunks == {"total": total, "queued": 0, "leased": 0,
                           "delivered": 0, "acked": total},
                "%s: job %s ledger %s", what, name, chunks)
    require(requeued_min <= snap["requeued"] <= requeued_max,
            "%s: %d requeued, expected %d..%d", what, snap["requeued"],
            requeued_min, requeued_max)
    require(snap["rejects"] == 0 or requeued_min > 0,
            "%s: %d duplicate deliveries rejected", what, snap["rejects"])


def drive_data_service(kernels, dev, ingest_file, ingest, fit_files, paths,
                       fit_params, tmp, host_prefetch=0,
                       served=True) -> dict:
    """Phase 23 (the module docstring): the dispatcher in this process,
    ``serve --dispatcher`` workers on the card, consumers here. The
    consumers' feeds run their producer thread at ``host_prefetch`` (0,
    the inline feed phase 23 measured first; None, the default, in phase
    24 (b)); ``served=False`` leaves out the served reads (a) and the
    tenants (d)."""
    from dmlc_tpu_torch.data import DataDispatcher
    from dmlc_tpu_torch.tools.serve import EXIT_WORKER_CRASHED

    n = DATA_CHUNKS
    ingest_bytes = os.path.getsize(ingest_file)
    shape = {"dense": (HIGGS_BATCH, HIGGS_FEATURES + 1, HIGGS_ROWS),
             "csr": (CRITEO_BATCH, CRITEO_DIM + 1, CRITEO_ROWS)}
    kernel_of = {"dense": "fused_linear_grads", "csr": "coo_segment_sum"}
    nocache = {"DMLC_TPU_DATA_CACHE_MB": 0}
    report = {"nchunks": n, "host_prefetch": host_prefetch}
    disps, workers = {}, []
    reads_of = {"ingest": ingest_file} if served else {}

    def fleet(name, jobs, **kw):
        disp = DataDispatcher(host="127.0.0.1", port=0, **kw)
        for job, path in jobs.items():
            disp.add_job(job, path, nchunks=n)
        disps[name] = disp
        return disp

    def worker(name, disp, **env):
        w = Worker(disp.address, tmp, name, dev, **env)
        workers.append(w)
        return w

    try:
        one = fleet("one", {**reads_of, "dense0": fit_files["dense"],
                            "dense1": fit_files["dense"],
                            "csr0": fit_files["csr"],
                            "csr1": fit_files["csr"]})
        two = fleet("two", {**reads_of, "csr0": fit_files["csr"],
                            "csr1": fit_files["csr"]})
        crash = fleet("crash", {"csr0": fit_files["csr"],
                                "csr1": fit_files["csr"]},
                      dead_after_s=DATA_CRASH_DEAD_S)
        if served:
            tenants = fleet("tenants", {"a": fit_files["csr"],
                                        "b": fit_files["csr"]})
        # every worker starts at once; the crashing one first in its fleet,
        # so the consumer (which dials the lowest worker id) reaches it
        w_one = worker("one", one, **nocache)
        w_two = [worker("two%d" % i, two, **nocache) for i in range(2)]
        w_crash = worker("crash_victim", crash, DMLC_TPU_FAULTS=DATA_CRASH,
                         **nocache)
        w_tenant = (worker("tenants", tenants,
                           DMLC_TPU_DATA_CACHE_MB=DATA_TENANT_CACHE_MB)
                    if served else None)
        w_crash.serving()
        w_survivor = worker("crash_survivor", crash, **nocache)
        for w in (w_one, *w_two, w_tenant, w_survivor):
            if w is not None:
                w.serving()

        # (a) phase 12's file through one worker, then two
        reads = {}
        for name, disp in ((("one_worker", one), ("two_workers", two))
                           if served else ()):
            digest, nbytes, seconds, seqs = served_read(disp.address,
                                                        "ingest", dev)
            require(digest == ingest["native"]["rows_digest"], "served "
                    "read (%s): rows differ from the local native read's "
                    "(phase 26)", name)
            require(sorted(seqs) == list(range(n)), "served read (%s): "
                    "seqs %s", name, seqs)
            reads[name] = {"seconds": seconds,
                           "mb_per_s": ingest_bytes / 1e6 / seconds,
                           "frame_bytes": nbytes, "seq_order": seqs}
        if served:
            report["reads"] = reads
            report["phase12_local_card_mb_per_s"] = ingest["card_mb_per_s"]
            report["local_native_card_mb_per_s"] = \
                ingest["native"]["card_mb_per_s"]

        # (b) the fits of phases 5-6 through the one-worker fleet
        fits = {}
        for layout in ("dense", "csr"):
            bs, nf, rows = shape[layout]
            steps = EPOCHS * (-(-rows // bs))
            got = fleet_fit(kernels, one.address, dev, layout, bs, nf,
                            EPOCHS, None, host_prefetch)
            want = (paths[layout]["loss_history"], fit_params[layout])
            same_fit_bits("%s fit fed by one worker" % layout, got, want)
            require(got[3][kernel_of[layout]] == steps, "%s fleet fit: %s "
                    "launched %d times for %d steps", layout,
                    kernel_of[layout], got[3][kernel_of[layout]], steps)
            for order in got[4]:
                require(order == list(range(n)), "one-worker %s fit: chunk "
                        "order %s", layout, order)
            fits[layout + "_one_worker"] = {
                "seconds": got[2], "rows_per_s": EPOCHS * rows / got[2],
                "local_rows_per_s": paths[layout]["rows_per_s"],
                "launches": got[3][kernel_of[layout]], "steps": steps,
                "consumer": got[6]}
        snap = one.snapshot()
        hold_ledger("one-worker fleet", snap, {
            j: n for j in (*reads_of, "dense0", "dense1", "csr0", "csr1")})
        report["one_worker_snapshot_chunks"] = snap["chunks"]

        # (b) the csr fit through two workers, against its replay
        bs, nf, rows = shape["csr"]
        steps = EPOCHS * (-(-rows // bs))

        def replayed(orders):
            return fleet_fit(
                kernels, None, dev, "csr", bs, nf, EPOCHS,
                lambda e: ChunkReplay(fit_files["csr"], orders[e], n, dev),
                host_prefetch)

        clean = rows_digest([row_fingerprints(b) for b in ChunkReplay(
            fit_files["csr"], range(n), n, dev)])
        got = fleet_fit(kernels, two.address, dev, "csr", bs, nf, EPOCHS,
                        None, host_prefetch)
        require(got[3]["coo_segment_sum"] == steps, "two-worker csr fit: "
                "%d launches for %d steps", got[3]["coo_segment_sum"], steps)
        require(got[5] == [clean] * EPOCHS, "two-worker csr fit: the "
                "epochs' rows differ from the local read")
        same_fit_bits("csr fit fed by two workers", got, replayed(got[4]))
        fits["csr_two_workers"] = {
            "seconds": got[2], "rows_per_s": EPOCHS * rows / got[2],
            "seq_orders": got[4]}
        hold_ledger("two-worker fleet", two.snapshot(),
                    {j: n for j in (*reads_of, "csr0", "csr1")})

        # (c) the same fit with one worker crashing at its third lease
        got = fleet_fit(kernels, crash.address, dev, "csr", bs, nf, EPOCHS,
                        None, host_prefetch)
        # before the replay: the survivor, done, is declared dead in turn
        # once DATA_CRASH_DEAD_S have passed
        snap = crash.snapshot()
        require(got[5] == [clean] * EPOCHS, "crashed fleet: the epochs' "
                "rows differ from the clean read")
        for order in got[4]:
            require(sorted(order) == list(range(n)), "crashed fleet: chunk "
                    "order %s", order)
        same_fit_bits("csr fit over a crashed worker", got,
                      replayed(got[4]))
        hold_ledger("crashed fleet", snap, {"csr0": n, "csr1": n},
                    requeued_min=1, requeued_max=n)
        require(sorted(w["live"] for w in snap["workers"].values())
                == [False, True], "crashed fleet: workers %s",
                snap["workers"])
        fits["csr_crashed"] = {
            "seconds": got[2], "rows_per_s": EPOCHS * rows / got[2],
            "clean_seconds": fits["csr_two_workers"]["seconds"],
            "requeued": snap["requeued"], "seq_orders": got[4]}
        report["fits"] = fits

        # (d) two tenants over one worker with the source cache on
        tenant = {}
        for job in ("a", "b") if served else ():
            digest, _, seconds, _ = served_read(tenants.address, job, dev)
            require(digest == clean, "tenant %s: rows differ from the "
                    "local read", job)
            tenant[job] = {"seconds": seconds}
        if served:
            hold_ledger("tenants", tenants.snapshot(), {"a": n, "b": n})

        # a worker ends once every job of its fleet is drained, or (the
        # second worker of fleet two, never dialed) once its dispatcher
        # is gone
        for disp in disps.values():
            disp.close()
        rep = {"one": w_one.finish(0),
               "two": [w.finish(0) for w in w_two],
               "crash_victim": w_crash.finish(EXIT_WORKER_CRASHED),
               "crash_survivor": w_survivor.finish(0)}
        if served:
            rep["tenants"] = w_tenant.finish(0)
    finally:
        for w in workers:
            w.kill()
        for disp in disps.values():
            disp.close()

    def tokens(r):
        return r["launches"]["tokenize_boundaries"]

    # each worker parses its leased parts through create_parser's native
    # route: no chunk part reaches the tokenizer
    for name in ("one", "crash_victim", "crash_survivor"):
        require(tokens(rep[name]) == 0, "%s fleet worker: %d tokenizer "
                "launches on the native route", name, tokens(rep[name]))
    got = sum(tokens(r) for r in rep["two"])
    require(got == 0, "two-worker fleet: %d tokenizer launches on the "
            "native route", got)
    report["worker_tokenize_launches"] = {
        "one": tokens(rep["one"]), "two": [tokens(r) for r in rep["two"]],
        "crash_victim": tokens(rep["crash_victim"]),
        "crash_survivor": tokens(rep["crash_survivor"])}
    if not served:
        return report
    require(tokens(rep["tenants"]) == 0
            and rep["tenants"]["chunks_parsed"] == n,
            "tenants: %d tokenizer launches and %d chunks parsed for one "
            "job's %d chunks (native route)", tokens(rep["tenants"]),
            rep["tenants"]["chunks_parsed"], n)
    tenant["worker_tokenize_launches"] = tokens(rep["tenants"])
    tenant["chunks_parsed"] = rep["tenants"]["chunks_parsed"]
    report["tenants"] = tenant
    report["worker_tokenize_launches"]["tenants"] = tokens(rep["tenants"])
    return report


def data_service_summary(card, report) -> dict:
    """The ``data_service`` line: phase 23's MB/s, rows/s, seconds and
    requeues."""
    reads, fits = report["reads"], report["fits"]
    return {
        "card": card, "nchunks": report["nchunks"],
        "served_mb_per_s": {k: v["mb_per_s"] for k, v in reads.items()},
        "phase12_local_card_mb_per_s": report["phase12_local_card_mb_per_s"],
        "local_native_card_mb_per_s": report["local_native_card_mb_per_s"],
        "fit_rows_per_s": {k: v["rows_per_s"] for k, v in fits.items()},
        "local_fit_rows_per_s": {
            "dense": fits["dense_one_worker"]["local_rows_per_s"],
            "csr": fits["csr_one_worker"]["local_rows_per_s"]},
        "crashed_fit_seconds": fits["csr_crashed"]["seconds"],
        "clean_two_worker_fit_seconds": fits["csr_crashed"]["clean_seconds"],
        "crash_requeued": fits["csr_crashed"]["requeued"],
        "crash_seq_orders": fits["csr_crashed"]["seq_orders"],
        "tenant_worker_tokenize_launches":
            report["tenants"]["worker_tokenize_launches"],
        "tenant_chunks_parsed": report["tenants"]["chunks_parsed"],
        "worker_tokenize_launches": report["worker_tokenize_launches"],
        "phase_seconds": report["seconds"]}


# phase 24 (a): (layout, host_prefetch, spec.prefetch) of each local fit,
# depth 0 and the default in turns (0, 2, 2, 0) so that drift between
# fits shows; None is the default (DMLC_TPU_HOST_PREFETCH /
# DMLC_TPU_PREFETCH unset: depth 2 on a host with more than one core,
# window 1)
FEED_MODES = (("dense", 0, None), ("dense", None, None),
              ("dense", None, None), ("dense", 0, None),
              ("csr", 0, None), ("csr", None, None), ("csr", None, None),
              ("csr", 0, None), ("csr", None, 2))
# phase 24 (c): the slice of phase 12's file the parse CLIs read, the rows
# of phase 5's file boosted_trees.py fits, long_context.py's T
FEED_SLICE_BYTES = 16 << 20
GBDT_EXAMPLE_ROWS = 65_536
LONG_CONTEXT_T = 2048


def feed_fit(path, layout, batch_size, nf, host_prefetch, prefetch):
    """Phases 5-6's fit over a DeviceFeed built here at ``host_prefetch``
    and ``spec.prefetch`` (``fit_uri``'s feed with the two options):
    (history, params as numpy, seconds, the last epoch's feed stats)."""
    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

    learner = LinearLearner(objective="logistic", learning_rate=0.1)
    feed = DeviceFeed(
        create_parser(path, 0, 1, device=learner.device),
        BatchSpec(batch_size=batch_size, layout=layout, num_features=nf,
                  prefetch=prefetch),
        device=learner.device, host_prefetch=host_prefetch)
    try:
        t0 = time.perf_counter()
        history = learner.fit_feed(feed, epochs=EPOCHS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats = feed.stats()
        depth, window = feed.host_prefetch, feed._prefetch
    finally:
        feed.close()
    return history, params_to_numpy(learner.params), seconds, stats, \
        depth, window


def first_lines(src: str, dst: str, nbytes: int = 0, rows: int = 0) -> int:
    """The first ``rows`` lines of ``src`` (or its lines within the first
    ``nbytes``) into ``dst``; returns the bytes written."""
    with open(src, "rb") as fh:
        if rows:
            data = b"".join(fh.readline() for _ in range(rows))
        else:
            data = fh.read(nbytes)
            data = data[:data.rfind(b"\n") + 1]
    with open(dst, "wb") as fh:
        fh.write(data)
    return len(data)


def run_entry(kernels, main, argv) -> dict:
    """One CLI or example's ``main(argv)`` in this process, its stdout
    kept: exit code, seconds, kernel launches, the last stdout lines."""
    import io

    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"rc": rc, "seconds": seconds,
            "launches": {k: fn.launches for k, fn in kernels.KERNELS.items()
                         if fn.launches},
            "tail": out.getvalue().splitlines()[-3:]}


def drive_feed(kernels, dev, ingest_file, fit_files, paths, fit_params,
               data_service, tmp) -> dict:
    """Phase 24 (the module docstring): the feed's producer thread and
    transfer window on the local and fleet-fed fits, then the tier-2 CLIs
    and the examples on the card."""
    from dmlc_tpu_torch.device.feed import stall_breakdown
    from dmlc_tpu_torch.examples import (boosted_trees, criteo_sparse,
                                         long_context)
    from dmlc_tpu_torch.tools import dataiter, parse, strtonum

    shape = {"dense": (HIGGS_BATCH, HIGGS_FEATURES + 1, HIGGS_ROWS),
             "csr": (CRITEO_BATCH, CRITEO_DIM + 1, CRITEO_ROWS)}
    kernel_of = {"dense": "fused_linear_grads", "csr": "coo_segment_sum"}
    report = {}

    # (a) the local fits at each depth and window
    local = {}
    for layout, depth, window in FEED_MODES:
        bs, nf, rows = shape[layout]
        steps = EPOCHS * (-(-rows // bs))
        kernels.reset_launch_counts()
        history, params, seconds, stats, depth_used, window_used = feed_fit(
            fit_files[layout], layout, bs, nf, depth, window)
        launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
        name = "%s_depth%d_window%d" % (layout, depth_used, window_used)
        same_fit_bits("%s fit" % name, (history, params),
                      (paths[layout]["loss_history"], fit_params[layout]))
        require(launches[kernel_of[layout]] == steps, "%s: %s launched %d "
                "times for %d steps", name, kernel_of[layout],
                launches[kernel_of[layout]], steps)
        require(launches["tokenize_boundaries"]
                == paths[layout]["tokenize_launches"], "%s: %d tokenizer "
                "launches, phase %s had %d", name,
                launches["tokenize_boundaries"],
                "5" if layout == "dense" else "6",
                paths[layout]["tokenize_launches"])
        # one list entry a turn of this mode
        turns = local.setdefault(name, {
            "seconds": [], "rows_per_s": [], "stall_breakdown": [],
            "last_epoch_ns": [], "pool": [],
            "launches": launches[kernel_of[layout]],
            "tokenize_launches": launches["tokenize_boundaries"]})
        turns["seconds"].append(seconds)
        turns["rows_per_s"].append(EPOCHS * rows / seconds)
        turns["stall_breakdown"].append(stall_breakdown(stats))
        turns["last_epoch_ns"].append({k: stats[k] for k in (
            "host_batch_ns", "dispatch_ns", "host_wait_ns", "consume_ns")})
        turns["pool"].append(stats["pool"])
    report["local"] = local
    report["phase56_rows_per_s"] = {k: v["rows_per_s"]
                                    for k, v in paths.items()}

    # (b) phase 23's fleet-fed fits with the consumers' feeds at the
    # default depth
    t0 = time.perf_counter()
    fleet = drive_data_service(kernels, dev, ingest_file, None, fit_files,
                               paths, fit_params, tmp, host_prefetch=None,
                               served=False)
    fits = fleet["fits"]
    report["fleet"] = {
        "rows_per_s": {k: v["rows_per_s"] for k, v in fits.items()},
        "phase23_rows_per_s": {
            k: v["rows_per_s"] for k, v in data_service["fits"].items()},
        "crash_requeued": fits["csr_crashed"]["requeued"],
        "crashed_fit_seconds": fits["csr_crashed"]["seconds"],
        "csr_one_worker_consumer": fits["csr_one_worker"]["consumer"],
        "clean_two_worker_fit_seconds": fits["csr_two_workers"]["seconds"],
        "two_worker_seq_orders": fits["csr_two_workers"]["seq_orders"],
        "worker_tokenize_launches": fleet["worker_tokenize_launches"],
        "seconds": time.perf_counter() - t0}

    # (c) the CLIs and examples that touch the card, at a small size
    slice_file = os.path.join(tmp, "ingest_slice.svm")
    slice_bytes = first_lines(ingest_file, slice_file,
                              nbytes=FEED_SLICE_BYTES)
    gbdt_file = os.path.join(tmp, "higgs_head.svm")
    first_lines(fit_files["dense"], gbdt_file, rows=GBDT_EXAMPLE_ROWS)
    # the kernel each launches at least once; None: the entry reads on the
    # native route (parse, dataiter, strtonum's default, boosted_trees'
    # fit_uri) and must launch the tokenizer 0 times
    runs = {
        "parse": (parse.main, [slice_file], None),
        "dataiter": (dataiter.main, [slice_file, "--epochs", 2], None),
        "strtonum": (strtonum.main, [], None),
        "strtonum_python": (strtonum.main, ["--route", "python"],
                            "tokenize_boundaries"),
        "criteo_sparse": (criteo_sparse.main, [
            fit_files["csr"], "--num-features", CRITEO_DIM + 1,
            "--epochs", 1], "coo_segment_sum"),
        "long_context": (long_context.main, ["--seq", LONG_CONTEXT_T],
                         "flash_attention_fwd"),
        "boosted_trees": (boosted_trees.main, [
            gbdt_file, "--num-features", HIGGS_FEATURES + 1], None),
    }
    entries = {}
    for name, (main, argv, kernel) in runs.items():
        got = run_entry(kernels, main, argv)
        require(got["rc"] == 0, "%s exited %s: %s", name, got["rc"],
                got["tail"])
        if kernel is None:
            require(got["launches"].get("tokenize_boundaries", 0) == 0,
                    "%s launched the tokenizer %d times on the native "
                    "route", name,
                    got["launches"].get("tokenize_boundaries", 0))
        else:
            require(got["launches"].get(kernel, 0) >= 1, "%s launched %s "
                    "%d times", name, kernel, got["launches"].get(kernel, 0))
        entries[name] = got
    report["entries"] = entries
    report["slice_bytes"] = slice_bytes
    return report


def feed_summary(card, report) -> dict:
    """Phase 24's line: rows/s of each local fit beside phases 5-6, the
    fleet-fed fits beside phase 23's (depth 0), each entry point's exit
    code and launches."""
    return {
        "card": card,
        "local_rows_per_s": {k: v["rows_per_s"]
                             for k, v in report["local"].items()},
        "phase56_rows_per_s": report["phase56_rows_per_s"],
        "pool": {k: v["pool"] for k, v in report["local"].items()},
        "stall_breakdown": {k: v["stall_breakdown"]
                            for k, v in report["local"].items()},
        "fleet_rows_per_s": report["fleet"]["rows_per_s"],
        "phase23_fleet_rows_per_s": report["fleet"]["phase23_rows_per_s"],
        "fleet_crash_requeued": report["fleet"]["crash_requeued"],
        "fleet_worker_tokenize_launches":
            report["fleet"]["worker_tokenize_launches"],
        "entries": {k: {"rc": v["rc"], "seconds": v["seconds"],
                        "launches": v["launches"]}
                    for k, v in report["entries"].items()},
        "phase_seconds": report["seconds"]}


# ---------------------------------------------------------------------------
# phase 25: the status plane and the launchers on the card
# ---------------------------------------------------------------------------

#: the status plane's nine endpoints and their content types
PLANE_ENDPOINTS = {
    "/healthz": "application/json", "/workers": "application/json",
    "/metrics": "text/plain; version=0.0.4", "/trace": "application/json",
    "/data": "application/json", "/goodput": "application/json",
    "/audit": "application/json", "/xla": "application/json",
    "/profile": "application/json"}
# (a): the /profile window a rank captures from its first epoch boundary:
# an epoch's length (~1.5 s), so that it covers steps and not only the
# next epoch's first parse (a 1 s window has caught no step at all)
PLANE_PROFILE_S = 3
PLANE_POLL_S = 0.2
#: (e): turns of the launched csr fit in one rank, 0 not publishing (as
#: without --status-port), 1 publishing to the armed tracker
PLANE_COST_TURNS = (0, 1, 1, 0)
#: the fake ssh of (d): skip the options, the port and the host, run the
#: remote command string on this host
FAKE_SSH = """#!/bin/bash
while [ $# -gt 1 ]; do
  case "$1" in
    -o|-p) shift 2 ;;
    *) shift ; break ;;
  esac
done
exec bash -c "$1"
"""


def native_summary(card, report) -> dict:
    """The ``native`` line: phase 26's native route beside the Python
    stack (MB/s, the fits' rows/s and feed-only seconds), the build's
    seconds and the SIMD tier."""
    ing, fits, fm = report["ingest"], report["fits"], report["fm"]
    return {
        "card": card, "build_seconds": report["build_seconds"],
        "gxx_seconds": report["gxx_seconds"],
        "simd_level": report["simd_level"],
        "ingest_mb_per_s": {
            "native_card": ing["card_mb_per_s"],
            "native_cpu": ing["cpu_mb_per_s"],
            "python_stack_card": ing["python_stack_card_mb_per_s"],
            "python_stack_pipelined":
                ing["python_stack_pipelined_mb_per_s"]},
        "ingest_stats": ing["stats"],
        "values_bit_equal_share": ing["values_bit_equal_share"],
        "fit_rows_per_s": {
            layout: {"native": f["native_rows_per_s"],
                     "python_stack": f["python_rows_per_s"]}
            for layout, f in fits.items()},
        "fit_feed_only_seconds": {
            layout: {"native": f["native_feed_only_seconds"],
                     "python_stack": f["python_feed_only_seconds"]}
            for layout, f in fits.items()},
        "fm_rows_per_s": {"native": fm["native_rows_per_s"],
                          "python_stack": fm["python_rows_per_s"]},
        "binary_mb_per_s": {k: v["mb_per_s"] for k, v in
                            report["binary"].items() if isinstance(v, dict)},
        "seconds": report["seconds"]}


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now."""
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def wait_for(path: str, what: str, seconds: float = RANK_TIMEOUT_S) -> None:
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise SmokeFailure("%s: %s never appeared" % (what, path))
        time.sleep(PLANE_POLL_S)


def plane_rank(spec_path: str) -> int:
    """One rank of phase 25 (a), (d) and (e), run as ``chip_smoke.py
    --plane-rank SPEC`` by the port's launcher: phase 6's csr fit for
    ``spec["epochs"]`` epochs on the card it sees, after the tracker's
    rendezvous (the socket engine keeps the job's books), over a one-rank
    NCCL group started from the gpu launcher's coordinator when
    ``spec["nccl"]``. ``spec["turns"]`` (0 / 1 a fit) runs the fit once a
    turn after one unarmed warm-up fit, publishing to the tracker's plane
    only in the 1 turns (what a rank of a job without ``--status-port``
    does in the 0 turns: it never publishes), and reports the rows/s of
    each; every fit must give the first's bits. With ``spec["profile"]`` it waits for the
    ``/profile`` window its heartbeat ack started to be written beside its
    flight-recorder dump and reads the CUDA kernels in it; with
    ``spec["hold"]`` it waits for that file before it leaves the job, so
    the smoke reads the live plane first. Writes ``report-rank0.json``
    and ``params-rank0.npz`` to ``spec["out"]``."""
    import hashlib

    import torch.distributed as dist
    from dmlc_tpu_torch import collective
    from dmlc_tpu_torch.ops import kernels
    from dmlc_tpu_torch.parallel import distributed

    with open(spec_path) as fh:
        spec = json.load(fh)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    kernels._lib()  # built by the parent: loaded, never built again
    collective.init()
    rank = collective.rank()
    group = None
    if spec["nccl"]:
        info = distributed.env_process_info()
        distributed.initialize(info["coordinator"], 1, 0, backend="nccl",
                               device=dev)
        # NCCL builds its communicator at the first collective: outside
        # the fit's seconds, as phase 13 times it
        dist.all_reduce(torch.zeros(1, device=dev))
        torch.cuda.synchronize()
        group = dist.group.WORLD
    from dmlc_tpu_torch.obs import plane

    turn_rows_per_s = []
    turns = spec.get("turns")
    # turns start after one unarmed fit, so that no turn pays the
    # process's first fit (the cost records of its first calls)
    for armed in [0] + list(turns) if turns else [None]:
        if armed is not None:
            # a turn publishes exactly when it is armed
            if armed:
                os.environ["DMLC_TPU_OBS_PUBLISH"] = "1"
            else:
                os.environ.pop("DMLC_TPU_OBS_PUBLISH", None)
            plane.reset_default_publisher()
        kernels.reset_launch_counts()
        with count_parts() as parts:
            history, params, seconds = run_fit(
                spec["file"], "csr", CRITEO_BATCH, CRITEO_DIM + 1, dev,
                group=group, epochs=spec["epochs"])
        turn_rows_per_s.append(spec["epochs"] * CRITEO_ROWS / seconds)
        if len(turn_rows_per_s) == 1:
            first = (history, params)
        same_fit_bits("turn %d" % len(turn_rows_per_s), (history, params),
                      first)
    if turns:
        turn_rows_per_s = turn_rows_per_s[1:]
    launches = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    report = {
        "rank": rank, "history": history, "seconds": seconds,
        "rows_per_s": spec["epochs"] * CRITEO_ROWS / seconds,
        "turn_rows_per_s": turn_rows_per_s,
        "launches": launches, "chunk_parts": len(parts),
        "backend": dist.get_backend() if group is not None else None,
        "digest": hashlib.sha256(params["w"].tobytes()
                                 + params["b"].tobytes()).hexdigest(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "cluster": os.environ.get("DMLC_JOB_CLUSTER")}
    if spec.get("profile"):
        path = os.path.join(os.environ["DMLC_TPU_FLIGHTREC"],
                            "profile-rank%d-req1" % rank, "trace.json")
        wait_for(path, "the /profile window's trace")
        time.sleep(0.5)  # the export writes the file in one go; let it end
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        names = sorted({e.get("name", "") for e in events
                        if e.get("cat") == "kernel"})
        report["profile"] = {"trace": path, "kernels": names,
                             "seg_sum_kernels": sum(
                                 1 for e in events if e.get("cat") == "kernel"
                                 and "seg_sum_kernel" in e.get("name", ""))}
    np.savez(os.path.join(spec["out"], "params-rank%d.npz" % rank), **params)
    with open(os.path.join(spec["out"], "report-rank%d.json" % rank),
              "x") as fh:
        json.dump(report, fh)
    if spec.get("hold"):
        wait_for(spec["hold"], "the smoke's release")
    if group is not None:
        distributed.shutdown()
    collective.finalize()
    return 0


class LaunchedJob:
    """``python -m dmlc_tpu_torch.tracker.submit --host-ip 127.0.0.1
    <launcher_args> python chip_smoke.py <entry> SPEC`` in a session of
    its own, its log beside the spec. ``status`` arms the tracker's
    status plane on a free port (``self.status``)."""

    def __init__(self, tmp, name, launcher_args, entry, spec, status=False,
                 env=None, hold=False):
        self.name = name
        self.out = os.path.join(tmp, name)
        os.makedirs(self.out)
        self.hold = os.path.join(self.out, "release") if hold else None
        spec = dict(spec, out=self.out, hold=self.hold)
        self.spec_path = os.path.join(self.out, "spec.json")
        with open(self.spec_path, "w") as fh:
            json.dump(spec, fh)
        self.status = free_port() if status else None
        full = dict(os.environ)
        for key in ("DMLC_TPU_FAULTS", "DMLC_TPU_STATUS_PORT",
                    "DMLC_TRACKER_URI", "DMLC_TPU_COORDINATOR",
                    "DMLC_TPU_ELASTIC", "DMLC_TPU_SPARE", "DMLC_TPU_TRACE",
                    "DMLC_TPU_AUDIT", "DMLC_TPU_FLIGHTREC",
                    "CUDA_VISIBLE_DEVICES"):
            full.pop(key, None)
        full.update({k: str(v) for k, v in (env or {}).items()})
        root = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit",
               "--host-ip", "127.0.0.1", *map(str, launcher_args)]
        if status:
            cmd += ["--status-port", str(self.status)]
        cmd += [sys.executable, os.path.abspath(__file__), entry,
                self.spec_path]
        self.log_path = os.path.join(self.out, "job.log")
        self._log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=root, env=full,
                                     stdout=self._log,
                                     stderr=subprocess.STDOUT,
                                     start_new_session=True)

    def kill(self) -> None:
        """End the job's session, its ranks included."""
        _kill_group(self.proc)
        self._log.close()

    def log(self) -> str:
        with open(self.log_path) as fh:
            return fh.read()

    def get(self, path: str):
        """(status, content type, body) of ``path`` on the status server;
        an HTTP error's code in place of the status."""
        import urllib.error
        import urllib.request

        url = "http://127.0.0.1:%d%s" % (self.status, path)
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                return resp.status, resp.headers["Content-Type"], resp.read()
        except urllib.error.HTTPError as err:
            return err.code, None, b""

    def get_json(self, path: str):
        code, _, body = self.get(path)
        require(code == 200, "%s: %s answered %s", self.name, path, code)
        return json.loads(body)

    def wait_up(self) -> None:
        """Until the status server answers /healthz."""
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while True:
            require(self.proc.poll() is None, "%s: the launcher exited %s "
                    "before its status server answered:\n%s", self.name,
                    self.proc.returncode, self.log()[-6000:])
            try:
                if self.get("/healthz")[0] == 200:
                    return
            except OSError:
                pass
            require(time.monotonic() < deadline, "%s: no status server",
                    self.name)
            time.sleep(PLANE_POLL_S)

    def reports(self, world: int, poll=None) -> dict:
        """Wait until ``world`` ranks wrote their reports (calling
        ``poll()`` between looks), then return them by rank."""
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while len(_reports(self.out)) < world:
            require(self.proc.poll() is None or len(_reports(self.out))
                    >= world, "%s: the launcher exited %s:\n%s", self.name,
                    self.proc.returncode, self.log()[-6000:])
            require(time.monotonic() < deadline, "%s: no reports in %d s",
                    self.name, RANK_TIMEOUT_S)
            if poll is not None:
                poll()
            time.sleep(PLANE_POLL_S)
        return _reports(self.out)

    def release(self) -> None:
        if self.hold is not None:
            with open(self.hold, "w") as fh:
                fh.write("go\n")

    def finish(self) -> tuple:
        """Release the ranks, wait for the launcher (``RANK_TIMEOUT_S``),
        kill what is left of its session: (reports by rank, log, wall
        seconds)."""
        self.release()
        try:
            self.proc.wait(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pass
        finally:
            code = self.proc.poll()
            self.kill()
        seconds = time.perf_counter() - self.t0
        text = self.log()
        require(code == 0, "%s: the launcher %s:\n%s", self.name,
                "did not finish" if code is None else "exited %s" % code,
                text[-6000:])
        return _reports(self.out), text, seconds


def hold_plane_views(what, job, ranks, epochs=None) -> dict:
    """The live plane of ``job``: /workers lists ``ranks`` (each at
    ``epochs[r]`` published epochs when given), the merged /trace holds
    spans of every rank in one monotonic timeline, the merged /metrics
    carries a ``rank=`` label for each. The ranks' reports are written by
    then: only the last heartbeats may still be in flight."""
    deadline = time.monotonic() + 30
    while True:
        workers = job.get_json("/workers")
        got = workers["workers"]
        done = sorted(got) == [str(r) for r in ranks] and (
            epochs is None or all(got[str(r)]["epoch"] == epochs[r]
                                  for r in ranks))
        if done or time.monotonic() > deadline:
            break
        time.sleep(PLANE_POLL_S)
    require(sorted(got) == [str(r) for r in ranks], "%s: /workers lists "
            "ranks %s, want %s", what, sorted(got), ranks)
    if epochs is not None:
        require(all(got[str(r)]["epoch"] == epochs[r] for r in ranks),
                "%s: /workers epochs %s, want %s", what,
                {r: v["epoch"] for r, v in got.items()}, epochs)
    trace = job.get_json("/trace")
    events = trace["traceEvents"]
    ts = [e["ts"] for e in events]
    span_ranks = sorted({e["pid"] for e in events if e.get("ph") == "X"})
    require(span_ranks == list(ranks) and ts == sorted(ts) and ts[0] == 0,
            "%s: /trace spans of ranks %s, monotonic %s", what, span_ranks,
            ts == sorted(ts))
    code, _, body = job.get("/metrics")
    text = body.decode()
    for r in ranks:
        require('rank="%d"' % r in text, "%s: /metrics has no rank=%d "
                "label", what, r)
    return {"workers": {r: {k: v[k] for k in ("epoch", "payloads", "spans",
                                               "spans_dropped", "info")}
                        for r, v in got.items()},
            "world_version": workers["world_version"],
            "events": [e["kind"] for e in workers["events"]],
            "trace_spans": len(events),
            "trace_offsets_ns": trace["metadata"]["offsets_ns"]}


def run_tool(argv) -> tuple:
    """``dmlc_tpu_torch.tools.main(argv)`` in this process, as ``python -m
    dmlc_tpu_torch.tools <argv>`` runs it: (exit code, stdout, stderr)."""
    import io

    from dmlc_tpu_torch import tools

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tools.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def drive_status_plane(kernels, dev, fit_files, paths, fit_params,
                       recovery, python_csr, tmp) -> dict:
    """Phase 25 (the module docstring): the status plane and the
    launchers on the card. A failed check kills the jobs it left
    running."""
    jobs = []

    def launch(*args, **kw) -> LaunchedJob:
        jobs.append(LaunchedJob(*args, **kw))
        return jobs[-1]

    try:
        return _drive_status_plane(kernels, dev, fit_files, paths,
                                   fit_params, recovery, python_csr, tmp,
                                   launch)
    finally:
        for job in jobs:
            job.kill()


def _drive_status_plane(kernels, dev, fit_files, paths, fit_params,
                        recovery, python_csr, tmp, launch) -> dict:
    csr = fit_files["csr"]
    csr_steps = EPOCHS * (-(-CRITEO_ROWS // CRITEO_BATCH))
    report = {}

    def gpu_args(hosts, *extra):
        return ["--cluster", "gpu", "-n", len(hosts.split(",")),
                "--gpu-hosts", hosts, "--gpu-coordinator-port", free_port(),
                *extra]

    def hold_rank_fit(what, rep, epochs, history, params,
                      native=True) -> None:
        """The launched rank's fit: ``history`` and ``params`` bit for bit
        (a fit on the rank's route), its kernel once a step, and the
        tokenizer as its route launches it (``native``; an armed audit
        keeps the Python stack)."""
        steps = epochs * (-(-CRITEO_ROWS // CRITEO_BATCH))
        require(rep["history"] == list(history), "%s: loss history %s, "
                "want %s", what, rep["history"], list(history))
        got = dict(np.load(os.path.join(rep["out"], "params-rank0.npz")))
        for k in ("w", "b"):
            require(np.array_equal(got[k], params[k]), "%s: %s differs "
                    "from phase 6's bits", what, k)
        require(rep["launches"]["coo_segment_sum"] == steps, "%s: %d "
                "coo_segment_sum launches for %d steps", what,
                rep["launches"]["coo_segment_sum"], steps)
        hold_tokens(what, rep["launches"]["tokenize_boundaries"],
                    rep["chunk_parts"], native)

    # (a) world 1 over NCCL through --cluster gpu, the plane armed
    t0 = time.perf_counter()
    rec_dir = os.path.join(tmp, "a_rec")
    job = launch(
        tmp, "a_world1", gpu_args("localhost"), "--plane-rank",
        {"file": csr, "epochs": EPOCHS, "nccl": True, "profile": True},
        status=True, hold=True,
        env={"DMLC_TPU_TRACE": os.path.join(tmp, "a_rank.trace.json"),
             "DMLC_TPU_AUDIT": "full", "DMLC_TPU_FLIGHTREC": rec_dir})
    job.wait_up()
    asked = job.get_json("/profile?seconds=%d" % PLANE_PROFILE_S)
    require(asked == {"profile_req": 1, "seconds": PLANE_PROFILE_S},
            "(a): /profile answered %s", asked)
    seen = {}

    def poll_all():
        for path, ctype in PLANE_ENDPOINTS.items():
            if path == "/profile":
                continue  # one request: a second would capture again
            code, got_ctype, body = job.get(path)
            require(code == 200 and got_ctype == ctype, "(a): %s answered "
                    "%s %s", path, code, got_ctype)
            seen[path] = seen.get(path, 0) + 1

    reports = job.reports(1, poll=poll_all)
    poll_all()
    code = job.get("/nope")[0]
    require(code == 404, "(a): an unknown path answered %s", code)
    views = hold_plane_views("(a)", job, [0], {0: EPOCHS})
    audit = job.get_json("/audit")
    require(audit["enabled"] and audit["divergences"] == [],
            "(a): /audit %s", {k: audit[k] for k in ("enabled",
                                                    "divergences")})
    goodput = job.get_json("/goodput")
    require("0" in goodput["ranks"], "(a): /goodput has no window of rank "
            "0: %s", goodput)
    status = "127.0.0.1:%d" % job.status
    top_rc, top_out, top_err = run_tool(["obs-top", "--once", "--status",
                                         status])
    require(top_rc == 0 and any(line.split()[:1] == ["0"]
                                for line in top_out.splitlines()[1:]),
            "(a): obs-top exited %s:\n%s%s", top_rc, top_out, top_err)
    rep_rc, rep_out, rep_err = run_tool(["obs-report", "--status", status,
                                         "--top", "--attribution", "--xla",
                                         "--audit"])
    require(rep_rc == 0 and "== workers ==" in rep_out, "(a): obs-report "
            "--status exited %s:\n%s", rep_rc, rep_err)
    merged = os.path.join(tmp, "a_merged.trace.json")
    with open(merged, "wb") as fh:
        fh.write(job.get("/trace")[2])
    reports, _, seconds = job.finish()
    rep = dict(reports[0], out=job.out)
    # the armed audit keeps the rank's create_parser on the Python stack:
    # phase 26's Python-stack csr fit on the card is its yardstick
    hold_rank_fit("(a) world 1 over NCCL", rep, EPOCHS, *python_csr,
                  native=False)
    require(rep["backend"] == "nccl" and rep["cuda_visible_devices"] == "0",
            "(a): backend %s, CUDA_VISIBLE_DEVICES %s", rep["backend"],
            rep["cuda_visible_devices"])
    require(rep["profile"]["seg_sum_kernels"] > 0, "(a): the /profile "
            "window holds no coo_segment_sum kernel: %s",
            rep["profile"]["kernels"])
    after = {}
    for argv in (["--trace", merged],
                 ["--trace", os.path.join(tmp, "a_rank.trace.json")],
                 ["--diff", os.path.join(tmp, "a_rank.trace.json"), merged]):
        rc, out, err = run_tool(["obs-report", *argv])
        require(rc == 0 and "==" in out, "(a): obs-report %s exited %s:\n%s",
                argv, rc, err)
        after[argv[0] + " " + os.path.basename(argv[-1])] = rc
    report["a"] = {
        "seconds": seconds, "rows_per_s": rep["rows_per_s"],
        "fit_seconds": rep["seconds"], "endpoint_polls": seen,
        "plane": views, "profile_kernels": rep["profile"]["kernels"],
        "profile_seg_sum_kernels": rep["profile"]["seg_sum_kernels"],
        "launches": {k: rep["launches"][k] for k in ("coo_segment_sum",
                                                     "tokenize_boundaries")},
        "chunk_parts": rep["chunk_parts"], "obs_top_rc": top_rc,
        "obs_report_status_rc": rep_rc, "obs_report_after": after,
        "phase_seconds": time.perf_counter() - t0}
    print(json.dumps({"plane_world1": report["a"]}), flush=True)

    # (b) world 2 on the one card over gloo: phase 18's device-engine
    # ranks through --cluster gpu, clean and with two crashes
    t0 = time.perf_counter()
    digest = recovery["clean"]["digest"]
    crashes = [{"rank": 0, "epoch": RECOVER_CRASH_EPOCH},
               {"rank": 1, "epoch": RECOVER_CRASH_EPOCH + 1}]
    world2 = {}
    for name, crash in (("clean", []), ("crash", crashes)):
        job = launch(
            tmp, "b_" + name, gpu_args("localhost,localhost",
                                       "--max-attempts", 3),
            "--recover-rank",
            {"file": csr, "ckpt": os.path.join(tmp, "b_%s.ckpt" % name),
             "engine": "device", "sync": "spmd", "backend": "gloo",
             "devices": ["cuda:0", "cuda:0"], "crashes": crash},
            status=True, hold=True, env={"DMLC_TPU_RECOVER_TIMEOUT": 60})
        job.wait_up()
        job.reports(2)
        # a crashed rank's relaunched process publishes its epochs from 1
        epochs = {r: RECOVER_EPOCHS for r in (0, 1)}
        for c in crash:
            epochs[c["rank"]] = RECOVER_EPOCHS - c["epoch"]
        views = hold_plane_views("(b) " + name, job, [0, 1], epochs)
        reports, text, seconds = job.finish()
        held = hold_recover_job("(b) " + name, reports, 2, digest)
        exits = re.findall(r"gpu task exited (-?\d+); restarting", text)
        require(sorted(exits).count("17") == len(crash) and all(
            reports[c["rank"]]["attempt"] >= 1 for c in crash),
            "(b) %s: relaunches after exits %s, attempts %s", name, exits,
            {r: rep["attempt"] for r, rep in reports.items()})
        world2[name] = dict(held, seconds=seconds, plane=views,
                            relaunched_after_exits=exits)
        spec = {"out": job.out}
        for c in crash:
            # a survivor re-initializes in process, or exits 41 and is
            # relaunched (fail-stop); the relaunch's start, split
            fault = fault_marker(spec, "crashed-rank%d.json" % c["rank"])
            world2[name]["rank%d_crash" % c["rank"]] = {
                "survivor_route": "fail-stop exit 41, relaunched"
                if exits.count("41") else "re-initialized in process",
                "crash_to_replay_s": replay_seconds(fault, reports),
                "relaunch_s": relaunch_seconds(fault, reports[c["rank"]])}
    world2["vs_clean"] = world2["crash"]["seconds"] / world2["clean"][
        "seconds"]
    world2["phase18_clean_digest"] = digest
    world2["phase_seconds"] = time.perf_counter() - t0
    report["b"] = world2
    print(json.dumps({"plane_world2": world2}), flush=True)

    # (c) dispatch --status-port: one serve worker feeds phase 6's csr fit
    t0 = time.perf_counter()
    n = DATA_CHUNKS
    root = os.path.dirname(os.path.abspath(__file__))
    disp = subprocess.Popen(
        [sys.executable, "-m", "dmlc_tpu_torch.tools", "dispatch", "-",
         "--nchunks", str(n), "--host", "127.0.0.1", "--status-port", "0",
         "--job", "csr0=" + csr, "--job", "csr1=" + csr, "--job",
         "tail=" + csr],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    worker = None
    try:
        status_line = disp.stdout.readline().split()
        addr_line = disp.stdout.readline().split()
        require(status_line[:1] == ["status"] and addr_line[:1]
                == ["dispatching"], "(c): dispatch printed %s / %s",
                status_line, addr_line)
        address = (addr_line[1], int(addr_line[2]))
        worker = Worker(address, tmp, "c_worker", dev,
                        DMLC_TPU_DATA_CACHE_MB=0)
        worker.serving()
        got = fleet_fit(kernels, address, dev, "csr", CRITEO_BATCH,
                        CRITEO_DIM + 1, EPOCHS, None)
        same_fit_bits("(c) csr fit fed through dispatch --status-port", got,
                      (paths["csr"]["loss_history"], fit_params["csr"]))
        require(got[3]["coo_segment_sum"] == csr_steps, "(c): %d launches "
                "for %d steps", got[3]["coo_segment_sum"], csr_steps)
        import urllib.request

        url = "http://127.0.0.1:%s/data" % status_line[2]
        with urllib.request.urlopen(url, timeout=10) as resp:
            ctype = resp.headers["Content-Type"]
            data = json.loads(resp.read())
        require(ctype == "application/json" and data["attached"],
                "(c): /data %s %s", ctype, data.get("attached"))
        for job_name in ("csr0", "csr1"):
            ledger = data["jobs"][job_name]
            require(ledger["chunks"] == {"total": n, "queued": 0,
                                         "leased": 0, "delivered": 0,
                                         "acked": n}
                    and len(ledger["lease_table"]) == n
                    and all(row["state"] == "acked"
                            for row in ledger["lease_table"]),
                    "(c): job %s ledger %s", job_name, ledger["chunks"])
        # the third job ends the dispatcher's epoch
        tail_digest = served_read(address, "tail", dev)[0]
        out, err = disp.communicate(timeout=RANK_TIMEOUT_S)
        require(disp.returncode == 0 and "(%d acked" % (3 * n) in out,
                "(c): dispatch exited %s:\n%s%s", disp.returncode, out, err)
        served = worker.finish(0)
    finally:
        if worker is not None:
            worker.kill()
        if disp.poll() is None:
            _kill_group(disp)
    tokens = served["launches"]["tokenize_boundaries"]
    require(tokens == 0, "(c): the worker launched the tokenizer %d times "
            "on the native route", tokens)
    report["c"] = {"rows_per_s": EPOCHS * CRITEO_ROWS / got[2],
                   "fit_seconds": got[2], "worker": served,
                   "consumer": got[6],
                   "tail_rows_digest": tail_digest,
                   "phase_seconds": time.perf_counter() - t0}
    print(json.dumps({"plane_dispatch": report["c"]}), flush=True)

    # (d) --cluster ssh with a fake ssh: one epoch of phase 6's fit
    t0 = time.perf_counter()
    bindir = os.path.join(tmp, "fake_bin")
    os.makedirs(bindir)
    with open(os.path.join(bindir, "ssh"), "w") as fh:
        fh.write(FAKE_SSH)
    os.chmod(os.path.join(bindir, "ssh"), 0o755)
    hostfile = os.path.join(tmp, "ssh_hosts")
    with open(hostfile, "w") as fh:
        fh.write("localhost\n")
    one_history, one_params, _ = run_fit(csr, "csr", CRITEO_BATCH,
                                         CRITEO_DIM + 1, dev, epochs=1)
    job = launch(
        tmp, "d_ssh", ["--cluster", "ssh", "-n", 1, "-H", hostfile],
        "--plane-rank", {"file": csr, "epochs": 1, "nccl": False},
        env={"PATH": bindir + os.pathsep + os.environ.get("PATH", "")})
    reports, _, seconds = job.finish()
    rep = dict(reports[0], out=job.out)
    hold_rank_fit("(d) through --cluster ssh", rep, 1, one_history,
                  one_params)
    require(rep["cluster"] == "ssh", "(d): the rank saw cluster %s",
            rep["cluster"])
    report["d"] = {"seconds": seconds, "rows_per_s": rep["rows_per_s"],
                   "launches": {k: rep["launches"][k] for k in (
                       "coo_segment_sum", "tokenize_boundaries")},
                   "phase_seconds": time.perf_counter() - t0}
    print(json.dumps({"plane_ssh": report["d"]}), flush=True)

    # (e) what the plane costs the launched fit: its rank publishing and
    # not, in turns
    t0 = time.perf_counter()
    job = launch(
        tmp, "e_turns", gpu_args("localhost"), "--plane-rank",
        {"file": csr, "epochs": EPOCHS, "nccl": True,
         "turns": list(PLANE_COST_TURNS)}, status=True)
    reports, _, seconds = job.finish()
    rep = dict(reports[0], out=job.out)
    hold_rank_fit("(e)", rep, EPOCHS, paths["csr"]["loss_history"],
                  fit_params["csr"])
    turns = {0: [], 1: []}
    for armed, rows_per_s in zip(PLANE_COST_TURNS, rep["turn_rows_per_s"]):
        turns[armed].append(rows_per_s)
    report["e"] = {"rows_per_s_unarmed": turns[0],
                   "rows_per_s_armed": turns[1],
                   "armed_vs_unarmed": statistics.mean(turns[1])
                   / statistics.mean(turns[0]),
                   "turns": list(PLANE_COST_TURNS), "job_seconds": seconds,
                   "phase_seconds": time.perf_counter() - t0}
    print(json.dumps({"plane_cost": report["e"]}), flush=True)
    return report


def plane_summary(card, report) -> dict:
    """Phase 25's line: rows/s of each launched fit, the crash job against
    the clean one, the plane's cost in turns."""
    return {
        "card": card,
        "world1_nccl_rows_per_s": report["a"]["rows_per_s"],
        "profile_seg_sum_kernels": report["a"]["profile_seg_sum_kernels"],
        "world2_gloo_seconds": {k: report["b"][k]["seconds"]
                                for k in ("clean", "crash")},
        "world2_crash_vs_clean": report["b"]["vs_clean"],
        "dispatch_fit_rows_per_s": report["c"]["rows_per_s"],
        "dispatch_worker_tokenize_launches":
            report["c"]["worker"]["launches"]["tokenize_boundaries"],
        "ssh_rows_per_s": report["d"]["rows_per_s"],
        "cost": report["e"],
        "phase_seconds": {k: report[k]["phase_seconds"]
                          for k in ("a", "b", "c", "d", "e")}}


def remote_read_times(dev) -> dict:
    """``--remote-read``: phase 12's file from the fake ``s3://`` and from
    the local disk, in turns, through ``create_input_split`` alone (every
    chunk's bytes) and through ``create_row_block_iter`` on the card;
    MB/s of each read."""
    from dmlc_tpu_torch.data import create_row_block_iter
    from dmlc_tpu_torch.io import create_input_split

    def split_read(uri):
        split = create_input_split(uri, 0, 1)
        got = 0
        try:
            while (chunk := split.next_chunk()) is not None:
                got += len(chunk)
        finally:
            split.close()
        return got

    rates = {f"{route}_{where}": [] for route in ("split", "card")
             for where in ("s3", "local")}
    with tempfile.TemporaryDirectory() as tmp, remote_fakes() as fakes:
        path = os.path.join(tmp, "criteo_ingest.svm")
        write_criteo(path, INGEST_ROWS, seed=13)
        nbytes = os.path.getsize(path)
        with open(path, "rb") as fh:
            fakes["s3"].objects[("bkt", "ingest/criteo.svm")] = fh.read()
        uris = {"s3": "s3://bkt/ingest/criteo.svm", "local": path}
        for _ in range(REMOTE_READ_REPS):
            for where, uri in uris.items():
                t0 = time.perf_counter()
                got = split_read(uri)
                rates["split_" + where].append(
                    nbytes / 1e6 / (time.perf_counter() - t0))
                require(got == nbytes, "%s: the split read %d of %d bytes",
                        uri, got, nbytes)
                t0 = time.perf_counter()
                block = read_all(create_row_block_iter(uri, device=dev))[0]
                torch.cuda.synchronize()
                rates["card_" + where].append(
                    nbytes / 1e6 / (time.perf_counter() - t0))
                require(len(block) == INGEST_ROWS, "%s: %d rows", uri,
                        len(block))
                del block
        require(fakes["s3"].request_count > 0, "the fake s3 served nothing")
    return {"file_bytes": nbytes, "mb_per_s": rates}


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
    full = criteo_batch(dev, 3, per_row=CRITEO_NNZ + 1)
    full_ids = expand_row_ids(full["offsets"], full["values"].shape[0])
    full_ids64 = full_ids.long()
    full_contrib = full["values"] * 0.5
    dense = fused_case(kernels, dev, HIGGS_BATCH, HIGGS_FEATURES + 1,
                       "logistic", False, 2)[1]
    chunk = torch.tensor(token_chunk("mixed", CHUNK_BYTES, seed=1),
                         device=dev)
    with torch.no_grad():
        return {
            "flash_attention_fwd": [
                time_ms(lambda: kernels.flash_attention_fwd(q, k, v, True),
                        flush, 10) for _ in range(2)],
            "flash_attention_bwd": time_ms(
                lambda: kernels.flash_attention_bwd(
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
            "coo_segment_sum_full_bucket": time_ms(
                lambda: kernels.coo_segment_sum(full_contrib, full_ids,
                                                CRITEO_BATCH), flush),
            "index_add_full_bucket": time_ms(lambda: torch.zeros(
                CRITEO_BATCH, device=dev).index_add_(
                    0, full_ids64, full_contrib), flush),
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
    if sys.argv[1:] == ["--remote-read"]:
        from dmlc_tpu_torch.ops import kernels
        from dmlc_tpu_torch.utils.device import resolve_device

        dev = resolve_device(None)
        print("card:", card_line())
        kernels._lib()
        print(json.dumps({"remote_read": remote_read_times(dev)}))
        return 0
    if sys.argv[1:] == ["--pool-threads"]:
        from dmlc_tpu_torch.ops import kernels
        from dmlc_tpu_torch.utils.device import resolve_device

        dev = resolve_device(None)
        print("card:", card_line())
        kernels._lib()
        print(json.dumps({"pool_threads": pool_thread_times(dev)}))
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
    if sys.argv[1:2] == ["--plane-rank"] and len(sys.argv) == 3:
        return plane_rank(sys.argv[2])
    require(not sys.argv[1:], "unknown arguments %s (only --times, "
            "--remote-read and --pool-threads)",
            sys.argv[1:])
    # phases 5-6 and 12 write their files here, and phases 13-25 read
    # them again
    with tempfile.TemporaryDirectory() as fit_dir:
        return smoke(fit_dir)


def smoke(fit_dir: str) -> int:
    """Phases 1-27 (the module docstring), with the fit files in
    ``fit_dir``."""
    from dmlc_tpu_torch.ops import _build, kernels
    from dmlc_tpu_torch.ops.spmv import expand_row_ids, spmv_transpose
    from dmlc_tpu_torch.utils.device import resolve_device

    started = time.perf_counter()
    laps, last = {}, [started]

    def lap(phase):
        """Seconds since the last lap, as the given phase's."""
        now = time.perf_counter()
        laps[phase] = now - last[0]
        last[0] = now

    dev = resolve_device(None)  # also turns TF32 off
    card = card_line()
    print("card:", card, flush=True)
    torch.cuda.synchronize()

    lap("1")

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
    require(len(flash) == 2 * 3 * 2,
            "ptxas reported %d flash kernel variants, expected 12", len(flash))
    require(not any(flash.values()), "flash kernels spill: %s",
            {name: n for name, n in flash.items() if n})
    hgmma = sass_hgmma(str(_build.library_path()))
    print(json.dumps({"flash_hgmma": hgmma}), flush=True)
    require(hgmma is None or (len(hgmma) == 2 * 3 * 2
                              and all(hgmma.values())),
            "flash kernels: HGMMA counts %s, expected 12 variants "
            "(flash_fwd_kernel and flash_bwd_kernel) with warpgroup "
            "products", hgmma)
    # the native core, built from native/csrc by g++
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.native import _build as native_build

    t0 = time.perf_counter()
    native.get_lib()
    native_built = time.perf_counter() - t0
    print(json.dumps({"native_build_seconds": native_built,
                      "gxx_seconds": native_build.build_seconds,
                      "native_library": str(native.library_path()),
                      "simd_level": native.simd_level()}), flush=True)
    require("native/_build" in str(native.library_path()),
            "the native core loaded from %s", native.library_path())
    fused = [n for name, n in spills.items()
             if "fused_linear_grads_kernel" in name]
    require(fused == [0], "fused_linear_grads_kernel: ptxas spills %s",
            fused)
    seg = [n for name, n in spills.items() if "seg_sum_kernel" in name]
    require(seg == [0, 0], "seg_sum_kernel ([E] and [E, C]): ptxas spills "
            "%s", seg)
    sorted_sum = [n for name, n in spills.items()
                  if "sorted_sum_kernel" in name]
    require(sorted_sum == [0], "sorted_sum_kernel: ptxas spills %s",
            sorted_sum)
    torch.cuda.synchronize()

    lap("2")

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

    lap("3")

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
    hold_seg_sum_cols(kernels, dev, "criteo batch", row_ids.cpu().numpy(),
                      CRITEO_BATCH, SEG_WIDE_COLS)
    w_vec = torch.tensor(rng.randn(CRITEO_DIM + 1).astype(np.float32) * 0.1,
                         device=dev)
    contrib = batch["values"] * w_vec.index_select(0, batch["indices"])
    got = hold_seg_schedule(kernels, "criteo batch", contrib, row_ids,
                            CRITEO_BATCH)
    want = kernels.coo_segment_sum_plain(contrib, row_ids, CRITEO_BATCH)
    seg_err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
            "coo_segment_sum float data: max abs err %g", seg_err)
    fm_like = batch["values"][:, None] * torch.tensor(
        0.1 * rng.randn(entries, FM_COLS).astype(np.float32), device=dev)
    hold_seg_schedule(kernels, "criteo batch", fm_like, row_ids,
                      CRITEO_BATCH)
    full = criteo_batch(dev, 3, per_row=CRITEO_NNZ + 1)
    full_ids = expand_row_ids(full["offsets"], entries)
    full_contrib = full["values"] * w_vec.index_select(0, full["indices"])
    hold_seg_schedule(kernels, "full bucket", full_contrib, full_ids,
                      CRITEO_BATCH)
    row_grads = torch.tensor(rng.randn(CRITEO_BATCH).astype(np.float32),
                             device=dev)
    g1 = spmv_transpose(batch["values"], batch["indices"], row_ids,
                        row_grads, CRITEO_DIM + 1)
    g2 = spmv_transpose(batch["values"], batch["indices"], row_ids,
                        row_grads, CRITEO_DIM + 1)
    # integer values and row gradients: every sum exact, the CPU route's bits
    int_values = torch.tensor(rng.randint(-3, 4, entries).astype(
        np.float32), device=dev) * (batch["values"] != 0)
    int_grads = torch.tensor(rng.randint(-4, 5, CRITEO_BATCH).astype(
        np.float32), device=dev)
    g_int = spmv_transpose(int_values, batch["indices"], row_ids, int_grads,
                           CRITEO_DIM + 1)
    torch.cuda.synchronize()
    require(torch.equal(g1, g2), "spmv_transpose: two runs differ in bits")
    require(torch.equal(g_int.cpu(), spmv_transpose(
        int_values.cpu(), batch["indices"].cpu(), row_ids.cpu(),
        int_grads.cpu(), CRITEO_DIM + 1)),
            "spmv_transpose integer data: card and CPU routes differ")
    for name, ids, num_features in feature_sum_cases():
        hold_feature_sum(kernels, dev, name, ids, num_features, 0)
    cell_ids = cell_feature_ids(3)
    hold_feature_sum(kernels, dev, "criteo-fm step", cell_ids, CELL_FEATURES,
                     0)
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)  # 1 GiB
    transpose_row = feature_sum_row(kernels, dev, flush, 0)
    del flush
    print(json.dumps({"coo_segment_sum_float_max_abs_err": seg_err,
                      "coo_segment_sum_bits_equal_schedule": True,
                      "spmv_transpose_same_bits_twice": True,
                      "spmv_transpose_integer_bits_equal_cpu": True,
                      "feature_sum_ms": transpose_row}), flush=True)

    lap("4")

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

    lap("5-6")

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
    seg_ops = {}
    for what, c in (("csr", contrib), ("fm", fm_like)):
        seg_ops[what] = one_call_ops(lambda: kernels.coo_segment_sum(
            c, row_ids, CRITEO_BATCH))
        require_one_kernel(seg_ops[what], "coo_segment_sum " + what,
                           "seg_sum_kernel")
    print(json.dumps({"coo_segment_sum_device_ops": seg_ops}), flush=True)
    seg_row = seg_sum_row(kernels, dev, flush, "coo_segment_sum", contrib,
                          row_ids, paths["csr"]["launches"]["coo_segment_sum"],
                          seg_err)
    full_err = float((kernels.coo_segment_sum(
        full_contrib, full_ids, CRITEO_BATCH) - kernels.coo_segment_sum_plain(
            full_contrib, full_ids, CRITEO_BATCH)).abs().max())
    full_row = seg_sum_row(kernels, dev, flush, "coo_segment_sum_full_bucket",
                           full_contrib, full_ids,
                           paths["csr"]["launches"]["coo_segment_sum"],
                           full_err)
    torch.cuda.synchronize()
    del flush

    lap("7")

    # ---- 8. flash kernels vs plain -----------------------------------------
    for seed, case in enumerate(FLASH_CASES):
        report = flash_case(kernels, dev, *case, seed=40 + seed)
        print(json.dumps({"flash_vs_plain": report}), flush=True)
    torch.cuda.synchronize()

    lap("8")

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

    lap("9")

    # ---- 10. flash timings -----------------------------------------------------
    flash_rows, flash_extra = flash_timing_rows(
        kernels, dev, attention["path"]["launches"])
    torch.cuda.synchronize()
    print(json.dumps({"flash_timing_extra": flash_extra}), flush=True)

    lap("10")

    # ---- 11./12. the tokenizer and the ingest path --------------------------
    with tempfile.TemporaryDirectory() as tmp:
        # in fit_dir: phase 21 converts it again
        ingest_file = os.path.join(fit_dir, "criteo_ingest.svm")
        t0 = time.perf_counter()
        write_criteo(ingest_file, INGEST_ROWS, seed=13)
        write_seconds = time.perf_counter() - t0
        token_row, token_report = tokenizer_vs_plain(kernels, dev,
                                                     ingest_file)
        torch.cuda.synchronize()
        print(json.dumps({"tokenizer_vs_plain": token_report}), flush=True)
        ingest, python_block = drive_ingest(kernels, dev, ingest_file, tmp)
        ingest["write_seconds"] = write_seconds
        torch.cuda.synchronize()
    print(json.dumps({"ingest": ingest}), flush=True)
    token_row["launches"] = ingest["launches"]

    lap("11-12")

    # ---- 13. the distributed fit -------------------------------------------
    distributed = drive_distributed(kernels, dev, fit_files, fit_params)
    torch.cuda.synchronize()
    print(json.dumps({"distributed": distributed}), flush=True)

    lap("13")

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

    lap("14-15")

    # ---- 16. FM on the card ------------------------------------------------
    t0 = time.perf_counter()
    fm_file = os.path.join(fit_dir, "criteo.libfm")
    write_libfm(fm_file, CRITEO_ROWS, seed=12)
    with native_feeds() as fm_feeds:
        fm_out, fm_row, fm_start = drive_fm(kernels, dev, fm_file)
    require(fm_feeds and set(fm_feeds) == {"NativePipelineParser"},
            "fm path: the feeds staged natively over %s", fm_feeds)
    fm_out["native_feeds"] = len(fm_feeds)
    fm_out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"fm": fm_out}), flush=True)

    lap("16")

    # ---- 26. the native route beside the Python stack ----------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        native_report, python_fits = drive_native(
            kernels, dev, ingest_file, python_block, ingest, fit_files,
            paths, fit_params, fm_file, fm_out, fm_start, tmp)
    del python_block
    torch.cuda.synchronize()
    native_report["seconds"] = time.perf_counter() - t0
    native_report["build_seconds"] = native_built
    native_report["gxx_seconds"] = native_build.build_seconds
    native_report["simd_level"] = native.simd_level()
    print(json.dumps({"native_detail": native_report}), flush=True)

    lap("26")

    # ---- 27. the process parse pool ----------------------------------------
    t0 = time.perf_counter()
    pool = drive_pool(kernels, dev, ingest_file, ingest, fit_files,
                      python_fits)
    torch.cuda.synchronize()
    pool["seconds"] = time.perf_counter() - t0
    token_row["pool_launches"] = pool["pool_launches"]
    seg_row["pool_fit_launches"] = pool["fit"]["coo_segment_sum_launches"]

    lap("27")

    # ---- 17. snapshots and resume ------------------------------------------
    t0 = time.perf_counter()
    snaps = drive_snapshots(fit_files["csr"], fm_file, fm_start, fit_dir)
    torch.cuda.synchronize()
    snaps["seconds"] = time.perf_counter() - t0
    print(json.dumps({"snapshots": snaps}), flush=True)

    lap("17")

    # ---- 18. fault-tolerant distributed training ---------------------------
    t0 = time.perf_counter()
    recovery = drive_recovery(fit_files["csr"], fit_dir)
    recovery["seconds"] = time.perf_counter() - t0
    print(json.dumps({"recovery": recovery}), flush=True)

    lap("18")

    # ---- 19. expert-parallel MoE and the GPipe pipeline --------------------
    t0 = time.perf_counter()
    moe, pipeline = drive_moe(dev)
    moe["seconds"] = time.perf_counter() - t0
    print(json.dumps({"moe_detail": moe}), flush=True)

    lap("19")

    # ---- 20. the observability layer on the card --------------------------
    t0 = time.perf_counter()
    obs_report = drive_obs(kernels, dev, fit_files, fm_file, fm_start,
                           fit_dir)
    torch.cuda.synchronize()
    obs_report["seconds"] = time.perf_counter() - t0
    lap("20")
    print(json.dumps({"obs_detail": obs_report}), flush=True)

    # ---- 21. the binary ingest formats on the card ---------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        formats = drive_formats(kernels, dev, ingest_file, fit_files["csr"],
                                paths["csr"], fit_params["csr"], tmp)
    torch.cuda.synchronize()
    formats["seconds"] = time.perf_counter() - t0
    lap("21")

    # ---- 22. remote filesystems on the card --------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        remote = drive_remote(kernels, dev, ingest_file, ingest, fit_files,
                              paths, fit_params, tmp)
    torch.cuda.synchronize()
    remote["seconds"] = time.perf_counter() - t0
    lap("22")

    # ---- 23. the fault-tolerant data service on the card --------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data_service = drive_data_service(kernels, dev, ingest_file, ingest,
                                          fit_files, paths, fit_params, tmp,
                                          host_prefetch=0)
    torch.cuda.synchronize()
    data_service["seconds"] = time.perf_counter() - t0
    lap("23")
    print(json.dumps({"data_service_detail": data_service}), flush=True)

    # ---- 24. the feed's producer thread and window; CLIs and examples ------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        feed = drive_feed(kernels, dev, ingest_file, fit_files, paths,
                          fit_params, data_service, tmp)
    torch.cuda.synchronize()
    feed["seconds"] = time.perf_counter() - t0
    lap("24")
    print(json.dumps({"feed_detail": feed}), flush=True)

    # ---- 25. the status plane and the launchers on the card -----------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        plane = drive_status_plane(kernels, dev, fit_files, paths,
                                   fit_params, recovery, python_fits["csr"],
                                   tmp)
    torch.cuda.synchronize()
    plane["seconds"] = time.perf_counter() - t0
    lap("25")

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
        "phase_seconds": recovery["seconds"]}}))
    print(json.dumps({"moe": moe_summary(card, moe)}))
    print(json.dumps({"pipeline": dict(pipeline, card=card)}))
    print(json.dumps({"obs": obs_summary(card, obs_report)}))
    print(json.dumps({"formats": formats_summary(card, formats)}))
    print(json.dumps({"remote": remote_summary(card, remote)}))
    print(json.dumps({"data_service": data_service_summary(card,
                                                           data_service)}))
    print(json.dumps({"feed": feed_summary(card, feed)}))
    print(json.dumps({"plane": plane_summary(card, plane)}))
    print(json.dumps({"native": native_summary(card, native_report)}))
    print(json.dumps({"pool": pool_summary(card, pool)}))
    # ROADMAP fault 3.1: the fleet-fed csr fit's consumer in the first
    # (phase 23, depth 0), second (24 (b)) and third (25 (c)) fleet round
    print(json.dumps({"fleet_rounds": {
        "card": card,
        "round1_phase23": {
            "rows_per_s": data_service["fits"]["csr_one_worker"]["rows_per_s"],
            "consumer": data_service["fits"]["csr_one_worker"]["consumer"]},
        "round2_phase24b": {
            "rows_per_s": feed["fleet"]["rows_per_s"]["csr_one_worker"],
            "consumer": feed["fleet"]["csr_one_worker_consumer"]},
        "round3_phase25c": {"rows_per_s": plane["c"]["rows_per_s"],
                            "consumer": plane["c"]["consumer"]}}}))
    print(json.dumps({"phase_seconds": laps}))
    print(json.dumps({"seconds": time.perf_counter() - started}))
    print(json.dumps({"kernels": [fused_row, seg_row] + flash_rows
                      + [token_row, fm_row, full_row]}))
    print("card:", card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""dmlc_tpu_torch: the dmlc_tpu training path in PyTorch, on NVIDIA GPUs.

A second package beside ``dmlc_tpu`` with the same layout, so each module's
counterpart sits at the same path:

- ``dmlc_tpu_torch.utils``  — DMLCError/check logging layer, device rule,
  the threefry copy behind GBDT's masks and FM's init (``utils.prng``),
  the threaded iterator, the stopwatch (``utils.timer``)
- ``dmlc_tpu_torch.params`` — the Parameter/field subset the learners use,
  the parser registry, typed environment reads (``params.env``)
- ``dmlc_tpu_torch.io``     — the FileSystem registry (local files,
  ``mem://``, ``http(s)://``, ``s3://``, ``gs://``, ``hdfs://`` over
  WebHDFS, ``azure://``), URISpec, the InputSplits over any of them
  (text, recordio, indexed recordio, stdin; prefetch, cache and
  shuffle), RecordIO, the ``.dtsh`` shards (local files), streams, the
  serializer, the ordered read-ahead window and the remote partition
  reader
- ``dmlc_tpu_torch.data``   — RowBlock, the libsvm / libfm / csv parsers
  (libsvm tokenized by a CUDA kernel on the card), the RecordIO row
  groups, ``PipelinedParser``, the row-block iterators with the
  ``#cachefile`` disk pages, and ``reshard_split``
- ``dmlc_tpu_torch.device`` — static-shape padding, the sharded csr batch
  and the pinned-memory DeviceFeed
- ``dmlc_tpu_torch.ops``    — objectives, SpMV, the long-context attention
  schedules (ring, Ulysses, flash), expert-parallel MoE (``ops.moe``),
  GPipe pipeline parallelism (``ops.pipeline_parallel``), and the
  hand-written CUDA kernels (``ops/csrc``) with their plain PyTorch
  versions
- ``dmlc_tpu_torch.parallel`` — differentiable collectives over a
  ``torch.distributed`` process group (``parallel.axis``: the mesh-axis
  primitives) and the multi-process bootstrap (``parallel.distributed``)
- ``dmlc_tpu_torch.collective`` — the rabit API: the socket engine and
  the ``torch.distributed`` device engine, checkpoints, job snapshots,
  crash recovery and elastic membership
- ``dmlc_tpu_torch.tracker`` — the rabit tracker and the local launcher
  (``python -m dmlc_tpu_torch.tracker.submit``)
- ``dmlc_tpu_torch.resilience`` — fault injection, preemption notices,
  the retry policy and hedged calls
- ``dmlc_tpu_torch.models`` — the allreduce-SGD linear learner,
  factorization machines and histogram GBDT, with the shared fit-loop
  observability (``models.fitloop.FitLoopObs``)
- ``dmlc_tpu_torch.obs`` — metrics, spans and flows, exporters, the
  flight recorder, cross-host snapshots, the goodput ledger and SLO
  watchdog, device telemetry and step cost records, and the determinism
  audit (``DMLC_TPU_METRICS``, ``DMLC_TPU_TRACE``, ``DMLC_TPU_AUDIT``, ...)
- ``dmlc_tpu_torch.examples`` — the MoE-transformer block over process
  groups (``python -m dmlc_tpu_torch.examples.moe_transformer``)
- ``dmlc_tpu_torch.tools``  — ``python -m dmlc_tpu_torch.tools <cmd>``:
  ``bake``, ``filesys``, ``parity``, ``recordio``, ``rowrec``

The package imports ``torch`` and numpy only: never ``jax`` and nothing of
``dmlc_tpu``. Entry points take ``device=None``, which means ``cuda``; with
no CUDA device they raise unless the caller passes ``device="cpu"``. On a
CUDA tensor every kernel wrapper launches its kernel; the plain version runs
only for tensors on the CPU.
"""

__version__ = "0.1.0"

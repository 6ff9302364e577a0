"""dmlc_tpu_torch: the dmlc_tpu training path in PyTorch, on NVIDIA GPUs.

A second package beside ``dmlc_tpu`` with the same layout, so each module's
counterpart sits at the same path:

- ``dmlc_tpu_torch.utils``  — DMLCError/check logging layer, device rule,
  the threefry copy behind GBDT's masks and FM's init (``utils.prng``),
  the threaded iterator
- ``dmlc_tpu_torch.params`` — the Parameter/field subset the learners use,
  the parser registry
- ``dmlc_tpu_torch.io``     — URISpec, the byte-range InputSplit (local
  files), streams, the serializer, the ordered read-ahead window
- ``dmlc_tpu_torch.data``   — RowBlock, the libsvm / libfm / csv parsers
  (libsvm tokenized by a CUDA kernel on the card), ``PipelinedParser``,
  the row-block iterators with the ``#cachefile`` disk pages, and
  ``reshard_split``
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
- ``dmlc_tpu_torch.resilience`` — fault injection, preemption notices and
  the retry policy
- ``dmlc_tpu_torch.models`` — the allreduce-SGD linear learner,
  factorization machines and histogram GBDT
- ``dmlc_tpu_torch.examples`` — the MoE-transformer block over process
  groups (``python -m dmlc_tpu_torch.examples.moe_transformer``)
- ``dmlc_tpu_torch.tools``  — the parity tool (``python -m
  dmlc_tpu_torch.tools.parity``)

The package imports ``torch`` and numpy only: never ``jax`` and nothing of
``dmlc_tpu``. Entry points take ``device=None``, which means ``cuda``; with
no CUDA device they raise unless the caller passes ``device="cpu"``. On a
CUDA tensor every kernel wrapper launches its kernel; the plain version runs
only for tensors on the CPU.
"""

__version__ = "0.1.0"

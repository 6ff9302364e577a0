"""dmlc_tpu_torch: the dmlc_tpu training path in PyTorch, on NVIDIA GPUs.

A second package beside ``dmlc_tpu`` with the same layout, so each module's
counterpart sits at the same path:

- ``dmlc_tpu_torch.utils``  — DMLCError/check logging layer, device rule
- ``dmlc_tpu_torch.params`` — the Parameter/field subset the learners use
- ``dmlc_tpu_torch.io``     — URISpec and the byte-range InputSplit (local
  files)
- ``dmlc_tpu_torch.data``   — RowBlock, the vectorized libsvm parser
- ``dmlc_tpu_torch.device`` — static-shape padding and the pinned-memory
  DeviceFeed
- ``dmlc_tpu_torch.ops``    — objectives, SpMV, the long-context attention
  schedules (ring, Ulysses, flash), and the hand-written CUDA kernels
  (``ops/csrc``) with their plain PyTorch versions
- ``dmlc_tpu_torch.parallel`` — differentiable collectives over a
  ``torch.distributed`` process group (the sequence axis)
- ``dmlc_tpu_torch.models`` — the allreduce-SGD linear learner

The package imports ``torch`` and numpy only: never ``jax`` and nothing of
``dmlc_tpu``. Entry points take ``device=None``, which means ``cuda``; with
no CUDA device they raise unless the caller passes ``device="cpu"``. On a
CUDA tensor every kernel wrapper launches its kernel; the plain version runs
only for tensors on the CPU.
"""

__version__ = "0.1.0"

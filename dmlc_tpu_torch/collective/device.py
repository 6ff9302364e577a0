"""Device-plane collectives over a ``torch.distributed`` process group, the
counterpart of ``dmlc_tpu/collective/device.py`` (XLA collectives over
ICI/DCN there; NCCL between cards, or gloo, here).

- :func:`bucketed_all_reduce`: the fused gradient allreduce of the
  data-parallel train step (the counterpart of ``bucketed_psum``): same-
  dtype tensors flattened into one contiguous bucket, ONE
  ``dist.all_reduce``, split back. Never upcasts.
- :class:`DeviceEngine`: the rabit-style host-array façade (allreduce,
  broadcast, allgather, barrier, abort, shutdown) over a process group,
  for the collective API's "device" engine.

The process group is the caller's (``parallel/distributed.py`` starts
one); nothing here picks a backend. A backend failure (a lost peer)
surfaces from both as :class:`DMLCError`, the error
``collective.run_with_recovery`` recovers from; recovery aborts the
group, starts a new default group and builds a new ``DeviceEngine`` over
it (``collective.reinit_recover``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dmlc_tpu_torch.utils.logging import DMLCError

_REDUCE_OPS = {
    "sum": dist.ReduceOp.SUM,
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
    "prod": dist.ReduceOp.PRODUCT,
}


def bucketed_all_reduce(tensors: Sequence[torch.Tensor],
                        group=None) -> List[torch.Tensor]:
    """Sum ``tensors`` over ``group`` (None: the default group) with ONE
    ``all_reduce`` per dtype: each dtype's tensors are flattened into one
    contiguous bucket in the given order, reduced, and split back to their
    shapes. Same-dtype buckets only, so nothing is upcast by a mixed
    concatenation. Returns new tensors; the inputs are not written. A
    backend failure raises DMLCError."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idxs in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        try:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        except RuntimeError as err:
            raise DMLCError(f"bucketed all_reduce failed: {err}") from err
        offset = 0
        for i in idxs:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


class DeviceEngine:
    """Host-array allreduce/broadcast/allgather as collectives of a
    ``torch.distributed`` process group.

    ``group`` None means the default group. The arrays travel as tensors
    on ``device``: None means the current CUDA device for an NCCL group
    (NCCL moves only card memory) and the CPU otherwise. After
    :meth:`abort` (or a backend failure) every call raises DMLCError.
    """

    # broadcast header: [ndim, dims[0..7], dtype code]
    _HDR_SLOTS = 10
    _DTYPES = tuple(np.dtype(t) for t in (
        np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8,
        np.float16, np.float32, np.float64))

    def __init__(self, group=None, device=None):
        if not dist.is_initialized():
            raise DMLCError("DeviceEngine needs an initialized "
                            "torch.distributed process group")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        if device is None:
            nccl = dist.get_backend(group) == "nccl"
            device = (torch.device("cuda", torch.cuda.current_device())
                      if nccl else torch.device("cpu"))
        self.device = torch.device(device)
        self._aborted = False

    def _check_live(self) -> None:
        if self._aborted:
            raise DMLCError("device engine aborted (pending recover); "
                            "reinit before collectives")

    def _fail(self, err: Exception, what: str) -> DMLCError:
        """A backend failure (a lost peer, a transport error) marks the
        engine dead, as the socket engine's abort does."""
        self._aborted = True
        return DMLCError(f"device collective {what} failed: {err}")

    @classmethod
    def _validate(cls, array) -> np.ndarray:
        """Raise locally on input every rank would reject: a user error,
        not a transport failure."""
        arr = np.ascontiguousarray(array)
        if arr.dtype not in cls._DTYPES:
            raise TypeError(f"device collectives take "
                            f"{[str(d) for d in cls._DTYPES]}, got "
                            f"{arr.dtype}")
        return arr

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr.copy()).to(self.device)

    def allreduce(self, array: np.ndarray, op: str = "sum") -> np.ndarray:
        """Reduce a host array over the group: sum, max, min and prod by
        ``all_reduce``; bitor (integer arrays) as an ``all_gather`` folded
        in rank order, since NCCL has no bitwise reduction."""
        self._check_live()
        arr = self._validate(array)
        if op not in _REDUCE_OPS and op != "bitor":
            raise ValueError(f"unknown op {op!r}")
        if op == "bitor" and arr.dtype.kind not in "iub":
            raise TypeError(f"bitor needs an integer dtype, got {arr.dtype}")
        if self.world_size == 1:
            return arr
        try:
            t = self._tensor(arr)
            if op == "bitor":
                parts = [torch.empty_like(t) for _ in range(self.world_size)]
                dist.all_gather(parts, t, group=self.group)
                t = parts[0]
                for part in parts[1:]:
                    t = torch.bitwise_or(t, part)
            else:
                dist.all_reduce(t, op=_REDUCE_OPS[op], group=self.group)
            return t.cpu().numpy()
        except RuntimeError as err:
            raise self._fail(err, "allreduce") from err

    def broadcast(self, array: Optional[np.ndarray],
                  root: int = 0) -> np.ndarray:
        """Broadcast from ``root``; other ranks may pass None (rabit
        semantics). A fixed-size header carries the shape and dtype
        first. A root's invalid input travels through the header (ndim
        -1), so every rank raises the same TypeError instead of the others
        waiting in the collective."""
        self._check_live()
        is_root = self.rank == root
        if self.world_size == 1:
            if array is None:
                raise TypeError("broadcast root must supply data")
            return self._validate(array)
        header = np.zeros(self._HDR_SLOTS, dtype=np.int64)
        arr = None
        root_err: Optional[Exception] = None
        if is_root:
            try:
                if array is None:
                    raise TypeError("broadcast root must supply data")
                arr = self._validate(array)
                if arr.ndim > self._HDR_SLOTS - 2:
                    raise ValueError(f"broadcast supports <= "
                                     f"{self._HDR_SLOTS - 2} dims, got "
                                     f"{arr.ndim}")
                header[0] = arr.ndim
                header[1:1 + arr.ndim] = arr.shape
                header[-1] = self._DTYPES.index(arr.dtype)
            except (TypeError, ValueError) as err:
                root_err = err
                header[0] = -1
        try:
            t_header = self._tensor(header)
            dist.broadcast(t_header, src=self._global(root),
                           group=self.group)
            header = t_header.cpu().numpy()
        except RuntimeError as err:
            raise self._fail(err, "broadcast") from err
        if int(header[0]) < 0:
            if root_err is not None:
                raise root_err
            raise TypeError("broadcast root input was invalid (see the "
                            "root rank's log)")
        if not is_root:
            shape = tuple(int(d) for d in header[1:1 + int(header[0])])
            arr = np.zeros(shape, dtype=self._DTYPES[int(header[-1])])
        try:
            t = self._tensor(arr)
            dist.broadcast(t, src=self._global(root), group=self.group)
            return t.cpu().numpy()
        except RuntimeError as err:
            raise self._fail(err, "broadcast") from err

    def _global(self, rank: int) -> int:
        """The default group's rank of ``rank`` in this engine's group."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    def allgather(self, array: np.ndarray) -> List[np.ndarray]:
        """Every rank's array, in rank order: one broadcast round a rank,
        so the ranks' shapes may differ (rabit Allgather semantics)."""
        return [self.broadcast(array if r == self.rank else None, root=r)
                for r in range(self.world_size)]

    def barrier(self) -> None:
        """Wait for every rank: a one-element all_reduce on the engine's
        device (NCCL's own barrier guesses a device)."""
        self._check_live()
        if self.world_size == 1:
            return
        try:
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self.group)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except RuntimeError as err:
            raise self._fail(err, "barrier") from err

    def abort(self) -> None:
        """Mark the engine dead: collectives raise DMLCError until a new
        engine is built over a re-initialized process group."""
        self._aborted = True

    def shutdown(self) -> None:
        """Retire the engine; the process group stays the caller's
        (``parallel.distributed.shutdown`` ends it)."""
        self._aborted = True

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

Observability, on the reference's names: each engine op counts
``dmlc_collective_ops_total`` / ``dmlc_collective_moved_bytes_total`` and
times ``dmlc_collective_op_ns`` (the goodput ledger's collective stage)
inside an ``allreduce`` / ``broadcast`` / ``barrier`` span that steps
the in-flight chunk's flow; the engine's staging copies are metered
(``dmlc_feed_h2d_*{feed="collective"}``, ``dmlc_collective_d2h_bytes_total``);
the reduction is the ``collective.reduce`` instrumented site; and both
the engine and :func:`bucketed_all_reduce` add the bytes they move to a
step-cost recording (``obs.xla_cost.note_collective``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.obs.device_telemetry import h2d_meter, instrumented_step
from dmlc_tpu_torch.obs.xla_cost import note_collective
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
        note_collective(flat.numel() * flat.element_size())
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
        self._reduce_fns: dict = {}
        # host-array staging accounting: None when device telemetry is
        # off (then no timing and no byte walk)
        self._h2d = (h2d_meter(feed="collective")
                     if self.device.type == "cuda" else None)
        self._m_d2h = (
            obs.registry().counter(
                "dmlc_collective_d2h_bytes_total",
                "device->host result bytes copied back by host-path "
                "collectives (the copy the in-graph SPMD path eliminates)",
                op="allreduce",
            )
            if self._h2d is not None
            else None
        )

    def _reduce_fn(self, op: str):
        """The in-place reduction of one staged tensor over the group, as
        the ``collective.reduce`` instrumented site (the reference's
        jitted reduction)."""
        fn = self._reduce_fns.get(op)
        if fn is None:
            group = self.group
            if op == "bitor":
                def reduce_fn(t):
                    parts = [torch.empty_like(t)
                             for _ in range(self.world_size)]
                    note_collective(t.numel() * t.element_size()
                                    * self.world_size)
                    dist.all_gather(parts, t, group=group)
                    out = parts[0]
                    for part in parts[1:]:
                        out = torch.bitwise_or(out, part)
                    return out
            else:
                reduce_op = _REDUCE_OPS[op]

                def reduce_fn(t):
                    note_collective(t.numel() * t.element_size())
                    dist.all_reduce(t, op=reduce_op, group=group)
                    return t
            fn = instrumented_step(reduce_fn, "collective.reduce")
            self._reduce_fns[op] = fn
        return fn

    @staticmethod
    def _record(what: str, nbytes: int, t0: int) -> None:
        """Count a completed host collective in the obs registry (per
        call: the registry hands back the same child for a repeated
        (name, labels) pair)."""
        reg = obs.registry()
        reg.counter(
            "dmlc_collective_ops_total", "host collectives completed",
            op=what).inc()
        reg.counter(
            "dmlc_collective_moved_bytes_total",
            "payload bytes through host collectives", op=what).inc(nbytes)
        reg.histogram(
            "dmlc_collective_op_ns", "per-op host collective latency",
            op=what).observe(time.monotonic_ns() - t0)

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
        t0 = time.monotonic_ns()
        if self.world_size == 1:
            self._record("allreduce", int(arr.nbytes), t0)
            return arr
        try:
            t_h2d = time.monotonic_ns()
            t = self._tensor(arr)
            if self._h2d is not None:
                self._h2d.note(int(arr.nbytes), time.monotonic_ns() - t_h2d)
            with obs.span("allreduce", op=op, nbytes=int(arr.nbytes)):
                # mark the in-flight chunk (set by DeviceFeed around the
                # consume yield) so the op slice joins its arrow chain
                obs.flow_step(obs.current_flow(), "chunk")
                t = self._reduce_fn(op)(t)
            res = t.cpu().numpy()
            if self._m_d2h is not None:
                self._m_d2h.inc(int(res.nbytes))
            self._record("allreduce", int(arr.nbytes), t0)
            return res
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
        t0 = time.monotonic_ns()
        if self.world_size == 1:
            if array is None:
                raise TypeError("broadcast root must supply data")
            arr = self._validate(array)
            self._record("broadcast", int(arr.nbytes), t0)
            return arr
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
            with obs.span("broadcast", root=root, nbytes=int(arr.nbytes)):
                obs.flow_step(obs.current_flow(), "chunk")
                t = self._tensor(arr)
                dist.broadcast(t, src=self._global(root), group=self.group)
                out = t.cpu().numpy()
            self._record("broadcast", int(arr.nbytes), t0)
            return out
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
        t0 = time.monotonic_ns()
        if self.world_size > 1:
            try:
                with obs.span("barrier"):
                    obs.flow_step(obs.current_flow(), "chunk")
                    dist.all_reduce(torch.zeros(1, device=self.device),
                                    group=self.group)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            except RuntimeError as err:
                raise self._fail(err, "barrier") from err
        self._record("barrier", 0, t0)

    def abort(self) -> None:
        """Mark the engine dead: collectives raise DMLCError until a new
        engine is built over a re-initialized process group."""
        self._aborted = True

    def shutdown(self) -> None:
        """Retire the engine; the process group stays the caller's
        (``parallel.distributed.shutdown`` ends it)."""
        self._aborted = True

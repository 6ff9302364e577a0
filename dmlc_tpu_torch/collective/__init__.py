"""Rabit-style collective API, the port of ``dmlc_tpu/collective``'s engine
selection: ``init / finalize / rank / world_size / allreduce / broadcast /
allgather / barrier / tracker_print / engine_kind`` over one engine a
process:

- "socket": the tree/ring TCP engine of the rabit tracker protocol
  (``collective.socket_engine``), wherever the DMLC_TRACKER_URI contract
  is in effect;
- "device": collectives of the ``torch.distributed`` process group
  (``collective.device.DeviceEngine``);
- "local": the world-size-1 no-op engine.

``init()`` ("auto") picks: DMLC_TRACKER_URI set → socket; an initialized
``torch.distributed`` world larger than 1 → device; else local. An
explicit ``engine=`` wins. The host-array ``allreduce`` is the
compatibility surface (the hostsync train step); the data-parallel step
reduces its gradients on the device with ``bucketed_all_reduce``.

Checkpoints: the rabit API ``checkpoint(state, uri)`` /
``load_checkpoint(uri)`` / ``version_number()`` over one in-process blob
(optionally a file), and the job-snapshot plane of ``collective.checkpoint``
(``CheckpointManager``, ``JobSnapshot``) and ``collective.snapshot``
(``Snapshotter``, ``load_snapshot``). Recovery (``reinit_recover``,
``broadcast_state``, ``run_with_recovery``) and elastic membership are
not ported.
"""

from __future__ import annotations

import os
import threading
from typing import Any, List, Optional

import numpy as np
import torch.distributed as dist

from dmlc_tpu_torch.collective.checkpoint import (CheckpointManager,
                                                  JobSnapshot,
                                                  SnapshotSuperseded)
from dmlc_tpu_torch.collective.device import DeviceEngine, \
    bucketed_all_reduce
from dmlc_tpu_torch.collective.snapshot import Snapshotter, load_snapshot
from dmlc_tpu_torch.collective.socket_engine import SocketEngine
from dmlc_tpu_torch.io.filesystem import create_stream
from dmlc_tpu_torch.io.serializer import load_obj, save_obj
from dmlc_tpu_torch.io.stream import MemoryStream
from dmlc_tpu_torch.resilience import faultpoint
from dmlc_tpu_torch.utils.logging import DMLCError, log_info

_engine = None
_engine_lock = threading.Lock()
# the rabit checkpoint: the newest blob and its version, in this process
_version = 0
_checkpoint_blob: Optional[bytes] = None


class _LocalEngine:
    """world=1 no-op engine (rabit semantics when not launched
    distributed)."""

    rank = 0
    world_size = 1

    def allreduce(self, array, op="sum"):
        return np.asarray(array)

    def broadcast(self, array, root=0):
        if array is None:
            raise TypeError("broadcast root must supply data")
        return np.asarray(array)

    def allgather(self, array):
        return [np.asarray(array)]

    def barrier(self):
        pass

    def tracker_print(self, msg):
        log_info("%s", msg)

    def shutdown(self):
        pass


def init(engine: str = "auto", **kwargs) -> None:
    """Start this process's engine (rabit.init); a no-op when one runs.
    ``kwargs`` go to the engine's constructor."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            return
        if engine == "auto":
            if os.environ.get("DMLC_TRACKER_URI"):
                engine = "socket"
            elif dist.is_initialized() and dist.get_world_size() > 1:
                engine = "device"
            else:
                engine = "local"
        if engine == "socket":
            _engine = SocketEngine(**kwargs)
        elif engine == "device":
            _engine = DeviceEngine(**kwargs)
        elif engine == "local":
            _engine = _LocalEngine()
        else:
            raise DMLCError(f"unknown collective engine {engine!r}")


def _get():
    if _engine is None:
        init()
    return _engine


def engine_kind() -> str:
    """The active engine's kind, "socket", "device" or "local",
    initializing through the auto path on first use."""
    eng = _get()
    if isinstance(eng, SocketEngine):
        return "socket"
    if isinstance(eng, DeviceEngine):
        return "device"
    return "local"


def finalize() -> None:
    """rabit.finalize: release the links and tell the tracker."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            _engine.shutdown()
            _engine = None


def rank() -> int:
    return _get().rank


def world_size() -> int:
    return _get().world_size


def allreduce(array, op: str = "sum") -> np.ndarray:
    """Allreduce a host array across workers (rabit.allreduce)."""
    return _get().allreduce(np.asarray(array), op=op)


def broadcast(array, root: int = 0) -> np.ndarray:
    """Broadcast from ``root``; other ranks may pass None."""
    return _get().broadcast(None if array is None else np.asarray(array),
                            root=root)


def allgather(array) -> List[np.ndarray]:
    """Every rank's array, in rank order."""
    return _get().allgather(np.asarray(array))


def barrier() -> None:
    _get().barrier()


def tracker_print(msg: str) -> None:
    """Print through the tracker's log (rabit.tracker_print); the device
    engine has no tracker, so rank 0 logs it."""
    engine = _get()
    if hasattr(engine, "tracker_print"):
        engine.tracker_print(msg)
    elif engine.rank == 0:
        log_info("%s", msg)


# ---- checkpointing (rabit CheckPoint/LoadCheckPoint semantics) ------------


def checkpoint(state: Any, uri: Optional[str] = None) -> None:
    """Keep ``state`` as the process's newest checkpoint and bump the
    version; with ``uri`` also write it there. The blob is the reference's
    ``("dmlc_ckpt_v1", version, state)`` through the serializer, so either
    package reads the other's file. Tensors must be host arrays (numpy)."""
    global _version, _checkpoint_blob
    # before the bump: an injected commit fault leaves the version as it was
    faultpoint("ckpt.commit")
    _version += 1
    stream = MemoryStream()
    save_obj(stream, ("dmlc_ckpt_v1", _version, state))
    _checkpoint_blob = stream.getvalue()
    if uri:
        with create_stream(uri, "w") as out:
            out.write(_checkpoint_blob)


def load_checkpoint(uri: Optional[str] = None) -> Optional[Any]:
    """The newest checkpoint's state (the in-process blob, else the file at
    ``uri``), or None. Sets ``version_number()`` to its version."""
    global _version, _checkpoint_blob
    blob = _checkpoint_blob
    if blob is None and uri:
        faultpoint("ckpt.read")
        stream = create_stream(uri, "r", allow_null=True)
        if stream is not None:
            with stream:
                blob = stream.read_all()
            _checkpoint_blob = blob
    if blob is None:
        return None
    payload = load_obj(MemoryStream(blob))
    if (isinstance(payload, tuple) and len(payload) == 3
            and payload[0] == "dmlc_ckpt_v1"):
        _version = int(payload[1])
        return payload[2]
    return payload  # a blob written before versions: the state as it is


def version_number() -> int:
    """Number of checkpoints taken (rabit.version_number)."""
    return _version


__all__ = [
    "CheckpointManager", "DeviceEngine", "JobSnapshot", "SnapshotSuperseded",
    "Snapshotter", "SocketEngine", "allgather", "allreduce", "barrier",
    "broadcast", "bucketed_all_reduce", "checkpoint", "engine_kind",
    "finalize", "init", "load_checkpoint", "load_snapshot", "rank",
    "tracker_print", "version_number", "world_size",
]

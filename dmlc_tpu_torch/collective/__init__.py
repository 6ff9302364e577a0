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

Checkpoints, version numbers, recovery and elastic membership are not
ported.
"""

from __future__ import annotations

import os
import threading
from typing import List

import numpy as np
import torch.distributed as dist

from dmlc_tpu_torch.collective.device import DeviceEngine, \
    bucketed_all_reduce
from dmlc_tpu_torch.collective.socket_engine import SocketEngine
from dmlc_tpu_torch.utils.logging import DMLCError, log_info

_engine = None
_engine_lock = threading.Lock()


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


__all__ = [
    "DeviceEngine", "SocketEngine", "allgather", "allreduce", "barrier",
    "broadcast", "bucketed_all_reduce", "engine_kind", "finalize", "init",
    "rank", "tracker_print", "world_size",
]

"""Worker-side multi-process bootstrap: ``torch.distributed`` in place of
``jax.distributed``, the port of ``dmlc_tpu/parallel/distributed.py``.

A launcher exports DMLC_TPU_COORDINATOR / DMLC_TPU_NUM_PROC /
DMLC_TPU_PROC_ID; :func:`initialize_from_env` turns those into a default
process group, and :func:`initialize` takes them as arguments. The
coordinator is ``host:port`` (a TCP rendezvous that rank 0 serves) or a
full init-method URL (``tcp://...``, ``file://...``).

The backend is the caller's choice or follows the device: ``nccl`` for a
CUDA device, ``gloo`` for the CPU. An explicit ``backend="gloo"`` with a
CUDA device is allowed, and is how two ranks share one card (NCCL refuses
two ranks on one GPU). Nothing switches backend on its own.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check

_initialized = False


def env_process_info() -> Optional[dict]:
    """{coordinator, num_processes, process_id} from the DMLC_TPU_* env, or
    None when no launcher set it."""
    coord = os.environ.get("DMLC_TPU_COORDINATOR")
    if not coord:
        return None
    return {
        "coordinator": coord,
        "num_processes": int(os.environ.get("DMLC_TPU_NUM_PROC", 1)),
        "process_id": int(os.environ.get(
            "DMLC_TPU_PROC_ID", os.environ.get("DMLC_TASK_ID", 0))),
    }


def multiprocess_env() -> bool:
    """True when the launcher contract names a multi-process job."""
    info = env_process_info()
    return info is not None and info["num_processes"] > 1


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, device=None) -> torch.device:
    """Start the default process group of ``num_processes`` ranks as rank
    ``process_id``, and return the rank's device.

    ``device`` (None means cuda; ``"cuda:1"`` names a card) becomes the
    current CUDA device of a CUDA rank. ``backend`` None means ``nccl``
    for a CUDA device and ``gloo`` for the CPU. Calling it again while
    this module's group is up raises."""
    global _initialized
    check(not _initialized and not dist.is_initialized(),
          "torch.distributed is already initialized")
    check(0 <= process_id < num_processes, "process_id %d out of [0, %d)",
          process_id, num_processes)
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    _initialized = True
    return dev


def initialize_from_env(force: bool = False, backend: Optional[str] = None,
                        device=None) -> bool:
    """:func:`initialize` from the DMLC_TPU_* env contract. Returns True
    when a multi-process group is up (started now or before), False when
    the env names a single process (no-op). ``force`` ends this module's
    group first and starts a new one."""
    info = env_process_info()
    if info is None or info["num_processes"] <= 1:
        return False
    if _initialized and not force:
        return True
    if _initialized:
        shutdown()
    initialize(info["coordinator"], info["num_processes"],
               info["process_id"], backend=backend, device=device)
    return True


def shutdown() -> None:
    """End the process group this module started (idempotent)."""
    global _initialized
    if _initialized:
        dist.destroy_process_group()
        _initialized = False


def process_index() -> int:
    info = env_process_info()
    if info is not None:
        return info["process_id"]
    return int(os.environ.get("DMLC_TASK_ID", 0))


def process_count() -> int:
    info = env_process_info()
    if info is not None:
        return info["num_processes"]
    return int(os.environ.get("DMLC_NUM_WORKER", 1))

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

Every group gets an explicit timeout, ``PG_TIMEOUT_S``: a collective with
a dead peer, or a re-rendezvous waiting for a relaunched rank 0 (which
serves the ``tcp://`` store), fails after it instead of torch's 30
minutes. A ``torch.distributed`` world fixes its size when it starts, so
elastic re-entry stays on the socket engine (:func:`elastic_capable`).
"""

from __future__ import annotations

import datetime
import errno
import gc
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import DMLCError, check

_initialized = False
# (backend, device) of the group this module started last: a forced
# re-init starts the new group the same way
_setup: Optional[tuple] = None

#: seconds a collective or the store's rendezvous may wait on a peer
PG_TIMEOUT_S = 300.0


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


def elastic_capable() -> bool:
    """True when this process's bootstrap can change the world size in a
    run: not in a multi-process ``torch.distributed`` job, whose size is
    fixed at initialization, so only the socket engine re-enters
    elastically (tracker cmd='elastic')."""
    return not multiprocess_env()


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, device=None) -> torch.device:
    """Start the default process group of ``num_processes`` ranks as rank
    ``process_id``, and return the rank's device.

    ``device`` (None means cuda; ``"cuda:1"`` names a card) becomes the
    current CUDA device of a CUDA rank. ``backend`` None means ``nccl``
    for a CUDA device and ``gloo`` for the CPU. Calling it again while
    this module's group is up raises."""
    global _initialized, _setup
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
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    _initialized = True
    _setup = (backend, dev)
    return dev


def initialize_from_env(force: bool = False, backend: Optional[str] = None,
                        device=None) -> bool:
    """:func:`initialize` from the DMLC_TPU_* env contract. Returns True
    when a multi-process group is up (started now or before), False when
    the env names a single process (no-op). ``force`` (the recovery path)
    aborts this module's group, which may have lost a peer, and starts a
    new one with the backend and device this module started last unless
    they are given: also when an earlier forced attempt already aborted
    the group and then failed, so a retried re-init never switches
    backend on its own. Rank 0 of a ``host:port`` / ``tcp://`` job then
    checks that the old group's store server is gone (see
    :func:`_check_store_port_free`)."""
    info = env_process_info()
    if info is None or info["num_processes"] <= 1:
        return False
    if _initialized and not force:
        return True
    if force:
        abort()
        gc.collect()  # an old group held only by reference cycles goes
        if _setup is not None:
            backend = backend or _setup[0]
            device = device if device is not None else _setup[1]
        if info["process_id"] == 0:
            _check_store_port_free(info["coordinator"])
    initialize(info["coordinator"], info["num_processes"],
               info["process_id"], backend=backend, device=device)
    return True


def _check_store_port_free(coordinator: str) -> None:
    """Raise DMLCError when the ``tcp://`` store's port is still bound.

    Rank 0 serves the store in its own process, and torch's rendezvous
    reuses a store server of the same port that is still alive there: a
    reference to a destroyed group keeps its server, with the old group's
    keys (peer addresses of dead processes), and a new group over it
    never forms. Failing here names the cause at once."""
    address = coordinator.split("://", 1)[-1]
    if "://" in coordinator and not coordinator.startswith("tcp://"):
        return  # file:// and the like hold no server
    host, _, port = address.rpartition(":")
    with socket.socket() as probe:
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            probe.bind((host, int(port)))
        except OSError as err:
            if err.errno != errno.EADDRINUSE:
                return  # not an address of this host: nothing to learn
            raise DMLCError(
                f"re-init: the store port {address} is still bound ({err}); "
                "something still holds the old process group (a learner's "
                "step, a failure's traceback), so its store server and its "
                "keys live on") from err


def shutdown() -> None:
    """End the process group this module started (idempotent)."""
    global _initialized
    if _initialized:
        dist.destroy_process_group()
        _initialized = False


def abort() -> None:
    """End this module's group after a failure: NCCL's communicators are
    aborted (destroying them waits on the lost peer), gloo's group is
    destroyed."""
    global _initialized
    if not _initialized:
        return
    from torch.distributed import distributed_c10d as c10d

    _initialized = False
    if (dist.get_backend() == "nccl"
            and hasattr(c10d, "_abort_process_group")):
        c10d._abort_process_group()
    else:
        dist.destroy_process_group()


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

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

With a ``host:port`` / ``tcp://`` coordinator the module owns the store:
rank 0 serves one ``TCPStore`` for the life of its process, every other
rank opens a new client to it at each initialization, and each group
(a generation) rendezvouses under a prefix of its own
(``dmlc/g<N>/``), so a new group never reads the keys of an old one,
whoever still holds the old group. Rank 0 draws N from the store's
counter and publishes it; another rank takes the first published N
above the last generation it joined, which the store also records, so
a relaunched process, which remembers nothing, agrees with the
survivors. When rank 0 dies its store goes with it and the relaunched
rank 0 starts the count again on a fresh store.
"""

from __future__ import annotations

import datetime
import os
import time
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

# the store of a host:port / tcp:// job, kept across generations: rank
# 0's server, or another rank's client of the latest initialization
_store: Optional[dist.TCPStore] = None
_store_address: Optional[tuple] = None
# rank 0: the generation an attempt published whose group has not formed
# yet; a retry rendezvouses under it again
_pending_generation: Optional[int] = None
_GENERATION_KEY = "dmlc/generation"
_CURRENT_KEY = "dmlc/current"
_JOINED_KEY = "dmlc/joined/{}"


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
    timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)
    address = _tcp_address(coordinator)
    if address is None:  # file:// and the like: torch's own rendezvous
        dist.init_process_group(
            backend, init_method=coordinator, world_size=num_processes,
            rank=process_id, timeout=timeout)
    else:
        store, generation = _generation_store(address, process_id)
        dist.init_process_group(
            backend, store=dist.PrefixStore(f"dmlc/g{generation}/", store),
            world_size=num_processes, rank=process_id, timeout=timeout)
        _joined(store, process_id, generation)
    _initialized = True
    _setup = (backend, dev)
    return dev


def _tcp_address(coordinator: str) -> Optional[tuple]:
    """(host, port) of a ``host:port`` or ``tcp://host:port`` coordinator,
    None for another init method."""
    if "://" in coordinator:
        if not coordinator.startswith("tcp://"):
            return None
        coordinator = coordinator[len("tcp://"):]
    host, _, port = coordinator.rpartition(":")
    return host, int(port)


def _generation_store(address: tuple, rank: int) -> tuple:
    """(the store, the generation to rendezvous under) for this rank.

    Rank 0 keeps its server for the life of the process and publishes a
    new generation at each initialization (a retry after a failed attempt
    publishes none: it rendezvouses under the pending one). Another rank
    drops its old client, whose server may have died with rank 0, opens a
    new one (waiting for a relaunched rank 0 to serve), and waits for a
    published generation above the last one it joined."""
    global _store, _store_address, _pending_generation
    timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)
    host, port = address
    if rank == 0:
        if _store is None or _store_address != address:
            _store = dist.TCPStore(host, port, is_master=True,
                                   wait_for_workers=False, timeout=timeout)
            _store_address, _pending_generation = address, None
        if _pending_generation is None:
            _pending_generation = _store.add(_GENERATION_KEY, 1)
            _store.set(_CURRENT_KEY, str(_pending_generation))
        return _store, _pending_generation
    _store = None  # the old client goes before the new one dials
    _store = dist.TCPStore(host, port, is_master=False, timeout=timeout)
    _store_address = address
    joined_key = _JOINED_KEY.format(rank)
    last = int(_store.get(joined_key)) if _store.check([joined_key]) else 0
    deadline = time.monotonic() + PG_TIMEOUT_S
    while True:
        if _store.check([_CURRENT_KEY]):
            generation = int(_store.get(_CURRENT_KEY))
            if generation > last:
                return _store, generation
        if time.monotonic() > deadline:
            raise DMLCError(
                f"rank {rank}: no generation above {last} was published "
                f"on the store at {host}:{port} in {PG_TIMEOUT_S:.0f} s")
        time.sleep(0.01)


def _joined(store, rank: int, generation: int) -> None:
    """Record that this rank's group of ``generation`` formed: rank 0's
    next initialization publishes a new generation, and this rank (or its
    relaunch) waits for one above it."""
    global _pending_generation
    if rank == 0:
        _pending_generation = None
    else:
        store.set(_JOINED_KEY.format(rank), str(generation))


def initialize_from_env(force: bool = False, backend: Optional[str] = None,
                        device=None) -> bool:
    """:func:`initialize` from the DMLC_TPU_* env contract. Returns True
    when a multi-process group is up (started now or before), False when
    the env names a single process (no-op). ``force`` (the recovery path)
    aborts this module's group, which may have lost a peer, and starts a
    new one, a new generation on the store, with the backend and device
    this module started last unless they are given: also when an earlier
    forced attempt already aborted the group and then failed, so a
    retried re-init never switches backend on its own."""
    info = env_process_info()
    if info is None or info["num_processes"] <= 1:
        return False
    if _initialized and not force:
        return True
    if force:
        abort()
        if _setup is not None:
            backend = backend or _setup[0]
            device = device if device is not None else _setup[1]
    initialize(info["coordinator"], info["num_processes"],
               info["process_id"], backend=backend, device=device)
    return True


def shutdown() -> None:
    """End the process group this module started, and let its store go
    (idempotent)."""
    global _initialized, _store, _store_address, _pending_generation
    if _initialized:
        dist.destroy_process_group()
        _initialized = False
    _store = _store_address = _pending_generation = None


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

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
(optionally a file at any filesystem uri), and the job-snapshot plane of
``collective.checkpoint``
(``CheckpointManager``, ``JobSnapshot``) and ``collective.snapshot``
(``Snapshotter``, ``load_snapshot``).

Recovery: ``run_with_recovery(round_fn)`` is rabit's checkpoint replay.
A collective failure (a lost peer) re-enters the job through
``reinit_recover`` (the socket engine: tracker cmd='recover' with the same
rank; the device engine: a new ``torch.distributed`` group) and runs the
round again from the shared checkpoint. ``on_membership_change`` lets a
holder of device-placed state re-place it after every rebuild.

Elastic membership (socket engine only): with ``DMLC_TPU_ELASTIC`` set, a
collective failure re-enters the tracker's next generation
(``reenter_elastic``) instead, ``elastic_sync()`` polls for a pending
transition at a checkpoint boundary, and ``broadcast_state()`` ships the
model from rank 0 to new members. A process launched with
``DMLC_TPU_SPARE`` (the launcher's ``--spares`` tasks) parks in ``init()``
on the tracker's ``join`` until a transition calls it up, or exits 0
when the job finishes without it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, List, Optional

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
from dmlc_tpu_torch.resilience import (CONFIG_ERRORS, backoff_sleep,
                                       faultpoint)
from dmlc_tpu_torch.utils.logging import DMLCError, check, log_info

_engine = None
_engine_lock = threading.Lock()
# the rabit checkpoint: the newest blob and its version, in this process
_version = 0
_checkpoint_blob: Optional[bytes] = None
_membership_listeners: List[Callable[[], None]] = []
_release_listeners: List[Callable[[], None]] = []


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on")


def on_membership_change(fn: Callable[[], None]) -> Callable[[], None]:
    """Register ``fn()`` to run after every membership rebuild: elastic
    re-entry and fixed-world recovery (both engines). A learner holding
    device-placed params re-places them on the new group here. Listeners
    run outside the engine lock, after the new engine is up, in
    registration order; an exception propagates to the recovery caller
    (a half re-placed learner must not train on). Returns the callable
    that unregisters ``fn``."""
    return _register(_membership_listeners, fn)


def on_group_release(fn: Callable[[], None]) -> Callable[[], None]:
    """Register ``fn()`` to run when ``reinit_recover`` ends the device
    engine's process group, before it starts the new one: whoever holds
    the old group, or a step built over it, drops it here and takes the
    new default group at its next use. Returns the callable that
    unregisters ``fn``."""
    return _register(_release_listeners, fn)


def _register(listeners: List[Callable[[], None]],
              fn: Callable[[], None]) -> Callable[[], None]:
    listeners.append(fn)

    def _unregister() -> None:
        try:
            listeners.remove(fn)
        except ValueError:
            pass

    return _unregister


def _notify_membership() -> None:
    for fn in list(_membership_listeners):
        fn()


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


def _spare_wait(kwargs) -> dict:
    """A warm spare's start (``DMLC_TPU_SPARE``, set by the launcher's
    ``--spares`` tasks): park on the tracker's ``join`` until a membership
    transition activates this process, then return the engine arguments
    of a cmd='elastic' rendezvous into the new generation. When the job
    finishes without it, the process exits 0: never being needed is the
    clean outcome."""
    from dmlc_tpu_torch.tracker.rendezvous import SpareUnused, request_join

    uri = kwargs.get("tracker_uri") or os.environ.get("DMLC_TRACKER_URI")
    port = int(kwargs.get("tracker_port")
               or os.environ.get("DMLC_TRACKER_PORT", 0))
    jobid = kwargs.get("jobid") or os.environ.get("DMLC_TASK_ID", "NULL")
    try:
        generation = request_join(uri, port, jobid=jobid, spare=True)
    except SpareUnused:
        log_info("warm spare %s never activated; exiting clean", jobid)
        raise SystemExit(0)
    log_info("warm spare %s called up into generation %d", jobid,
             generation)
    return {"cmd": "elastic", "rank": -1, "world_size": -1}


def init(engine: str = "auto", **kwargs) -> None:
    """Start this process's engine (rabit.init); a no-op when one runs.
    ``kwargs`` go to the engine's constructor. A socket-engine process
    launched as a warm spare parks here first (``_spare_wait``). Also arms
    the crash flight recorder (obs/flight.py) when ``DMLC_TPU_FLIGHTREC``
    names a directory."""
    global _engine
    from dmlc_tpu_torch.obs import flight

    flight.install_if_armed()
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
            if _env_flag("DMLC_TPU_SPARE"):
                kwargs = dict(kwargs, **_spare_wait(kwargs))
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


def reinit_recover() -> None:
    """Re-enter the job after a collective failure.

    Socket engine: drops every peer link without telling the tracker,
    dials again with cmd='recover' keeping the rank, world, tracker
    address and jobid, and clears the in-process checkpoint blob, so that
    the next ``load_checkpoint(uri)`` reads the shared file: the one state
    every worker, a relaunched one too, agrees on.

    Device engine: aborts the engine, runs the ``on_group_release``
    listeners (the learners drop the old group and their steps), ends
    the ``torch.distributed`` group (NCCL's communicators aborted, gloo's
    group destroyed), starts a new default group from the launcher's
    DMLC_TPU_* env with the same backend and device
    (``initialize_from_env(force=True)``) and builds a new
    ``DeviceEngine`` over it. With a ``tcp://`` coordinator the store
    lives in rank 0's process: when rank 0 is the one that died, the
    survivors' new group waits (up to ``parallel.distributed.PG_TIMEOUT_S``)
    until the launcher's relaunched rank 0 serves a new store; when
    another rank died, the surviving rank 0 keeps serving its store and
    the new group rendezvouses under the next generation's prefix, so it
    never reads the old group's keys, whoever still holds the old group.
    Then every rank replays from the checkpoint. Over gloo (PyTorch 2.11, two ranks on one H100:
    ``chip_smoke.py`` phase 18 (d), rank 0 and then rank 1 crashing) both
    routes run in process: the lost peer surfaces at once as a closed
    connection (a DMLCError from the engine or ``bucketed_all_reduce``),
    destroying the broken group returns, and the survivor's new group
    completes when the relaunched rank joins. A watchdog ends a re-init that
    hangs past ``DMLC_TPU_RECOVER_TIMEOUT`` seconds (default 60) with exit
    code 41, so that the launcher's per-task loop relaunches this rank
    instead (fail-stop). Without the launcher env this raises DMLCError
    and leaves the engine and the checkpoint as they were.

    If the rendezvous itself fails, the aborted engine stays in place and
    fails fast with DMLCError, so a surrounding ``run_with_recovery``
    tries again. Listeners of ``on_membership_change`` run after it.
    """
    global _engine, _checkpoint_blob
    with _engine_lock:
        if isinstance(_engine, DeviceEngine):
            _reinit_device_engine()
        else:
            check(isinstance(_engine, SocketEngine),
                  "reinit_recover requires an active socket or device "
                  "engine")
            old = _engine
            old.abort()
            _checkpoint_blob = None
            _engine = SocketEngine(
                tracker_uri=old.tracker_uri, tracker_port=old.tracker_port,
                rank=old.rank, world_size=old.world_size, jobid=old.jobid,
                cmd="recover", connect_retry=old.connect_retry)
    _notify_membership()


def _reinit_device_engine() -> None:
    """The device half of reinit_recover (engine lock held)."""
    global _engine, _checkpoint_blob
    from dmlc_tpu_torch.parallel import distributed as _dist

    # checked before anything is torn down: an unrecoverable engine keeps
    # its engine and its checkpoint
    check(_dist.multiprocess_env(),
          "device-engine recover needs the DMLC_TPU_* launcher env "
          "(multi-process); a single-process job has nothing to recover")
    old = _engine
    old.abort()
    _checkpoint_blob = None
    for fn in list(_release_listeners):
        fn()
    timeout_s = float(os.environ.get("DMLC_TPU_RECOVER_TIMEOUT", 60))
    done = threading.Event()

    def _fail_stop() -> None:
        if not done.is_set():  # cancel() can lose the race; the flag can't
            log_info("device re-init hung for %.0f s; exiting 41 for the "
                     "launcher to relaunch this rank", timeout_s)
            os._exit(41)

    watchdog = threading.Timer(timeout_s, _fail_stop)
    watchdog.daemon = True
    watchdog.start()
    try:
        try:
            _dist.initialize_from_env(force=True)
            new_engine = DeviceEngine(device=old.device)
        except DMLCError:
            raise
        except (RuntimeError, ValueError) as err:
            # store and backend errors: the same try-again contract
            raise DMLCError(f"device re-rendezvous failed: {err}") from err
        _engine = new_engine
    finally:
        done.set()
        watchdog.cancel()


# ---- elastic membership (socket engine) ------------------------------------

_ELASTIC_TAG = "dmlc_elastic_state_v1"


def _encode_state(state: Any, version: int) -> np.ndarray:
    """(tag, version, state) through the serializer, as a uint8 array
    that ``broadcast`` carries: the JAX package's frame, byte for byte."""
    stream = MemoryStream()
    save_obj(stream, (_ELASTIC_TAG, int(version), state))
    return np.frombuffer(stream.getvalue(), dtype=np.uint8)


def _decode_state(blob: np.ndarray):
    """The inverse of ``_encode_state``: ``(version, state)``."""
    payload = load_obj(MemoryStream(
        np.asarray(blob, dtype=np.uint8).tobytes()))
    check(isinstance(payload, tuple) and len(payload) == 3
          and payload[0] == _ELASTIC_TAG,
          "broadcast_state payload is not an elastic state frame")
    return int(payload[1]), payload[2]


def broadcast_state(state: Any = None, root: int = 0) -> Any:
    """Ship model state and the checkpoint version from ``root`` to every
    rank: how a new member or a called-up spare gets the model from rank
    0. The other ranks take the root's ``version_number()``. Returns the
    state on every rank; the root's own copy goes through the serializer
    too, so every rank holds the same bits."""
    global _version
    eng = _get()
    check(eng.rank != root or state is not None,
          "broadcast_state root must supply state")
    if eng.world_size == 1:
        return state
    blob = _encode_state(state, _version) if eng.rank == root else None
    version, new_state = _decode_state(eng.broadcast(blob, root=root))
    _version = version
    return new_state


def reenter_elastic() -> int:
    """Abort the engine and rendezvous into the tracker's next membership
    generation (cmd='elastic'): survivors, grow joiners and called-up
    spares meet in one transition and get fresh ranks in a rebuilt world.
    The in-process checkpoint blob is cleared (rank 0 of the new world
    may be a new process: the shared checkpoint file or a
    ``broadcast_state`` is what every member agrees on). Returns the
    committed generation."""
    global _engine, _checkpoint_blob
    with _engine_lock:
        check(isinstance(_engine, SocketEngine),
              "elastic re-entry needs the socket engine (a "
              "torch.distributed world fixes its size at initialization)")
        old = _engine
        old.abort()
        _checkpoint_blob = None
        _engine = SocketEngine(
            tracker_uri=old.tracker_uri, tracker_port=old.tracker_port,
            rank=-1, world_size=-1, jobid=old.jobid, cmd="elastic",
            connect_retry=old.connect_retry)
        eng = _engine
    _notify_membership()
    from dmlc_tpu_torch.obs import flight

    flight.record_event("collective.elastic", generation=eng.generation,
                        rank=eng.rank, world=eng.world_size)
    log_info("elastic re-entry: generation %d, rank %d of %d",
             eng.generation, eng.rank, eng.world_size)
    return eng.generation


def elastic_sync(timeout: float = 10.0) -> bool:
    """A checkpoint boundary's membership poll: with ``DMLC_TPU_ELASTIC``
    set and the socket engine active, send one heartbeat and, when the
    tracker's target generation is ahead of the engine's, re-enter it
    (``reenter_elastic``) and return True. Otherwise False. A tracker
    before generations acks 0, which never re-enters."""
    from dmlc_tpu_torch.parallel import distributed as _dist
    from dmlc_tpu_torch.tracker.rendezvous import send_heartbeat

    eng = _engine
    if (not _env_flag("DMLC_TPU_ELASTIC")
            or not isinstance(eng, SocketEngine)
            or not _dist.elastic_capable()):
        return False
    try:
        acked = send_heartbeat(eng.tracker_uri, eng.tracker_port, eng.rank,
                               epoch=_version, timeout=timeout)
    except (OSError, ValueError):
        return False  # the liveness probe stays best-effort
    if acked <= eng.generation:
        return False
    log_info("membership transition pending (generation %d -> %d)",
             eng.generation, acked)
    reenter_elastic()
    return True


_DEFAULT_RECOVER_ON = (DMLCError, OSError)


def run_with_recovery(round_fn: Callable[[], Any], max_attempts: int = 3,
                      recover_on=_DEFAULT_RECOVER_ON):
    """rabit's checkpoint replay around one round of collective work.

    Runs ``round_fn()``; when a collective fails (a peer died: a socket
    error, or the DMLCError the engines raise), re-enters the job
    (``reinit_recover``, or ``reenter_elastic`` with ``DMLC_TPU_ELASTIC``
    on the socket engine) and runs ``round_fn`` again, up to
    ``max_attempts`` failures; the last one raises. ``round_fn`` must
    start from the checkpoint (``load_checkpoint(uri)``), its collectives
    must be deterministic (a rank that already finished the round
    replays it bit for bit) and every rank must run the same rounds.
    Filesystem-shaped errors (``FileNotFoundError``, ``PermissionError``
    ...) raise at once unless ``recover_on`` names them: a bad checkpoint
    URI is not a peer failure. A failed re-rendezvous sleeps with jitter
    (``resilience.backoff_sleep``) and the next round fails fast on the
    aborted engine, which brings the loop back here. The re-entry runs
    after the failure is dropped: its traceback's frames may hold the old
    process group."""
    attempt = 0
    while True:
        try:
            return round_fn()
        except recover_on as err:
            if recover_on is _DEFAULT_RECOVER_ON and isinstance(
                    err, CONFIG_ERRORS):
                raise
            attempt += 1
            with _engine_lock:
                elastic = False
                if isinstance(_engine, SocketEngine):
                    recoverable = True
                    elastic = _env_flag("DMLC_TPU_ELASTIC")
                elif isinstance(_engine, DeviceEngine):
                    from dmlc_tpu_torch.parallel.distributed import \
                        multiprocess_env

                    recoverable = multiprocess_env()
                else:
                    recoverable = False
            from dmlc_tpu_torch.obs import flight

            if not recoverable or attempt >= max_attempts:
                flight.record_event("collective.recover", attempt=attempt,
                                    outcome="giveup", error=str(err))
                flight.dump_if_injected(err)
                raise
            flight.record_event("collective.recover", attempt=attempt,
                                outcome="retry", error=str(err))
            log_info("collective failure (%s); recovering, attempt %d/%d",
                     err, attempt, max_attempts)
        try:
            if elastic:
                reenter_elastic()
            else:
                reinit_recover()
        except (DMLCError, OSError) as rerr:
            log_info("recover rendezvous failed (%s); will retry", rerr)
            backoff_sleep(attempt, "collective.recover", base_s=0.5)


__all__ = [
    "CheckpointManager", "DeviceEngine", "JobSnapshot", "SnapshotSuperseded",
    "Snapshotter", "SocketEngine", "allgather", "allreduce", "barrier",
    "broadcast", "broadcast_state", "bucketed_all_reduce", "checkpoint",
    "elastic_sync", "engine_kind", "finalize", "init", "load_checkpoint",
    "load_snapshot", "on_group_release", "on_membership_change", "rank",
    "reenter_elastic",
    "reinit_recover", "run_with_recovery", "tracker_print",
    "version_number", "world_size",
]

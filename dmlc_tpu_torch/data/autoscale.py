"""Backlog-driven worker autoscaling for the dispatcher's fleet (the port of
``dmlc_tpu/data/autoscale.py``).

Data workers are fungible (any worker parses any chunk), so the fleet can
grow and shrink with no data movement, and the dispatcher's backlog
(queued chunks nobody is parsing) is the demand signal:

- **Scale up** when the backlog exceeds ``backlog_per_worker`` a live
  worker: ``spawn()`` (the caller's; typically ``lambda:
  BlockService(dispatcher=disp.address, device=dev)``) starts a worker
  that registers itself like any other.
- **Scale down** by draining, never killing: the live worker with the
  fewest leases is handed to
  :meth:`~dmlc_tpu_torch.data.dispatcher.DataDispatcher.drain_worker`
  (the ``scale.drain`` faultpoint). It takes no new lease, its leases
  settle or expire, and its next idle poll is answered ``retire``, so a
  scale-down loses and duplicates no chunk. Once the dispatcher delists
  it, ``retire(handle)`` (default ``handle.close()``) frees the handle.
- **One worker a tick** either way, so a burst does not make the fleet
  oscillate.

``step()`` is one synchronous evaluation; ``start()`` runs it every
``DMLC_TPU_DATA_SCALE_INTERVAL_S`` seconds on a daemon thread. Telemetry:
the ``dmlc_dispatch_backlog_count`` gauge, the
``dmlc_dispatch_scale_events_total`` counter and the ``scale.up`` flight
event (the dispatcher records ``scale.down`` when the worker retires).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.obs.flight import record_event
from dmlc_tpu_torch.params.env import get_env
from dmlc_tpu_torch.utils.logging import check, log_warning


def data_scale_interval_s(explicit: Optional[float] = None) -> float:
    """Seconds between two control-loop ticks: ``explicit``, else
    ``DMLC_TPU_DATA_SCALE_INTERVAL_S``, else 1.0 (floor 0.05)."""
    if explicit is not None:
        return max(0.05, float(explicit))
    return max(0.05, float(get_env("DMLC_TPU_DATA_SCALE_INTERVAL_S", 1.0)))


class WorkerAutoscaler:
    """Size a dispatcher's worker fleet to its queued-chunk backlog."""

    def __init__(
        self,
        dispatcher,
        spawn: Callable[[], object],
        retire: Optional[Callable[[object], None]] = None,
        min_workers: int = 1,
        max_workers: int = 4,
        backlog_per_worker: int = 4,
        interval_s: Optional[float] = None,
    ):
        check(min_workers >= 0, "min_workers must be >= 0")
        check(max_workers >= max(1, min_workers),
              "max_workers must be >= max(1, min_workers)")
        check(backlog_per_worker >= 1, "backlog_per_worker must be >= 1")
        self.dispatcher = dispatcher
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.backlog_per_worker = int(backlog_per_worker)
        self.interval_s = data_scale_interval_s(interval_s)
        self._spawn = spawn
        self._retire = retire
        # worker id -> spawned handle; only workers THIS controller
        # spawned are retired through retire() — hand-started workers
        # can be drained but their lifecycle belongs to their starter
        self._handles: Dict[int, object] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = obs.registry()
        self._g_backlog = reg.gauge(
            "dmlc_dispatch_backlog_count",
            "queued chunks with no worker parsing them (the autoscaler's "
            "demand signal)")
        self._m_scale = reg.counter(
            "dmlc_dispatch_scale_events_total",
            "autoscaler actions taken (spawns + drains initiated)")

    def step(self) -> Dict[str, int]:
        """One control-loop evaluation: sample backlog, take at most one
        scaling action, reap retired workers. Returns the decision for
        tests/telemetry: ``{"backlog", "live", "want", "spawned",
        "draining"}``."""
        snap = self.dispatcher.snapshot()
        backlog = int(snap["chunks"]["queued"])
        self._g_backlog.set(backlog)
        live = {int(wid): w for wid, w in snap["workers"].items()
                if w.get("live")}
        with self._lock:
            for wid in [w for w in self._handles if w not in live]:
                # the dispatcher delisted it (drain completed, or it
                # died): reclaim the process-side handle
                handle = self._handles.pop(wid)
                try:
                    if self._retire is not None:
                        self._retire(handle)
                    else:
                        handle.close()
                except Exception as err:  # noqa: BLE001 — reap must go on
                    log_warning(
                        "autoscaler: retiring worker %d handle failed: %s",
                        wid, err)
        want = max(self.min_workers,
                   min(self.max_workers,
                       math.ceil(backlog / self.backlog_per_worker)))
        spawned = 0
        draining = len([w for w in live.values() if w.get("draining")])
        nlive = len(live)
        if want > nlive:
            handle = self._spawn()
            wid = int(getattr(handle, "_worker_id", -1))
            with self._lock:
                self._handles[wid] = handle
            record_event("scale.up", worker=wid, backlog=backlog,
                         live=nlive + 1)
            self._m_scale.inc()
            spawned = 1
        elif want < nlive - draining:
            # drain the least-loaded live worker; ties to the highest id
            # (the newest spawn retires first — hand-started seed
            # workers survive the autoscaler's churn longest)
            victim = max(
                (wid for wid, w in live.items() if not w.get("draining")),
                key=lambda wid: (-live[wid].get("leased", 0), wid),
                default=None)
            if victim is not None:
                try:
                    self.dispatcher.drain_worker(victim)
                except OSError as err:
                    # injected scale.drain fault: skip this tick, the
                    # backlog signal re-triggers the drain on the next
                    log_warning(
                        "autoscaler: drain of worker %d failed "
                        "(retrying next tick): %s", victim, err)
                else:
                    self._m_scale.inc()
                    draining += 1
        return {"backlog": backlog, "live": nlive, "want": want,
                "spawned": spawned, "draining": draining}

    def start(self) -> "WorkerAutoscaler":
        check(self._thread is None, "autoscaler already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="data-autoscaler")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as err:  # noqa: BLE001 — the controller is
                # advisory; a failed tick must not kill the loop
                log_warning("autoscaler tick failed: %s", err)

    def close(self, retire_spawned: bool = False) -> None:
        """Stop the control loop. With ``retire_spawned`` the handles
        this controller spawned are closed too (fleet teardown)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if retire_spawned:
            with self._lock:
                handles = list(self._handles.values())
                self._handles.clear()
            for handle in handles:
                try:
                    handle.close()
                except Exception:  # noqa: BLE001
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

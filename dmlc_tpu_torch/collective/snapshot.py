"""Async job snapshotting: capture on the step path, commit off it (the
port of ``dmlc_tpu/collective/snapshot.py``).

- :meth:`Snapshotter.capture` runs at an epoch boundary on the training
  thread: it makes a host copy of the state tree (``_to_host``: the copy
  the next epoch's in-place steps may not touch) and hands it to the
  writer. Its time is ``stats()["capture_ns"]`` and
  ``dmlc_snap_capture_ns`` (the goodput ledger's checkpoint stage).
- A writer thread serializes and two-phase-commits the snapshot
  (``stats()["write_ns"]``, ``dmlc_snap_write_ns``), off the step path.

The writer holds one *newest-wins* slot, not a queue: if epoch N's
snapshot is still waiting when N+1's capture lands, N+1 replaces it
(``stats()["skipped"]``), so a slow filesystem delays durability and
never builds a backlog. Versions are *epoch-derived* (the restored
version plus the epochs since), so every rank names one epoch's part with
one version, even when a skip hit one rank and not another.

Cadence: every ``every_epochs``-th epoch boundary commits, and
``every_s`` (default: the job's ``DMLC_TPU_SNAP_EVERY_S``, 0 = off)
promotes a boundary to a commit once that many seconds have passed since
the last. On a preemption notice, :meth:`Snapshotter.finalize` enqueues
the freshest capture and waits for the writer within the grace window.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.collective.checkpoint import JobSnapshot, _to_host
from dmlc_tpu_torch.resilience import preempt
from dmlc_tpu_torch.utils.logging import log_info, log_warning


class Snapshotter:
    """Background two-phase-commit writer over a :class:`JobSnapshot`.

    ``capture`` is the one call the training loop makes an epoch;
    ``finalize`` is the preemption path; ``close`` drains and stops the
    writer. Call them from the training thread only.
    """

    def __init__(self, snap: JobSnapshot, every_epochs: int = 1,
                 every_s: Optional[float] = None,
                 install_sigterm: bool = True):
        self._snap = snap
        # versions follow epochs from this base (re-based by mark_restored)
        self._version_base = snap.version_number
        self._epoch_base = -1
        self._every_epochs = max(0, int(every_epochs))
        if every_s is None:
            every_s = float(os.environ.get("DMLC_TPU_SNAP_EVERY_S", 0.0))
        self._every_s = max(0.0, float(every_s))
        self._stats: Dict[str, Any] = {"capture_ns": [], "write_ns": [],
                                       "commits": 0, "skipped": 0,
                                       "bytes": 0}
        reg = obs.registry()
        self._h_capture = reg.histogram(
            "dmlc_snap_capture_ns",
            "per-snapshot device->host state capture on the training "
            "thread (the goodput ledger's checkpoint stage)")
        self._h_write = reg.histogram(
            "dmlc_snap_write_ns",
            "per-snapshot serialize + two-phase commit on the writer "
            "thread (off the step path)")
        self._m_commits = reg.counter(
            "dmlc_snap_commits_total", "job snapshots committed")
        self._m_skipped = reg.counter(
            "dmlc_snap_skipped_total",
            "captured snapshots superseded before the writer started "
            "them (newest-wins slot)")
        self._m_bytes = reg.counter(
            "dmlc_snap_bytes_total",
            "serialized snapshot part bytes written by this rank")
        self._cond = threading.Condition()
        self._slot: Optional[Tuple[int, Any, Optional[Dict]]] = None
        self._pending: Optional[Tuple[int, Any, Optional[Dict]]] = None
        self._writing = False
        self._stop = False
        self._committed_epoch = -1
        self._last_commit_t = time.monotonic()
        self.last_error: Optional[BaseException] = None
        if install_sigterm:
            preempt.install()
        self._thread = threading.Thread(target=self._run,
                                        name="dmlc-snap-writer", daemon=True)
        self._thread.start()

    # ---- training-thread surface ---------------------------------------
    def capture(self, epoch: int, state: Union[Any, Callable[[], Any]],
                meta: Optional[Dict[str, Any]] = None,
                force: bool = False) -> bool:
        """Host-copy ``state`` (the tree, or a callable building it, run
        here on the training thread) at an epoch boundary; it becomes the
        freshest pending snapshot, which a later :meth:`finalize` commits
        even when the cadence skipped it. True when a commit was
        enqueued."""
        t0 = time.monotonic_ns()
        host = _to_host(state() if callable(state) else state)
        capture_ns = time.monotonic_ns() - t0
        self._h_capture.observe(capture_ns)
        with self._cond:
            self._stats["capture_ns"].append(capture_ns)
            self._pending = (epoch, host, meta)
            if force or self._due_locked(epoch):
                self._enqueue_locked()
                return True
        return False

    def finalize(self, deadline_s: Optional[float] = None) -> bool:
        """Just-in-time commit for a preemption notice: enqueue the
        freshest capture (unless that epoch is already committed) and wait
        for the writer, at most ``deadline_s`` (default: what is left of
        the grace window). True when everything captured is committed."""
        if deadline_s is None:
            deadline_s = preempt.deadline_remaining()
        with self._cond:
            if (self._pending is not None
                    and self._pending[0] > self._committed_epoch
                    and (self._slot is None
                         or self._slot[0] < self._pending[0])):
                self._enqueue_locked()
            drained = self._cond.wait_for(
                lambda: self._slot is None and not self._writing,
                timeout=max(0.0, deadline_s))
        if not drained:
            log_warning("snapshot finalize missed the %.1fs preemption "
                        "deadline; resume will use the last committed "
                        "version", deadline_s)
        return drained and self.last_error is None

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until the writer is idle."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._slot is None and not self._writing,
                timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Drain and stop the writer (the fit loop's ``finally``). Under a
        pending notice the drain gets only what is left of the grace
        window; a commit the daemon writer never finishes is a torn, and
        so ignored, version."""
        if preempt.requested():
            timeout = min(timeout, preempt.deadline_remaining())
        self.drain(timeout)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    def mark_restored(self, epoch: int) -> None:
        """After a resume: anchor the cadence and the epoch → version map
        at the restored (version, epoch), the same on every rank."""
        with self._cond:
            self._committed_epoch = epoch
            self._last_commit_t = time.monotonic()
            self._version_base = self._snap.version_number
            self._epoch_base = epoch

    @property
    def committed_epoch(self) -> int:
        with self._cond:
            return self._committed_epoch

    @property
    def version_number(self) -> int:
        """The newest committed version of the job snapshot."""
        return self._snap.version_number

    def stats(self) -> Dict[str, Any]:
        """Per-snapshot ``capture_ns`` (training thread) and ``write_ns``
        (writer thread) lists, and the ``commits``, ``skipped`` and part
        ``bytes`` counts."""
        with self._cond:
            return {k: list(v) if isinstance(v, list) else v
                    for k, v in self._stats.items()}

    # ---- internals -----------------------------------------------------
    def _due_locked(self, epoch: int) -> bool:
        if self._every_epochs > 0 and epoch % self._every_epochs == 0:
            return True
        return (self._every_s > 0
                and time.monotonic() - self._last_commit_t >= self._every_s)

    def _enqueue_locked(self) -> None:
        if self._slot is not None:
            self._stats["skipped"] += 1
            self._m_skipped.inc()
        self._slot = self._pending
        self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._slot is not None or self._stop)
                if self._slot is None:
                    return
                epoch, state, meta = self._slot
                self._slot = None
                self._writing = True
                version = self._version_base + (epoch - self._epoch_base)
            try:
                t0 = time.monotonic_ns()
                self._snap.commit(state, meta=dict(meta or {}, epoch=epoch),
                                  version=version)
                write_ns = time.monotonic_ns() - t0
                self._h_write.observe(write_ns)
                self._m_commits.inc()
                self._m_bytes.inc(self._snap.last_part_bytes)
                with self._cond:
                    self._stats["write_ns"].append(write_ns)
                    self._stats["commits"] += 1
                    self._stats["bytes"] += self._snap.last_part_bytes
                    self._committed_epoch = max(self._committed_epoch, epoch)
                    self._last_commit_t = time.monotonic()
                    self.last_error = None
            except Exception as err:  # the writer thread lives on
                self.last_error = err
                log_warning("job snapshot commit failed (epoch %d): %s",
                            epoch, err)
            finally:
                with self._cond:
                    self._writing = False
                    self._cond.notify_all()


def load_snapshot(snap: JobSnapshot):
    """Restore the newest committed snapshot and re-arm the audit:
    ``(version, state, meta)``, ``(0, None, {})`` when none is committed.
    A state tree carrying an ``audit`` section (exported digest-chain
    state, of either package) is re-injected into the process auditor, so
    the resumed run's chains extend the interrupted run's; a
    ``resume.verified`` flight event records the resume."""
    t0 = time.monotonic_ns()
    version, state, meta = snap.restore()
    obs.registry().histogram(
        "dmlc_snap_restore_ns",
        "manifest + part read and state restore on resume",
    ).observe(time.monotonic_ns() - t0)
    if not version or state is None:
        return version, state, meta
    audit_restored = False
    audit_state = state.get("audit") if isinstance(state, dict) else None
    if audit_state:
        from dmlc_tpu_torch.obs.audit import auditor

        audit_restored = auditor().restore_state(audit_state)
    from dmlc_tpu_torch.obs import flight

    flight.record_event("resume.verified", version=version,
                        epoch=(meta or {}).get("epoch", -1),
                        audit=audit_restored)
    log_info("resumed from job snapshot v%d (epoch %s, audit %s)", version,
             (meta or {}).get("epoch", "?"),
             "re-armed" if audit_restored else "fresh")
    return version, state, meta

"""Preemption notices: SIGTERM-with-deadline made survivable (the port of
``dmlc_tpu/resilience/preempt.py``).

A preempted host gets a SIGTERM and a grace window, then a hard kill.
This module turns that into a cooperative protocol:

- :func:`install` registers a SIGTERM handler (main thread only,
  idempotent) that records a *preemption notice* instead of dying;
- the training loop calls :func:`poll` between steps; once a notice is
  pending it stops, asks its ``collective.snapshot.Snapshotter`` to
  finalize the freshest epoch-boundary snapshot within
  :func:`deadline_s` seconds, and raises :class:`Preempted`;
- :class:`Preempted` is a ``SystemExit`` with :data:`EXIT_PREEMPTED`
  (75, ``EX_TEMPFAIL``): left uncaught it exits the process with that
  code, which a launcher reads as "relaunch me with resume".

:func:`poll` also passes the ``preempt.notice`` faultpoint, so
``DMLC_TPU_FAULTS="preempt.notice:nth=K"`` (or
``faults.configure``) turns the K-th poll into a notice without a signal.
The grace window is ``install``'s ``deadline_s`` or the job's
``DMLC_TPU_PREEMPT_DEADLINE_S`` setting (default 30 s). Notices are
counted in :func:`stats` and ``dmlc_preempt_notices_total``, and each
leaves a ``preempt.notice`` flight event. A flight recorder installed
after this handler chains to it (obs/flight.py).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional

from dmlc_tpu_torch.resilience.faults import InjectedFault, faultpoint
from dmlc_tpu_torch.utils.logging import log_info

#: Exit code of a process preempted after a committed snapshot: relaunch
#: it (sysexits EX_TEMPFAIL), distinct from a crash's codes.
EXIT_PREEMPTED = 75


class Preempted(SystemExit):
    """Raised by the training loop after the just-in-time snapshot; a
    ``SystemExit`` whose code is :data:`EXIT_PREEMPTED`."""

    def __init__(self, message: str = "preempted"):
        super().__init__(EXIT_PREEMPTED)
        self.message = message


_lock = threading.Lock()
_requested = threading.Event()
_notice_at: Optional[float] = None
_deadline_s: Optional[float] = None
_installed = False
_prev_handler = None
_notices = 0


def install(deadline_s: Optional[float] = None) -> bool:
    """Arm the SIGTERM handler; True when installed. Only the main thread
    may set signal handlers: elsewhere this returns False (the faultpoint
    in :func:`poll` still works). A second call only updates the
    deadline. The handler does not chain to an earlier one: a notice
    means "snapshot and exit 75", which supersedes dump-and-die handlers."""
    global _installed, _prev_handler, _deadline_s
    with _lock:
        if deadline_s is not None:
            _deadline_s = deadline_s
        if _installed:
            return True
        try:
            _prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not the main thread
            return False
        _installed = True
        return True


def uninstall() -> None:
    """Restore the SIGTERM disposition from before :func:`install`."""
    global _installed, _prev_handler
    with _lock:
        if not _installed:
            return
        try:
            signal.signal(signal.SIGTERM, _prev_handler or signal.SIG_DFL)
        except ValueError:
            pass
        _installed = False
        _prev_handler = None


def _on_sigterm(signum, frame) -> None:
    notice("sigterm")


def notice(source: str) -> None:
    """Record a preemption notice (the signal handler or an injected
    fault); a second notice changes nothing."""
    global _notice_at, _notices
    if _requested.is_set():
        return
    _notice_at = time.monotonic()
    _notices += 1
    _requested.set()
    # signal-safe enough: counters are a lock-and-add, and the flight
    # recorder appends to a deque
    from dmlc_tpu_torch import obs
    from dmlc_tpu_torch.obs import flight

    obs.registry().counter(
        "dmlc_preempt_notices_total",
        "preemption notices received (SIGTERM or injected)",
    ).inc()
    flight.record_event("preempt.notice", source=source,
                        deadline_s=deadline_s())
    log_info("preemption notice (%s): snapshot deadline %.1fs", source,
             deadline_s())


def poll() -> bool:
    """True once a notice is pending (call between steps). Each poll also
    passes the ``preempt.notice`` faultpoint: a fired one is a notice."""
    if _requested.is_set():
        return True
    try:
        faultpoint("preempt.notice")
    except InjectedFault:
        notice("injected")
        return True
    return False


def requested() -> bool:
    return _requested.is_set()


def deadline_s() -> float:
    """The grace window: :func:`install`'s, else
    ``DMLC_TPU_PREEMPT_DEADLINE_S`` (default 30)."""
    if _deadline_s is not None:
        return _deadline_s
    return max(0.0, float(os.environ.get("DMLC_TPU_PREEMPT_DEADLINE_S",
                                         30.0)))


def deadline_remaining() -> float:
    """Seconds left of the grace window (all of it when no notice)."""
    if _notice_at is None:
        return deadline_s()
    return max(0.0, deadline_s() - (time.monotonic() - _notice_at))


def reset() -> None:
    """Clear the notice (tests); the signal handler stays."""
    global _notice_at
    with _lock:
        _requested.clear()
        _notice_at = None


def stats() -> Dict[str, object]:
    """Notices received in this process, and whether one is pending."""
    return {"notices": _notices, "requested": _requested.is_set(),
            "installed": _installed}

"""Crash flight recorder: a bounded ring of recent telemetry, dumped on death
(the port of ``dmlc_tpu/obs/flight.py``: the same event kinds and
``flightrec-rank<k>.json`` layout).

Post-mortem debugging of a distributed job usually starts from a stack
trace and a prayer; the information that actually explains the crash —
what the process was *doing* in the seconds before — lived in metrics
and spans that died with it. This module keeps that tail alive: a
fixed-size ring of recent span completions, metric deltas, and
resilience events, written to ``<dir>/flightrec-rank<k>.json`` when the
process dies badly.

Armed by ``DMLC_TPU_FLIGHTREC=<dir>`` (empty = off, the default —
:func:`recorder` then returns the shared :data:`NOOP_RECORDER`, so every
hook below is one empty method call, the ``DMLC_TPU_METRICS=0``
convention). Ring capacity comes from ``DMLC_TPU_FLIGHTREC_CAP``
(default 256 records, floor 16).

Sources feeding the ring:

- **spans** — via an ``obs.trace`` listener (installed by
  :meth:`FlightRecorder.install`), so recording works without a
  ``DMLC_TPU_TRACE`` file;
- **metric deltas** — :meth:`note_metrics` records which flat metrics
  moved since the last call (``export_epoch``'s publish path feeds it);
- **resilience events** — :func:`record_event` calls planted at the
  fault-injection fire path, retry give-up, collective recovery,
  membership changes, and checkpoint fallback (kinds cataloged in
  docs/observability.md).

Dump triggers: an uncaught exception (chained ``sys.excepthook``),
SIGTERM (handler installed only in the main thread; after the dump it
chains to the previous handler — ``resilience.preempt``'s notice when
that was installed first — or re-raises the default disposition so kill
semantics survive), and
explicitly from the retry layer on an ``InjectedFault`` give-up
(:func:`dump_if_injected`). Dumps are atomic (tmp + ``os.replace``) and
deliberately tiny — the ring, not a core file.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import sys
import threading
import time
from typing import Deque, Dict, Optional

from dmlc_tpu_torch.obs import trace
from dmlc_tpu_torch.obs.metrics import Registry, registry
from dmlc_tpu_torch.params.env import get_env

logger = logging.getLogger("dmlc_tpu_torch.obs.flight")


def flightrec_dir() -> str:
    """Crash flight-recorder dump directory (``DMLC_TPU_FLIGHTREC``;
    empty = recorder off, the default)."""
    return get_env("DMLC_TPU_FLIGHTREC", "")


def flightrec_capacity() -> int:
    """Flight-recorder ring capacity in records
    (``DMLC_TPU_FLIGHTREC_CAP``, default 256, floor 16)."""
    return max(16, get_env("DMLC_TPU_FLIGHTREC_CAP", 256))


class FlightRecorder:
    """Bounded in-memory ring of recent telemetry with an atomic dump."""

    def __init__(self, out_dir: str, capacity: Optional[int] = None,
                 rank: Optional[int] = None):
        self.out_dir = out_dir
        self.capacity = capacity if capacity else flightrec_capacity()
        if rank is None:
            rank = int(os.environ.get("DMLC_TASK_ID", "0") or 0)
        self.rank = rank
        self._lock = threading.Lock()
        self._ring: Deque[Dict] = collections.deque(maxlen=self.capacity)
        self._last_flat: Dict[str, float] = {}
        self._installed = False
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._dumped_reason: Optional[str] = None

    # ---- feeds ---------------------------------------------------------
    def note(self, kind: str, **fields) -> None:
        entry = {"t_unix_ns": time.time_ns(), "kind": kind}
        entry.update(fields)
        with self._lock:
            self._ring.append(entry)

    def note_span(self, event: Dict) -> None:
        if event.get("ph") not in (None, "X"):
            return  # flow markers ride the trace, not the crash ring
        fields = dict(name=event.get("name"), ts=event.get("ts"),
                      dur=event.get("dur"), tid=event.get("tid"))
        args = event.get("args")
        if isinstance(args, dict) and args.get("flow"):
            # which chunk was in flight when the process died
            fields["flow"] = args["flow"]
        self.note("span", **fields)

    def note_metrics(self, reg: Optional[Registry] = None) -> None:
        """Record which flat metrics moved since the last call (deltas
        only — the ring is too small for full snapshots)."""
        flat = (reg or registry()).flat_values()
        with self._lock:
            delta = {
                k: v - self._last_flat.get(k, 0.0)
                for k, v in flat.items() if v != self._last_flat.get(k, 0.0)
            }
            self._last_flat = flat
        if delta:
            self.note("metrics", delta=delta)

    # ---- dump ----------------------------------------------------------
    def path(self) -> str:
        return os.path.join(self.out_dir, "flightrec-rank%d.json" % self.rank)

    def dump(self, reason: str = "manual") -> Optional[str]:
        """Write the ring to ``flightrec-rank<k>.json`` atomically.

        Re-entrant-safe and duplicate-tolerant (an excepthook firing
        during SIGTERM teardown must not clobber the first dump with a
        shorter one): only the first reason wins."""
        with self._lock:
            if self._dumped_reason is not None:
                return self.path()
            self._dumped_reason = reason
            records = list(self._ring)
        payload = {
            "rank": self.rank,
            "reason": reason,
            "dumped_unix_ns": time.time_ns(),
            "anchor_unix_ns": trace.anchor_unix_ns(),
            "capacity": self.capacity,
            "records": records,
        }
        path = self.path()
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, path)
        except OSError as err:
            logger.warning("flight-recorder dump to %s failed: %s", path, err)
            return None
        logger.warning("flight recorder dumped %d records to %s (%s)",
                       len(records), path, reason)
        return path

    # ---- trigger installation -----------------------------------------
    def _on_sigterm(self, signum, frame):
        self.dump("sigterm")
        # restore whatever was there and re-deliver, preserving the
        # process's kill semantics (exit status, parent's waitpid view)
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    def _on_uncaught(self, exc_type, exc, tb):
        self.note("uncaught", error=exc_type.__name__, message=str(exc))
        self.dump("uncaught:%s" % exc_type.__name__)
        hook = self._prev_excepthook or sys.__excepthook__
        hook(exc_type, exc, tb)

    def install(self) -> None:
        """Attach the span listener, excepthook chain, and (from the main
        thread only) the SIGTERM handler. Idempotent."""
        if self._installed:
            return
        self._installed = True
        trace.add_listener(self.note_span)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_uncaught
        try:
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, self._on_sigterm)
        except ValueError:
            self._prev_sigterm = None  # not the main thread; skip SIGTERM

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        trace.remove_listener(self.note_span)
        # bound-method equality, not identity: each attribute access
        # builds a fresh method object
        if sys.excepthook == self._on_uncaught:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass

    def records(self):
        with self._lock:
            return list(self._ring)


class _NoopRecorder:
    """Shared disabled recorder (``DMLC_TPU_FLIGHTREC`` unset): every
    hook in the tree lands here as one empty method call."""

    __slots__ = ()

    def note(self, kind, **fields):
        pass

    def note_span(self, event):
        pass

    def note_metrics(self, reg=None):
        pass

    def dump(self, reason="manual"):
        return None

    def install(self):
        pass

    def uninstall(self):
        pass

    def records(self):
        return []


NOOP_RECORDER = _NoopRecorder()

_LOCK = threading.Lock()
_RECORDER = NOOP_RECORDER
_INIT = False


def recorder():
    """The process recorder: a live :class:`FlightRecorder` when
    ``DMLC_TPU_FLIGHTREC`` names a directory, else :data:`NOOP_RECORDER`.
    Resolved once; :func:`reset` re-reads the env (tests)."""
    global _RECORDER, _INIT
    if _INIT:
        return _RECORDER
    with _LOCK:
        if not _INIT:
            out_dir = flightrec_dir()
            if out_dir:
                _RECORDER = FlightRecorder(out_dir)
            _INIT = True
    return _RECORDER


def install_if_armed() -> bool:
    """Resolve the recorder and install its triggers when armed — the
    one call planted at process entry points (``collective.init``)."""
    rec = recorder()
    rec.install()
    return rec is not NOOP_RECORDER


def record_event(kind: str, **fields) -> None:
    """Append one resilience event to the ring (no-op when disarmed).

    ``kind`` must be a dotted literal at the call site — the faultpoint
    lint collects and cross-checks them against docs/observability.md."""
    recorder().note(kind, **fields)


def dump_if_injected(err: BaseException) -> Optional[str]:
    """Dump the ring when a give-up was caused by an injected fault —
    the hook a fault-injection test reads the recorder through."""
    from dmlc_tpu_torch.resilience.faults import InjectedFault

    cause = err
    while cause is not None:
        if isinstance(cause, InjectedFault):
            return recorder().dump("injected_giveup")
        cause = cause.__cause__
    return None


def configure(out_dir: str, capacity: Optional[int] = None,
              rank: Optional[int] = None,
              install: bool = True) -> FlightRecorder:
    """Explicitly (re)build the process recorder — tests and embedders
    that cannot use the env knob."""
    global _RECORDER, _INIT
    with _LOCK:
        if isinstance(_RECORDER, FlightRecorder):
            _RECORDER.uninstall()
        rec = FlightRecorder(out_dir, capacity=capacity, rank=rank)
        _RECORDER = rec
        _INIT = True
    if install:
        rec.install()
    return rec


def reset() -> None:
    """Tear down the process recorder and forget the cached env read."""
    global _RECORDER, _INIT
    with _LOCK:
        if isinstance(_RECORDER, FlightRecorder):
            _RECORDER.uninstall()
        _RECORDER = NOOP_RECORDER
        _INIT = False

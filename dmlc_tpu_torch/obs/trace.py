"""Span tracer: Chrome trace-event JSON (Perfetto-loadable) pipeline spans,
the port of ``dmlc_tpu/obs/trace.py`` (the same events, fields and
metadata).

``span("parse", chunk=i)`` is a context manager that records one complete
("ph": "X") trace event — name, start, duration, thread — into an
in-process buffer; ``flush()`` (and an atexit hook) writes the buffer to
the path named by ``DMLC_TPU_TRACE`` as ``{"traceEvents": [...]}``, the
format both chrome://tracing and https://ui.perfetto.dev open directly.

Tracing is OFF unless ``DMLC_TPU_TRACE`` is set, a listener is
registered or a ``torch.profiler`` capture runs: ``span()`` then returns
a shared no-op context manager (two empty method calls per span). The
env var is re-read per ``span()`` call — one dict lookup, then the
profiler's flag — so tests and long-lived processes can turn tracing
on/off without re-imports.

Timestamps are µs since a ``time.monotonic_ns()`` epoch taken at import,
with the wall clock at that instant (``anchor_unix_ns``) in the trace
``metadata`` block, so an NTP step mid-job cannot fold the timeline and
consumers that need absolute time recover it as ``anchor_unix_ns +
ts·1000``. Span durations are measured by
:class:`dmlc_tpu_torch.utils.timer.Timer`.

Each live span also enters a profiler range under its name (the
reference enters a ``jax.profiler`` annotation), so the spans line up
with the CUDA kernels in a ``torch.profiler`` capture
(``obs.device_telemetry.capture_profile``, the status plane's
``/profile``). The range is torch's ``_RecordFunctionFast``: a host
range alone, where ``record_function``'s user annotation would also be
copied onto the device's track, stretched over the kernels it launched,
and counted there as device time. A capture running in the process arms
``span()`` too: with no trace file and no listener, a span is then that
range alone (no event, no buffer, no listener call), so a capture names
the program's stages beside the kernels.

Device spans: ``device_span("fm.scatter", device)`` is a span that, when
armed (the same gate), also records a pair of timing CUDA events on the
device's current stream, on entry and on exit (host-clock marks on the
CPU, where operations run synchronously). :func:`resolve_device_spans`
converts each pair whose end has completed, with no synchronize, into
per-name totals (:func:`device_span_totals`, reset by :func:`clear`) and,
with a trace file, into ``device_ms`` in the span event's args. A pair's
time is the stream's between its two events, idle gaps included. At most
:data:`DEVICE_SPAN_CAP` pairs wait; a span that finds them all unfinished
is a plain span, with no pair.

Listeners: :func:`add_listener` registers a callback invoked with each
completed span event. While any listener is registered, spans are
recorded even without ``DMLC_TPU_TRACE`` (the flight recorder attaches
this way), but the in-process buffer only grows when a trace *file* is
configured, so a listener alone cannot leak memory.

Flow events: ``new_flow()`` allocates a job-unique flow id and
``flow_start/flow_step/flow_end`` emit Chrome-trace flow events
(``"ph": "s"/"t"/"f"``) that Perfetto renders as arrows connecting the
enclosing duration slices — across threads, and across ranks once
per-worker traces are merged (the id embeds the rank). A flow point binds
to the ``"ph": "X"`` slice open on the same pid/tid at its timestamp, so
emit flow points *inside* the span of the stage they mark. When tracing
is off, ``new_flow()`` returns 0 and every flow call is an
early-returning no-op — zero allocations on the hot path.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from dmlc_tpu_torch.utils.timer import Timer

_lock = threading.Lock()
_events: List[Dict] = []
_listeners: List[Callable[[Dict], None]] = []
_atexit_registered = False
# one-shot anchor pair: span ts are µs since _EPOCH_MONO_NS (NTP-immune);
# _ANCHOR_UNIX_NS is the wall clock at that same instant, published in the
# trace metadata so merged/absolute timelines can be reconstructed
_EPOCH_MONO_NS = time.monotonic_ns()
_ANCHOR_UNIX_NS = time.time_ns()

_PID = os.getpid()
# its _is_profiler_enabled flag is True while a torch.profiler capture runs
_profiler = torch.autograd.profiler
# a host-side profiler range (no copy on the device's track)
_range = torch._C._profiler._RecordFunctionFast

#: device-span pairs that may wait for resolution: a span that finds the
#: list full resolves it, and is a plain span if the stream has finished
#: none of them
DEVICE_SPAN_CAP = 65536
_pending: List[tuple] = []  # (name, start mark, end mark, event or None)
_device_totals: Dict[str, List[float]] = {}  # name -> [count, ms]


def _now_us() -> float:
    return (time.monotonic_ns() - _EPOCH_MONO_NS) / 1e3


def anchor_unix_ns() -> int:
    """Wall-clock ns at the trace epoch (span ``ts`` zero point)."""
    return _ANCHOR_UNIX_NS


class _NoopSpan:
    """Shared disabled span: stateless, safe to reuse concurrently."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("name", "args", "event", "_timer", "_ts", "_annot")

    def __init__(self, name: str, args: Dict):
        self.name = name
        self.args = args
        self.event: Optional[Dict] = None  # set on exit
        self._timer = Timer()
        self._ts = 0.0
        self._annot = _range(name)

    def __enter__(self):
        self._annot.__enter__()
        self._ts = _now_us()
        self._timer.__enter__()
        return self

    def __exit__(self, *exc):
        self._timer.__exit__(*exc)
        self._annot.__exit__(*exc)
        event = {
            "name": self.name,
            "ph": "X",
            "ts": self._ts,
            "dur": self._timer.elapsed * 1e6,
            "pid": _PID,
            "tid": threading.get_ident(),
        }
        if self.args:
            event["args"] = self.args
        self.event = event
        # the buffer backs the DMLC_TPU_TRACE file; listeners keep their
        # own (bounded) state, and device spans wait in a list of at most
        # DEVICE_SPAN_CAP pairs, so listener-only tracing cannot leak
        if _active_path() is not None:
            with _lock:
                _events.append(event)
        for fn in list(_listeners):
            try:
                fn(event)
            except Exception:
                pass  # telemetry consumers must never break the traced code
        return False


def _active_path() -> Optional[str]:
    # raw os.environ read: this sits on the per-batch path and must not
    # pay the typed-parse layer for the common "unset" case
    return os.environ.get("DMLC_TPU_TRACE") or None


def _ensure_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(flush)


def add_listener(fn: Callable[[Dict], None]) -> None:
    """Register ``fn(event)`` to be called with every completed span.

    Registering a listener also arms span recording (``span()`` returns a
    live span while any listener exists, trace file or not)."""
    with _lock:
        if fn not in _listeners:
            _listeners.append(fn)


def remove_listener(fn: Callable[[Dict], None]) -> None:
    with _lock:
        try:
            _listeners.remove(fn)
        except ValueError:
            pass


def span(name: str, **args):
    """Context manager timing one pipeline stage as a named trace span.

    No-op (a shared inert object) unless ``DMLC_TPU_TRACE`` names an
    output file, a listener is registered or a ``torch.profiler`` capture
    runs (alone, the capture gets a bare profiler range).
    Keyword args become the event's ``args`` payload — keep them small
    and JSON-serializable (chunk/batch indices)."""
    if _active_path() is None and not _listeners:
        if _profiler._is_profiler_enabled:
            return _range(name)
        return NOOP_SPAN
    _ensure_atexit()
    return _Span(name, args)


def step_span(step_num: int, name: str = "step", **args):
    """Like :func:`span` with the step number in ``args`` — for fit-loop
    epochs (the reference's step annotation; here a
    profiler range under the span's name)."""
    if _active_path() is None and not _listeners:
        if _profiler._is_profiler_enabled:
            return _range(name)
        return NOOP_SPAN
    _ensure_atexit()
    return _Span(name, dict(args, step=step_num))


# ---- Device spans (the stream's time between two events) ----------------
class _HostMark:
    """A host-clock stand-in for a CUDA event: on the CPU operations run
    synchronously, so a device span's time is its host duration."""

    __slots__ = ("ns",)

    def __init__(self):
        self.ns = time.perf_counter_ns()

    def query(self) -> bool:
        return True

    def elapsed_time(self, end: "_HostMark") -> float:
        return (end.ns - self.ns) / 1e6


def _mark(stream):
    if stream is None:
        return _HostMark()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _DeviceSpan:
    __slots__ = ("name", "_inner", "_stream", "_start")

    def __init__(self, name: str, inner, stream):
        self.name = name
        self._inner = inner
        self._stream = stream
        self._start = None

    def __enter__(self):
        self._inner.__enter__()
        self._start = _mark(self._stream)
        return self

    def __exit__(self, *exc):
        end = _mark(self._stream)
        self._inner.__exit__(*exc)
        event = getattr(self._inner, "event", None)
        with _lock:
            _pending.append((self.name, self._start, end, event))
        return False


def device_span(name: str, device=None, **args):
    """Like :func:`span`, and when armed also a pair of timing CUDA events
    on ``device``'s current stream, on entry and on exit (None: the
    current device's, once CUDA is initialized; a CPU device: host-clock
    marks). The pair waits for :func:`resolve_device_spans`; with
    :data:`DEVICE_SPAN_CAP` pairs waiting it resolves them first, and is
    the plain span if they all still wait. Disarmed it is the shared
    no-op."""
    if _active_path() is None and not _listeners:
        if not _profiler._is_profiler_enabled:
            return NOOP_SPAN
        inner = _range(name)
    else:
        _ensure_atexit()
        inner = _Span(name, args)
    if (len(_pending) >= DEVICE_SPAN_CAP
            and resolve_device_spans() >= DEVICE_SPAN_CAP):
        return inner
    if device is None:
        on_card = torch.cuda.is_initialized()
    else:
        device = torch.device(device)
        on_card = device.type == "cuda"
    stream = torch.cuda.current_stream(device) if on_card else None
    return _DeviceSpan(name, inner, stream)


def resolve_device_spans() -> int:
    """Convert every waiting device-span pair whose end event has
    completed (``query()``, never a synchronize) into its name's totals,
    and with a trace file into ``device_ms`` in its event's args; pairs
    not finished keep waiting. Returns how many wait."""
    global _pending
    with _lock:
        pending, _pending = _pending, []
    done, left = [], []
    for item in pending:
        (done if item[2].query() else left).append(item)
    with _lock:
        _pending[:0] = left
        for name, start, end, event in done:
            ms = start.elapsed_time(end)
            total = _device_totals.setdefault(name, [0, 0.0])
            total[0] += 1
            total[1] += ms
            if event is not None:
                event["args"] = dict(event.get("args") or {}, device_ms=ms)
        return len(_pending)


def device_span_totals() -> Dict[str, Dict]:
    """{name: {"count", "ms"}} over the device-span pairs resolved since
    the last :func:`clear`."""
    with _lock:
        return {name: {"count": int(c), "ms": ms}
                for name, (c, ms) in _device_totals.items()}


# ---- Flow events (causal dataflow arrows) -------------------------------
# Chrome trace flow events match globally on (cat, id): a chunk's id must
# be unique across every process whose trace lands in one merged trace.
# Layout: (rank+1) in the high bits | pid salt | per-process counter. The
# pid salt keeps colocated rank-0 processes (tests, local launcher) from
# colliding; the counter wraps at 2^24 flows, far past any one job.
_FLOW_CAT = "dataflow"
_FLOW_IDS = itertools.count(1)
_FLOW_BASE: Optional[int] = None
_FLOW_TLS = threading.local()


def _flow_base() -> int:
    global _FLOW_BASE
    if _FLOW_BASE is None:
        try:
            rank = int(os.environ.get("DMLC_TASK_ID") or 0)
        except ValueError:
            rank = 0
        _FLOW_BASE = (((rank & 0x3FFFFF) + 1) << 40) | (
            (_PID & 0xFFFF) << 24
        )
    return _FLOW_BASE


def new_flow() -> int:
    """Allocate a flow id, or 0 when tracing is disarmed.

    0 is the "no flow" sentinel every flow call early-returns on, so the
    disabled path allocates nothing — callers can thread the result
    unconditionally."""
    if _active_path() is None and not _listeners:
        return 0
    return _flow_base() | (next(_FLOW_IDS) & 0xFFFFFF)


def _flow_event(fid: int, ph: str, name: str) -> None:
    event = {
        "name": name,
        "cat": _FLOW_CAT,
        "ph": ph,
        "id": fid,
        "ts": _now_us(),
        "pid": _PID,
        "tid": threading.get_ident(),
    }
    if ph == "f":
        # bind the arrow head to the enclosing slice rather than the
        # next slice on the thread ("binding point: enclosing")
        event["bp"] = "e"
    if _active_path() is not None:
        _ensure_atexit()
        with _lock:
            _events.append(event)
    for fn in list(_listeners):
        try:
            fn(event)
        except Exception:
            pass  # telemetry consumers must never break the traced code


def flow_start(fid: int, name: str = "flow") -> None:
    """Emit the ``"s"`` (start) point of flow ``fid``. No-op when ``fid``
    is 0 or tracing is disarmed. Call inside the span of the producing
    stage so the arrow tail attaches to that slice."""
    if not fid or (_active_path() is None and not _listeners):
        return
    _flow_event(fid, "s", name)


def flow_step(fid: int, name: str = "flow") -> None:
    """Emit a ``"t"`` (step) point: the flow passed through the enclosing
    stage. No-op when ``fid`` is 0 or tracing is disarmed."""
    if not fid or (_active_path() is None and not _listeners):
        return
    _flow_event(fid, "t", name)


def flow_end(fid: int, name: str = "flow") -> None:
    """Emit the ``"f"`` (finish) point terminating flow ``fid`` (with
    ``"bp": "e"`` so the head binds to the enclosing slice)."""
    if not fid or (_active_path() is None and not _listeners):
        return
    _flow_event(fid, "f", name)


def set_current_flow(fid: int) -> None:
    """Stash ``fid`` as this thread's ambient flow. DeviceFeed sets it
    around the consume yield so fit-loop code (collective op spans,
    train_step) can mark the in-flight chunk without plumbing ids."""
    _FLOW_TLS.fid = fid


def current_flow() -> int:
    """This thread's ambient flow id (0 when none is set)."""
    return getattr(_FLOW_TLS, "fid", 0)


def events() -> List[Dict]:
    """Copy of the buffered trace events (ordered by span *completion*)."""
    with _lock:
        return list(_events)


def clear() -> None:
    """Empty the event buffer and the device spans' pairs and totals."""
    with _lock:
        _events.clear()
        _pending.clear()
        _device_totals.clear()


def metadata() -> Dict:
    """The trace-file metadata block (clock anchor + process identity)."""
    return {
        "clock": "monotonic_ns",
        "anchor_unix_ns": _ANCHOR_UNIX_NS,
        "pid": _PID,
    }


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write all buffered events to ``path`` (default: ``DMLC_TPU_TRACE``)
    as a Chrome trace JSON object. Returns the path written, or None when
    there is no destination. The buffer is kept: repeated flushes rewrite
    the file with the complete history (the file is always loadable)."""
    path = path or _active_path()
    if path is None:
        return None
    with _lock:
        payload = {
            "traceEvents": list(_events),
            "displayTimeUnit": "ms",
            "metadata": metadata(),
        }
    # dumps, not dump: its C encoder runs without yielding to another
    # thread, so resolve_device_spans cannot add an event's args mid-write
    text = json.dumps(payload)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)
    return path

"""Device telemetry: the one-shape-per-bucket sentinel, device-memory
accounting, H2D metering and profiler capture (the port of
``dmlc_tpu/obs/device_telemetry.py``, on the same metric names).

- ``instrumented_step(fn, name)`` — the counterpart of the reference's
  ``instrumented_jit``. Nothing is jitted in eager PyTorch, so a "compile"
  is a call at a bucket signature (argument shapes and dtypes) the site
  has not seen: it counts ``dmlc_xla_compiles_total{fn=}``, times that
  call into ``dmlc_xla_compile_ns{fn=}``, and runs it through
  obs/xla_cost.py, which records its costs once per (site, signature).
  After :data:`DEFAULT_WARMUP_CALLS` calls a new signature is the anomaly
  — ``dmlc_xla_recompiles_total``, an ``xla.recompile`` flight event and a
  warning: the invariant the reference guards (one shape per bucket),
  which here means caching-allocator growth and new kernel scratch
  instead of a retrace.
- ``sample()`` — per-device memory gauges from the CUDA caching allocator:
  ``dmlc_device_hbm_bytes{device=}`` (``memory_stats``'
  ``allocated_bytes.all.current``), ``dmlc_device_hbm_limit_bytes``
  (``mem_get_info``'s total) and ``dmlc_device_live_bytes`` (the
  allocator's census of live tensor bytes). The CPU reports no device
  gauges. On a CUDA device no error from these reads is caught.
- ``h2d_meter()`` — byte/bandwidth accounting of the feed's
  ``non_blocking`` copies and the device engine's staging
  (``dmlc_feed_h2d_bytes_total``, ``dmlc_feed_h2d_mbps``).
- ``capture_profile(seconds)`` — ``torch.profiler`` for a window in a
  background thread, writing a Chrome trace beside the flight-recorder
  dump.

Settings: ``DMLC_TPU_DEVICE_TELEMETRY`` (default 1; 0 makes
``instrumented_step`` return ``fn`` itself and ``h2d_meter`` None) and
``DMLC_TPU_HBM_POLL_S`` (default 0; > 0 starts a daemon thread sampling
device memory every that many seconds).
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from dmlc_tpu_torch.obs import flight, xla_cost
from dmlc_tpu_torch.obs.metrics import Registry, registry
from dmlc_tpu_torch.params.env import get_env

logger = logging.getLogger("dmlc_tpu_torch.obs.device")

__all__ = [
    "DEFAULT_WARMUP_CALLS",
    "InstrumentedStep",
    "instrumented_step",
    "compile_counts",
    "H2DMeter",
    "h2d_meter",
    "sample",
    "peak_hbm_bytes",
    "maybe_start_hbm_poller",
    "capture_profile",
    "detail_section",
    "reset",
]

#: Calls before a new signature stops being "expected warmup" and becomes
#: an anomaly. A fit's buckets all show up in its first few batches; a new
#: one after this many calls means an unbucketed shape leaked in.
DEFAULT_WARMUP_CALLS = 32


def device_telemetry_enabled() -> bool:
    """Whether the device telemetry layer is live
    (``DMLC_TPU_DEVICE_TELEMETRY``, default on). Read once where each
    surface is built, never per call."""
    return get_env("DMLC_TPU_DEVICE_TELEMETRY", True)


def hbm_poll_s() -> float:
    """Background device-memory sampler period in seconds
    (``DMLC_TPU_HBM_POLL_S``; 0 = no poller thread, the default)."""
    return max(0.0, float(get_env("DMLC_TPU_HBM_POLL_S", 0.0)))


class InstrumentedStep:
    """A step function with a per-signature "compile" counter and a
    post-warmup new-signature alarm.

    Each call computes the cheap signature key of its arguments
    (``xla_cost.signature_key``); a key the site has not seen is a compile:
    that call runs through ``xla_cost.note_compile`` (its costs recorded,
    its wall time into the compile histogram), and past ``warmup_calls``
    calls it also fires the anomaly path. A seen key is a plain call
    (inside a composite site's recording, it adds its record there).
    ``composite``: the body is made of instrumented sites, so its record
    is theirs summed (obs/xla_cost.py)."""

    __slots__ = (
        "fn",
        "fn_name",
        "warmup_calls",
        "composite",
        "compiles",
        "calls",
        "_seen",
        "_reg",
        "_m_compiles",
        "_m_recompiles",
        "_h_compile_ns",
        "__wrapped__",
    )

    def __init__(self, fn: Callable, name: str,
                 warmup_calls: int = DEFAULT_WARMUP_CALLS,
                 reg: Optional[Registry] = None, composite: bool = False):
        reg = reg if reg is not None else registry()
        self.fn = fn
        self.__wrapped__ = fn
        self._reg = reg
        self.fn_name = name
        self.warmup_calls = int(warmup_calls)
        self.composite = composite
        self.compiles = 0
        self.calls = 0
        self._seen = {}  # signature key -> its cost record (None: metrics off)
        self._m_compiles = reg.counter(
            "dmlc_xla_compiles_total",
            "new bucket signatures (argument shapes/dtypes) per "
            "instrumented step",
            fn=name,
        )
        self._m_recompiles = reg.counter(
            "dmlc_xla_recompiles_total",
            "post-warmup new-signature anomalies per instrumented step",
            fn=name,
        )
        self._h_compile_ns = reg.histogram(
            "dmlc_xla_compile_ns",
            "wall time of the first call at each new signature (its cost "
            "recording included)",
            fn=name,
        )

    def __call__(self, *args, **kwargs):
        key = xla_cost.signature_key(args, kwargs)
        self.calls += 1
        if key in self._seen:
            if xla_cost._ACTIVE:
                return xla_cost.note_call(self._seen[key], self.fn, args,
                                          kwargs)
            return self.fn(*args, **kwargs)
        self.compiles += 1
        self._m_compiles.inc()
        t0 = time.monotonic_ns()
        out, self._seen[key] = xla_cost.note_compile(
            self.fn_name, self.fn, args, kwargs, reg=self._reg,
            composite=self.composite)
        self._h_compile_ns.observe(time.monotonic_ns() - t0)
        if self.calls > self.warmup_calls:
            self._m_recompiles.inc()
            flight.record_event(
                "xla.recompile",
                fn=self.fn_name,
                compiles=self.compiles,
                calls=self.calls,
            )
            logger.warning(
                "recompile anomaly: %s met signature #%d at call %d "
                "(warmup window %d) — an unbucketed shape or dtype reached "
                "the step",
                self.fn_name,
                self.compiles,
                self.calls,
                self.warmup_calls,
            )
        return out

    def __repr__(self) -> str:
        return "InstrumentedStep(%s, compiles=%d, calls=%d)" % (
            self.fn_name,
            self.compiles,
            self.calls,
        )


def instrumented_step(fn: Callable, name: str,
                      warmup_calls: int = DEFAULT_WARMUP_CALLS,
                      composite: bool = False):
    """``fn`` with the per-signature sentinel attached (``composite``: see
    :class:`InstrumentedStep`).

    With ``DMLC_TPU_DEVICE_TELEMETRY=0`` this returns ``fn`` itself — no
    wrapper object, no per-call branch. The setting is read once, here."""
    if not device_telemetry_enabled():
        return fn
    return InstrumentedStep(fn, name, warmup_calls=warmup_calls,
                            composite=composite)


_FLAT_FN_RE = re.compile(r'^dmlc_xla_compiles_total\{.*?fn="((?:[^"\\]|\\.)*)"')


def compile_counts(reg: Optional[Registry] = None) -> Dict[str, int]:
    """Per-site compile totals read back from the registry, keyed by the
    ``fn=`` label."""
    reg = reg if reg is not None else registry()
    out: Dict[str, int] = {}
    for flat, value in reg.flat_values().items():
        m = _FLAT_FN_RE.match(flat)
        if m:
            out[m.group(1).replace('\\"', '"').replace("\\\\", "\\")] = \
                int(value)
    return out


class H2DMeter:
    """Byte/bandwidth accounting for one feed's host→device copies."""

    __slots__ = ("_m_bytes", "_h_mbps")

    def __init__(self, reg: Optional[Registry] = None, **labels: str):
        reg = reg if reg is not None else registry()
        self._m_bytes = reg.counter(
            "dmlc_feed_h2d_bytes_total",
            "host->device payload bytes submitted through non_blocking "
            "copies",
            **labels,
        )
        self._h_mbps = reg.histogram(
            "dmlc_feed_h2d_mbps",
            "per-batch H2D submission bandwidth, MB/s (bytes over the wall "
            "time of the submitting call; asynchronous copies overstate "
            "sustained bandwidth — read it as submission rate)",
            **labels,
        )

    def note(self, nbytes: int, elapsed_ns: int) -> None:
        if nbytes <= 0:
            return
        self._m_bytes.inc(nbytes)
        if elapsed_ns > 0:
            # bytes/ns → MB/s: x * 1e9 / 1e6 = x * 1e3
            self._h_mbps.observe(nbytes * 1e3 / elapsed_ns)


def h2d_meter(reg: Optional[Registry] = None,
              **labels: str) -> Optional[H2DMeter]:
    """An :class:`H2DMeter`, or ``None`` when device telemetry is off
    (callers keep the ``None`` and skip metering: no timing, no byte
    walk)."""
    if not device_telemetry_enabled():
        return None
    return H2DMeter(reg, **labels)


_state_lock = threading.Lock()
_peak_hbm = 0
_poller_started = False


def _cuda_devices():
    """The cards this process uses: the current one and any whose caching
    allocator holds memory (reading another card would open a context on
    it)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    cur = torch.cuda.current_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())
            if i == cur or torch.cuda.memory_reserved(i) > 0]


def sample(reg: Optional[Registry] = None) -> Dict[str, Dict[str, int]]:
    """Refresh the per-device memory gauges; returns ``{"hbm": {...},
    "live": {...}}`` keyed ``cuda:<i>``.

    ``hbm`` is the allocator's ``allocated_bytes.all.current`` →
    ``dmlc_device_hbm_bytes{device=}``, the card's total memory →
    ``dmlc_device_hbm_limit_bytes{device=}``; ``live`` the allocator's
    census of live tensor bytes (its active blocks) →
    ``dmlc_device_live_bytes{device=}``. The CPU reports neither: both
    dicts stay empty. Errors of these reads on a CUDA device propagate."""
    if not device_telemetry_enabled():
        return {"hbm": {}, "live": {}}
    reg = reg if reg is not None else registry()
    hbm: Dict[str, int] = {}
    live: Dict[str, int] = {}
    for dev in _cuda_devices():
        label = "cuda:%d" % dev.index
        stats = torch.cuda.memory_stats(dev)
        used = int(stats.get("allocated_bytes.all.current", 0))
        reg.gauge(
            "dmlc_device_hbm_bytes",
            "device memory in use per device (caching allocator "
            "allocated_bytes.all.current)",
            device=label,
        ).set(used)
        hbm[label] = used
        _free, total = torch.cuda.mem_get_info(dev)
        reg.gauge(
            "dmlc_device_hbm_limit_bytes",
            "device memory capacity per device (cuda mem_get_info total)",
            device=label,
        ).set(int(total))
        census = int(stats.get("active_bytes.all.current", 0))
        reg.gauge(
            "dmlc_device_live_bytes",
            "live tensor bytes per device (the caching allocator's active "
            "blocks)",
            device=label,
        ).set(census)
        live[label] = census
    global _peak_hbm
    peak_now = max(hbm.values(), default=0)
    with _state_lock:
        if peak_now > _peak_hbm:
            _peak_hbm = peak_now
    return {"hbm": hbm, "live": live}


def peak_hbm_bytes() -> int:
    """High-water mark of device memory in use across every ``sample()``
    so far (this process); 0 on the CPU."""
    with _state_lock:
        return _peak_hbm


def maybe_start_hbm_poller() -> bool:
    """Start the background memory sampler once, if
    ``DMLC_TPU_HBM_POLL_S`` > 0. Returns True when a poller is (already)
    running. The default 0 means no thread at all."""
    period = hbm_poll_s()
    if period <= 0 or not device_telemetry_enabled():
        return False
    global _poller_started
    with _state_lock:
        if _poller_started:
            return True
        _poller_started = True

    def _loop():
        while True:
            time.sleep(period)
            sample()

    threading.Thread(target=_loop, daemon=True, name="dmlc-hbm-poll").start()
    logger.info("hbm poller started (every %.1fs)", period)
    return True


_capture_lock = threading.Lock()
_capturing = False
_profiler_ready = False


def _init_profiler_here() -> None:
    """Start the profiler's tracing library on the calling thread, once a
    process: the library initializes its PyTorch client only on the
    thread that registered it (the one that imported torch), so a first
    profile in the capture thread would record no CUDA activity."""
    global _profiler_ready
    if _profiler_ready:
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        pass
    _profiler_ready = True


def _artifact_dir() -> str:
    """Where capture artifacts land: beside the flight-recorder dump when
    the recorder is armed, else the working directory."""
    rec = flight.recorder()
    path = rec.path() if hasattr(rec, "path") else None
    if path:
        return os.path.dirname(path) or "."
    return "."


class _Capture(threading.Thread):
    """The capture thread. ``ready`` is set once its profiler runs (or it
    failed before that); an error on a machine with a card is kept and
    raised by :meth:`join`."""

    def __init__(self, target):
        super().__init__(target=target, daemon=True,
                         name="dmlc-profile-capture")
        self.ready = threading.Event()
        self.error: Optional[BaseException] = None

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self.error is not None and not self.is_alive():
            err, self.error = self.error, None
            raise err


def capture_profile(
    seconds: float,
    out_dir: Optional[str] = None,
    req_id: int = 0,
    block: bool = False,
) -> Optional[threading.Thread]:
    """Run ``torch.profiler`` (CPU and, when there is a card, CUDA
    activities) for ``seconds`` in a background thread and write its
    Chrome trace to ``profile-rank<k>-req<n>/trace.json`` beside the
    flight-recorder dump. Returns once the profiler runs, so the caller's
    next operations are in the window. The first capture of a process
    starts the profiler's library on the calling thread first (it records
    the card's activity only when started where torch registered it). One
    capture at a time: an overlapping request is dropped (returns None).
    Always records a ``profile.capture`` flight event on completion.
    Without a card a failed capture is logged; with one it is raised, here
    if the profiler did not start, else by the thread's ``join``.
    ``block=True`` joins the thread."""
    global _capturing
    with _capture_lock:
        if _capturing:
            logger.warning("profile capture already running; dropping req %d",
                           req_id)
            return None
        _capturing = True

    try:
        _init_profiler_here()
    except BaseException:
        with _capture_lock:
            _capturing = False
        raise
    rank = 0
    try:
        rank = int(os.environ.get("DMLC_TASK_ID", "0") or 0)
    except ValueError:
        pass
    base = out_dir if out_dir is not None else _artifact_dir()
    target = os.path.join(base, "profile-rank%d-req%d" % (rank, req_id))
    seconds = max(0.0, float(seconds))
    on_card = torch.cuda.is_available()

    def _run():
        global _capturing
        ok = False
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if on_card:
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(target, exist_ok=True)
            with profile(activities=activities) as prof:
                th.ready.set()
                time.sleep(seconds)
            prof.export_chrome_trace(os.path.join(target, "trace.json"))
            ok = True
        except Exception as err:  # noqa: BLE001 - best-effort off the card
            if on_card:
                th.error = err
            else:
                logger.warning("profile capture failed: %s", err)
        finally:
            th.ready.set()
            with _capture_lock:
                _capturing = False
            flight.record_event(
                "profile.capture",
                seconds=seconds,
                dir=target,
                req=req_id,
                ok=ok,
            )
            registry().counter(
                "dmlc_device_profile_captures_total",
                "on-demand profiler capture attempts (see ok field of the "
                "profile.capture flight event for failures)",
            ).inc()
            if ok:
                logger.info("profile capture done: %.1fs -> %s (req %d)",
                            seconds, target, req_id)

    th = _Capture(_run)
    th.start()
    th.ready.wait()
    if block or th.error is not None:
        th.join()
    return th


def detail_section(reg: Optional[Registry] = None) -> Dict[str, Any]:
    """Compile counts per site, the process-lifetime peak device memory,
    and the mean H2D submission bandwidth — the keys obs/sentry.py gates
    (``compiles.<fn>`` and ``hbm.peak_bytes`` lower-better, ``h2d_mbps``
    higher-better)."""
    reg = reg if reg is not None else registry()
    sample(reg)
    out: Dict[str, Any] = {"compiles": compile_counts(reg)}
    peak = peak_hbm_bytes()
    if peak > 0:
        out["peak_hbm_bytes"] = peak
    h2d_sum = 0.0
    h2d_count = 0.0
    for flat, value in reg.flat_values().items():
        if flat.startswith("dmlc_feed_h2d_mbps"):
            if flat.endswith(":sum"):
                h2d_sum += value
            elif flat.endswith(":count"):
                h2d_count += value
    if h2d_count > 0:
        out["h2d_mbps"] = round(h2d_sum / h2d_count, 1)
    return out


def reset() -> None:
    """Forget process-level state (tests): peak memory, poller/capture
    flags, and the cost-record cache."""
    global _peak_hbm, _poller_started, _capturing
    with _state_lock:
        _peak_hbm = 0
        _poller_started = False
    with _capture_lock:
        _capturing = False
    xla_cost.reset()

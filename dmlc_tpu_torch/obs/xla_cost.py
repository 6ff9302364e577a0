"""Per-site step cost records: FLOPs, bytes accessed, peak memory and
collective bytes of one instrumented call (the counterpart of
``dmlc_tpu/obs/xla_cost.py``).

The reference reads these off the compiled XLA executable of each jit
site. Eager PyTorch has no compiled program, so the port measures the
site's *first call at each bucket signature* instead — and never a later
step. The module keeps the reference's name, record fields, ``dmlc_xla_*``
gauges and :func:`bucket_signature` string, so the reference's reports
and docs/observability.md read the port's output as they read the
reference's.

:func:`note_compile` runs the call under :class:`_CostMode`, a
``TorchDispatchMode`` that passes every aten op through unchanged and
adds:

- ``flops`` — ``torch.utils.flop_counter``'s formula for the op (matmuls
  and the like; elementwise ops count 0 there, as in FlopCounterMode);
- ``bytes_accessed`` — the bytes of the op's tensor operands and outputs,
  XLA's "bytes accessed" definition without XLA's fusion.

The hand-written kernels are ctypes calls the mode cannot see, so each
wrapper in ``ops/kernels.py`` is :func:`costed`: inside a recording it
adds its own count (the formulas of PERF.md's kernel bounds) and hides
its own torch ops from the mode, on the card and on the CPU alike, so
the two routes record the same numbers.

- ``peak_bytes`` — the most device memory allocated after any op of the
  call, above what was allocated before it; where the call raised the
  process's high-water mark, ``max_memory_allocated`` above that base
  (which also sees an op's own scratch). The peak statistics are read,
  never reset: they belong to the caller. 0 on the CPU;
- ``collective_bytes`` — the bytes ``bucketed_all_reduce``,
  ``parallel.axis.all_to_all`` / ``ppermute`` and the device engine's
  reduction move in the call (:func:`note_collective`).

A *composite* site (``gbdt.forest``: a loop over the ``gbdt.grad``,
``gbdt.build_tree`` and ``gbdt.margin_update`` sites) runs outside the
mode: its record is the sum of the records of the site calls it makes,
each call adding its site's record at its signature, so a forest of 20
trees pays one recorded tree, not 20 under the mode.

Records are cached per (site, signature): a signature recorded once is
never measured again (:func:`extraction_count` pins it), so steady-state
training pays one dict lookup a call in the sentinel. Under
``DMLC_TPU_METRICS=0`` the hook returns immediately.

:func:`probed_peak_flops` / :func:`probed_hbm_gbps` measure the device's
ceilings once a process, best of 3: on the card a 4096² f32 matmul with
TF32 off (``utils.device.strict_f32``) and an elementwise pass over
1 GiB in place, timed with CUDA events — sizes the card sustains, past
its launch floor and its L2; on the CPU the reference's 256² matmul and
32 MiB pass.
On the card the probes allocate from a private memory pool, released
when they end: the caching allocator keeps none of their bytes. A failed
probe on the card raises.
"""

from __future__ import annotations

import functools
import logging
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from dmlc_tpu_torch.obs.metrics import Registry, metrics_enabled, registry

logger = logging.getLogger("dmlc_tpu_torch.obs.xla_cost")

__all__ = [
    "bucket_signature",
    "costed",
    "note_collective",
    "note_compile",
    "note_call",
    "extraction_count",
    "records",
    "per_fn",
    "sites_from_flat",
    "step_costs",
    "detail_section",
    "probed_peak_flops",
    "probed_hbm_gbps",
    "reset",
]

_lock = threading.Lock()
# (fn, bucket signature) -> record; insertion-ordered, so per_fn() keeps
# the LATEST bucket per site while counting all of them
_records: Dict[Tuple[str, str], Dict[str, Any]] = {}
_extractions = 0

#: the gauge fields every record carries (and the flat-metric parser reads)
FIELDS = ("flops", "bytes_accessed", "peak_bytes", "collective_bytes")

# the recording in progress on this thread (None outside note_compile)
_tls = threading.local()
# recordings in progress on any thread: the one global read a costed
# kernel wrapper pays outside a recording
_ACTIVE = 0


def _leaves(tree, out: Optional[List[Any]] = None) -> List[Any]:
    """The leaves of an argument tree in jax's order: tuples and lists in
    order, dicts by sorted key, None an empty node. (A module function,
    not a recursive closure: such a closure is a reference cycle that
    would hold every call's argument tensors until the cyclic collector
    runs.)"""
    out = [] if out is None else out
    if tree is None:
        return out
    if isinstance(tree, (tuple, list)):
        for y in tree:
            _leaves(y, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        out.append(tree)
    return out


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def bucket_signature(args: tuple, kwargs: Optional[dict] = None) -> str:
    """Shape/dtype signature of one call's argument tree, the reference's
    string (``float32[16384,28];...``). Non-tensor leaves contribute their
    type name only."""
    parts: List[str] = []
    for leaf in _leaves((args, kwargs or {})):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            parts.append(type(leaf).__name__)
        else:
            parts.append("%s[%s]" % (_dtype_name(dtype),
                                     ",".join(str(d) for d in shape)))
    return ";".join(parts)


def signature_key(args: tuple, kwargs: Optional[dict] = None) -> tuple:
    """A cheap hashable twin of :func:`bucket_signature` (no string
    building): the per-call key of the recompile sentinel."""
    key = []
    for leaf in _leaves((args, kwargs or {})):
        if isinstance(leaf, torch.Tensor):
            key.append((leaf.shape, leaf.dtype))
        else:
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            key.append(type(leaf) if shape is None or dtype is None
                       else (tuple(shape), str(dtype)))
    return tuple(key)


def _allocated(dev: torch.device) -> int:
    # the allocator's counter without memory_stats' Python flattening
    return torch.cuda.memory_stats_as_nested_dict(dev)[
        "allocated_bytes"]["all"]["current"]


class _Cost:
    """One recording's running sums and its device-memory high-water mark
    above ``base`` (per device, what was allocated when it started). A
    composite recording is opaque throughout: only the records of its
    site calls add to it (:meth:`add`)."""

    __slots__ = ("flops", "bytes", "collective_bytes", "opaque",
                 "composite", "base", "peak")

    def __init__(self, devs: List[torch.device], composite: bool = False):
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes = 0.0
        self.opaque = 1 if composite else 0
        self.composite = composite
        self.base = {dev: _allocated(dev) for dev in devs}
        self.peak = 0

    def offset(self) -> int:
        """Bytes allocated now above ``base`` (the most over devices)."""
        return max((_allocated(dev) - base for dev, base in
                    self.base.items()), default=0)

    def add(self, rec: Dict[str, Any], start: int) -> None:
        """Add one site call's record; ``start`` is :meth:`offset` when
        that call began."""
        self.flops += rec["flops"]
        self.bytes += rec["bytes_accessed"]
        self.collective_bytes += rec["collective_bytes"]
        self.peak = max(self.peak, start + int(rec["peak_bytes"]))


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _flop_registry() -> dict:
    from torch.utils import flop_counter

    return flop_counter.flop_registry


class _CostMode(TorchDispatchMode):
    """Pass every aten op through unchanged; add its flops (the
    flop_counter formula) and operand + output bytes to ``cost``, except
    inside a costed kernel wrapper (``cost.opaque``)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # never compiled: no dynamo-disable wrapper around the dispatch,
        # whose first call would import torch._dynamo (seconds, paid by a
        # process's first recorded step)
        return False

    def __init__(self, cost: _Cost):
        super().__init__()
        self.cost = cost
        self.flops = _flop_registry()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cost = self.cost
        if cost.base:
            # the op's outputs are allocated and its inputs still held
            cost.peak = max(cost.peak, cost.offset())
        if cost.opaque:
            return out
        formula = self.flops.get(func.overloadpacket)
        if formula is not None:
            cost.flops += float(formula(*args, **kwargs, out_val=out))
        cost.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def costed(cost_fn):
    """Decorate a kernel wrapper: inside a recording on this thread, add
    ``cost_fn(*args, **kwargs)`` = (flops, bytes) to it and hide the
    wrapper's own torch ops from :class:`_CostMode`. Outside a recording
    the wrapper runs as it is after one global read."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            cost = getattr(_tls, "cost", None)
            if cost is None:
                return fn(*args, **kwargs)
            if not cost.opaque:
                flops, nbytes = cost_fn(*args, **kwargs)
                cost.flops += float(flops)
                cost.bytes += float(nbytes)
            cost.opaque += 1
            try:
                return fn(*args, **kwargs)
            finally:
                cost.opaque -= 1

        return inner

    return wrap


def note_collective(nbytes: int) -> None:
    """Add the bytes one collective moves to this thread's recording (a
    no-op outside one)."""
    if not _ACTIVE:
        return
    cost = getattr(_tls, "cost", None)
    if cost is not None and not cost.opaque:
        cost.collective_bytes += float(nbytes)


def _devices(args, kwargs) -> List[torch.device]:
    seen = []
    for leaf in _leaves((args, kwargs)):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda" \
                and leaf.device not in seen:
            seen.append(leaf.device)
    return seen


def run_recorded(fn, args: tuple, kwargs: dict, composite: bool = False):
    """Call ``fn(*args, **kwargs)`` once, recorded: under the cost mode,
    or for a composite site outside it, summing its site calls' records;
    returns (output, {flops, bytes_accessed, peak_bytes,
    collective_bytes})."""
    global _ACTIVE
    devs = _devices(args, kwargs)
    cost = _Cost(devs, composite)
    high = {dev: torch.cuda.max_memory_allocated(dev) for dev in devs}
    prev = getattr(_tls, "cost", None)
    _tls.cost = cost
    with _lock:
        _ACTIVE += 1
    try:
        if composite:
            out = fn(*args, **kwargs)
        else:
            with _CostMode(cost):
                out = fn(*args, **kwargs)
    finally:
        _tls.cost = prev
        with _lock:
            _ACTIVE -= 1
    peak = cost.peak
    for dev in devs:
        now = torch.cuda.max_memory_allocated(dev)
        if now > high[dev]:
            # the call set the process's high-water mark: exact, and it
            # counts the scratch an op frees before it returns
            peak = max(peak, now - cost.base[dev])
    return out, {"flops": cost.flops, "bytes_accessed": cost.bytes,
                 "peak_bytes": float(max(0, peak)),
                 "collective_bytes": cost.collective_bytes}


def _composite() -> Optional[_Cost]:
    """The composite recording in progress on this thread, or None."""
    cost = getattr(_tls, "cost", None)
    return cost if cost is not None and cost.composite else None


def note_call(rec: Optional[Dict[str, Any]], fn, args: tuple,
              kwargs: dict):
    """Run one call of a site at a signature it has met (its record
    ``rec``); inside a composite recording, add ``rec`` to it."""
    outer = _composite() if _ACTIVE else None
    if outer is not None and rec is not None:
        outer.add(rec, outer.offset())
    return fn(*args, **kwargs)


def _set_gauges(fn_name: str, rec: Dict[str, Any],
                reg: Optional[Registry] = None) -> None:
    reg = reg if reg is not None else registry()
    reg.gauge(
        "dmlc_xla_flops",
        "per-call FLOPs of the latest recorded bucket per instrumented "
        "site (flop_counter formulas + the kernels' own counts)",
        fn=fn_name,
    ).set(float(rec.get("flops", 0.0)))
    reg.gauge(
        "dmlc_xla_bytes_accessed",
        "per-call memory traffic of the latest recorded bucket per "
        "instrumented site (operand + output bytes of every op)",
        fn=fn_name,
    ).set(float(rec.get("bytes_accessed", 0.0)))
    reg.gauge(
        "dmlc_xla_peak_bytes",
        "peak device bytes allocated over the site's first call at its "
        "bucket, above what was allocated before it",
        fn=fn_name,
    ).set(float(rec.get("peak_bytes", 0.0)))
    reg.gauge(
        "dmlc_xla_collective_bytes",
        "per-call bytes moved by the collectives of one instrumented call",
        fn=fn_name,
    ).set(float(rec.get("collective_bytes", 0.0)))


def note_compile(fn_name: str, fn, args: tuple,
                 kwargs: Optional[dict] = None,
                 reg: Optional[Registry] = None, composite: bool = False):
    """Run one call of ``fn`` and record its costs once per (site,
    signature); the sentinel's first-call hook. Returns ``(output,
    record)``: a signature already recorded runs the call plainly, points
    the site's gauges at its cached record and returns it; with metrics
    off the call runs plainly and the record is None. ``composite``: the
    site's body is made of instrumented sites (module docstring)."""
    kwargs = kwargs or {}
    if not metrics_enabled():
        return fn(*args, **kwargs), None
    key = (fn_name, bucket_signature(args, kwargs))
    with _lock:
        rec = _records.get(key)
    if rec is not None:
        # a new site instance met a recorded signature: no new recording,
        # but its gauges describe the bucket the process now runs
        _set_gauges(fn_name, rec, reg)
        return note_call(rec, fn, args, kwargs), rec
    outer = _composite() if _ACTIVE else None
    start = outer.offset() if outer is not None else 0
    t0 = time.monotonic_ns()
    out, costs = run_recorded(fn, args, kwargs, composite=composite)
    rec = dict(costs, fn=fn_name, bucket=key[1],
               extract_ms=round((time.monotonic_ns() - t0) / 1e6, 3))
    global _extractions
    with _lock:
        if key in _records:  # lost a race: the first recording won
            rec = _records[key]
        else:
            _records[key] = rec
            _extractions += 1
    if outer is not None:
        outer.add(rec, start)
    _set_gauges(fn_name, rec, reg)
    return out, rec


def extraction_count() -> int:
    """Recordings actually made this process (cache misses only) — what
    the no-re-record pin asserts against."""
    with _lock:
        return _extractions


def records() -> List[Dict[str, Any]]:
    """Every cached record, recording order (one per fn × bucket)."""
    with _lock:
        return [dict(rec) for rec in _records.values()]


def per_fn() -> Dict[str, Dict[str, Any]]:
    """Latest record per site plus its bucket count."""
    out: Dict[str, Dict[str, Any]] = {}
    with _lock:
        items = list(_records.items())
    for (fn, _bucket), rec in items:
        row = dict(rec)
        row["buckets"] = out[fn]["buckets"] + 1 if fn in out else 1
        out[fn] = row
    return out


_FLAT_XLA_RE = re.compile(
    r'^(dmlc_xla_(?:flops|bytes_accessed|peak_bytes|collective_bytes))'
    r'\{[^}]*?fn="((?:[^"\\]|\\.)*)"')


def sites_from_flat(flat: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Per-site cost rows parsed back out of a flat registry snapshot."""
    out: Dict[str, Dict[str, float]] = {}
    for key, value in flat.items():
        m = _FLAT_XLA_RE.match(key)
        if not m:
            continue
        name, fn = m.groups()
        fn = fn.replace('\\"', '"').replace("\\\\", "\\")
        out.setdefault(fn, {})[name[len("dmlc_xla_"):]] = float(value)
    return out


def step_costs(flat: Dict[str, float]) -> Dict[str, float]:
    """The model train step's per-call flops/bytes from a flat snapshot:
    the max across ``*.step`` / ``*.step_mp`` sites. Feeds goodput's
    window flop estimate (steps × per-step flops) and the MFU verdict."""
    out = {"flops": 0.0, "bytes": 0.0}
    for fn, rec in sites_from_flat(flat).items():
        if fn.rsplit(".", 1)[-1] not in ("step", "step_mp"):
            continue
        out["flops"] = max(out["flops"], rec.get("flops", 0.0))
        out["bytes"] = max(out["bytes"], rec.get("bytes_accessed", 0.0))
    return out


def detail_section() -> Dict[str, Any]:
    """Per-site latest records + the recording count."""
    return {"sites": per_fn(), "extractions": extraction_count()}


# ---------------------------------------------------------------------------
# measured peaks: the auto defaults behind DMLC_TPU_PEAK_FLOPS /
# DMLC_TPU_PEAK_HBM_GBPS (a setting > 0 wins; these run once per process,
# lazily, only when a model-based verdict is requested)
# ---------------------------------------------------------------------------

_probe_lock = threading.Lock()
_peak_flops_probe: Optional[float] = None
_hbm_gbps_probe: Optional[float] = None

#: the card's probe sizes: a 4096² matmul (137 GFLOP) and 1 GiB read and
#: written in place (far past the launch floor and the L2)
CUDA_MATMUL_N = 4096
CUDA_STREAM_ELEMS = 1 << 28
#: the reference's CPU sizes
CPU_MATMUL_N = 256
CPU_STREAM_ELEMS = 8 * 1024 * 1024


def _probe_dev() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _best_seconds(fn, dev: torch.device, repeats: int = 3) -> float:
    fn()  # warm outside the timing
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            fn()
            end.record(torch.cuda.current_stream(dev))
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def _probe_flops(dev: torch.device) -> float:
    from dmlc_tpu_torch.utils.device import strict_f32

    strict_f32()
    n = CUDA_MATMUL_N if dev.type == "cuda" else CPU_MATMUL_N
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    out = torch.empty_like(a)
    best = _best_seconds(lambda: torch.matmul(a, a, out=out), dev)
    return 2.0 * n ** 3 / best if best > 0 else 0.0


def _probe_hbm(dev: torch.device) -> float:
    n = CUDA_STREAM_ELEMS if dev.type == "cuda" else CPU_STREAM_ELEMS
    x = torch.ones(n, dtype=torch.float32, device=dev)
    # in place: each element read once and written once, one buffer held
    best = _best_seconds(lambda: x.mul_(1.0000001), dev)
    return 2.0 * n * 4 / best / 1e9 if best > 0 else 0.0


def _probe_on_card(probe, dev: torch.device) -> float:
    """Run ``probe(dev)`` with its tensors in a private memory pool that
    is released when it returns: the caching allocator keeps none of the
    probe's bytes for the caller's process."""
    pool = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(pool, device=dev):
        val = probe(dev)  # its tensors are freed as it returns
    del pool  # frees the pool's segments
    return val


def _probed(which: str) -> float:
    global _peak_flops_probe, _hbm_gbps_probe
    with _probe_lock:
        cached = _peak_flops_probe if which == "flops" else _hbm_gbps_probe
        if cached is not None:
            return cached
    dev = _probe_dev()
    probe = _probe_flops if which == "flops" else _probe_hbm
    if dev.type == "cuda":
        val = _probe_on_card(probe, dev)  # a failed probe raises
    else:
        try:
            val = probe(dev)
        except Exception:
            logger.debug("%s probe failed", which, exc_info=True)
            val = 0.0
    with _probe_lock:
        if which == "flops":
            if _peak_flops_probe is None:
                _peak_flops_probe = val
            return _peak_flops_probe
        if _hbm_gbps_probe is None:
            _hbm_gbps_probe = val
        return _hbm_gbps_probe


def probed_peak_flops() -> float:
    """Measured f32 matmul FLOP rate (FLOP/s), probed once per process,
    best of 3 (sizes in the module docstring). A *measured* ceiling, so
    MFU against it reads as "fraction of what this device demonstrably
    sustains". On the CPU a failed probe gives 0.0 (MFU then stays
    absent); on the card it raises."""
    return _probed("flops")


def probed_hbm_gbps() -> float:
    """Measured device memory bandwidth (GB/s) of an elementwise pass
    (read + write), probed once per process, best of 3."""
    return _probed("hbm")


def reset() -> None:
    """Forget process-level state (tests): records, the recording count,
    and both measured-peak probes."""
    global _extractions, _peak_flops_probe, _hbm_gbps_probe
    with _lock:
        _records.clear()
        _extractions = 0
    with _probe_lock:
        _peak_flops_probe = None
        _hbm_gbps_probe = None

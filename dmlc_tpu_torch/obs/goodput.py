"""Runtime goodput ledger and roofline attribution (the port of
``dmlc_tpu/obs/goodput.py``: the same stage sources, verdict keys and
table).

It decomposes rolling wall-clock into per-stage budgets by reading the
counters and span timers the tree already maintains, computes goodput
(useful examples/s and MB/s over wall time, against a "badput" residual
of waiting + unattributed time), compares each stage's achieved rate to
its roofline ceiling, and names the live **binding constraint** per
window. :func:`attribute` is the one verdict every surface prints (the
fit loops' epoch log line, models/fitloop.py).

Stage budgets come from the flat registry deltas (metrics.flat_values):

- ``parse``       — ``dmlc_feed_host_batch_ns`` (host production:
  parse + densify/pad, io_read folded in)
- ``h2d``         — ``dmlc_feed_dispatch_ns`` (async device submission)
- ``device_step`` — ``dmlc_feed_consume_ns`` (time the consumer held
  each batch: the optimizer step, as the *host* sees it — on the card
  that is launch time, since the step's kernels run asynchronously; only
  ``dmlc_step_device_ms`` measures the device). A feed-less fit (GBDT's
  binned matrix) falls back to ``dmlc_fit_epoch_ns``.
- ``collective``  — ``dmlc_collective_op_ns`` (host-array collectives of
  the engines)
- ``checkpoint``  — ``dmlc_snap_capture_ns`` (job-snapshot state
  capture on the training thread; the commit runs on the writer thread)
- ``host_wait``   — ``dmlc_feed_host_wait_ns`` (consumer starved by the
  host producer — the input-bound signature)
- ``idle``        — residual wall not covered by the serial-stage sum

Roofline ceilings (MB/s unless noted), merged over
:func:`default_ceilings`, each from the reference's setting and default:

- ``parse_mbps``  — ``DMLC_TPU_PARSE_PEAK_MBPS`` (default 1000)
- ``h2d_mbps``    — measured, passed through ``ceilings=`` (0 = unknown)
- ``step_mbps``   — ``DMLC_TPU_STEP_PEAK_MBPS`` (default 0 = unknown)
- ``ici_gbps``    — ``DMLC_TPU_ICI_PEAK_GBPS`` (default 45, the
  reference's per-link figure for its chip's interconnect; set it to the
  link the job runs over)

The cost records (obs/xla_cost.py) add the *model-based* pair: the
window's flop/byte estimate is steps × the hot step's per-call record
(``dmlc_xla_flops{fn=}`` / ``dmlc_xla_bytes_accessed{fn=}`` over the
``*.step``/``*.step_mp`` sites, read from the ``current`` snapshot),
scored against ``peak_flops`` (``DMLC_TPU_PEAK_FLOPS``, default = the
measured matmul probe) and ``hbm_gbps`` (``DMLC_TPU_PEAK_HBM_GBPS``,
default = the measured streaming probe). When computable the verdict
gains ``mfu``, ``hbm_fraction`` and a ``compute`` block; the keys are
absent otherwise.

The per-step :class:`GoodputLedger` is the in-run form: ``note_step()``
on the hot path (one integer add), ``tick()`` at window boundaries
(epoch ends) snapshots the registry, attributes the delta, updates the
``dmlc_goodput_ratio_value`` gauge, and returns the window for the SLO
watchdog (obs/watchdog.py). Under ``DMLC_TPU_METRICS=0`` :func:`ledger`
hands back the shared no-op child (metrics.NOOP).
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, Optional, Sequence

from dmlc_tpu_torch.obs.metrics import (
    NOOP,
    Registry,
    metrics_enabled,
    registry,
)
from dmlc_tpu_torch.params.env import get_env

#: window history kept by a ledger (rolling; the watchdog keeps its own)
DEFAULT_HISTORY = 64

# flat-registry families feeding the stage budgets (histogram ns sums)
_STAGE_SOURCES = {
    "parse": "dmlc_feed_host_batch_ns",
    "h2d": "dmlc_feed_dispatch_ns",
    "host_wait": "dmlc_feed_host_wait_ns",
    "device_step": "dmlc_feed_consume_ns",
    "collective": "dmlc_collective_op_ns",
    "checkpoint": "dmlc_snap_capture_ns",
}
_FIT_EPOCH = "dmlc_fit_epoch_ns"

#: every stage key an attribution's ``budget_s`` carries, in report order
STAGES = ("parse", "h2d", "device_step", "collective", "checkpoint",
          "host_wait", "idle")


def _sum_named(flat: Dict[str, float], name: str, suffix: str = "") -> float:
    """Sum one family across its label sets: ``name`` +
    ``name{...}`` flat keys, with an optional ``:sum``/``:count``
    histogram suffix."""
    exact = name + suffix
    prefix = name + "{"
    total = 0.0
    for key, v in flat.items():
        if key == exact:
            total += v
        elif key.startswith(prefix) and key.endswith(suffix):
            total += v
    return total


def _max_named(flat: Dict[str, float], name: str, default: float) -> float:
    prefix = name + "{"
    best = None
    for key, v in flat.items():
        if key == name or key.startswith(prefix):
            best = v if best is None else max(best, v)
    return default if best is None else best


def flat_delta(cur: Dict[str, float],
               prev: Dict[str, float]) -> Dict[str, float]:
    """Windowed registry view: ``cur − prev`` per flat key, clamped at 0
    (a restarted worker's counters reset; a negative delta is a rebase,
    not negative work)."""
    out: Dict[str, float] = {}
    for key, v in cur.items():
        try:
            d = float(v) - float(prev.get(key, 0.0))
        except (TypeError, ValueError):
            continue
        out[key] = d if d > 0.0 else 0.0
    return out


def stage_seconds(delta: Dict[str, float]) -> Dict[str, float]:
    """Per-stage second budgets from one flat-registry delta."""
    out = {}
    for stage, family in _STAGE_SOURCES.items():
        out[stage] = _sum_named(delta, family, ":sum") / 1e9
    if out["device_step"] <= 0.0:
        # feed-less fits (GBDT's binned matrix) time the whole fit as
        # one epoch histogram; book it as device-step work
        out["device_step"] = _sum_named(delta, _FIT_EPOCH, ":sum") / 1e9
    return out


def progress_counters(delta: Dict[str, float]) -> Dict[str, float]:
    """The window's useful-work counters from one flat-registry delta."""
    h2d_bytes = _sum_named(delta, "dmlc_feed_h2d_bytes_total")
    io_bytes = _sum_named(delta, "dmlc_io_read_bytes_total")
    return {
        "steps": _sum_named(delta, "dmlc_fit_steps_total"),
        "batches": _sum_named(delta, "dmlc_feed_batches_total"),
        "rows": _sum_named(delta, "dmlc_feed_rows_total"),
        "bytes": h2d_bytes if h2d_bytes > 0 else io_bytes,
        "io_bytes": io_bytes,
        "collective_bytes": _sum_named(
            delta, "dmlc_collective_moved_bytes_total"),
        "recompiles": _sum_named(delta, "dmlc_xla_recompiles_total"),
    }


def parse_peak_mbps() -> float:
    """Roofline ceiling for the parse stage in MB/s
    (``DMLC_TPU_PARSE_PEAK_MBPS``, default 1000; 0 = unknown)."""
    return max(0.0, float(get_env("DMLC_TPU_PARSE_PEAK_MBPS", 1000.0)))


def step_peak_mbps() -> float:
    """Roofline ceiling for the device step's consumed byte rate in MB/s
    (``DMLC_TPU_STEP_PEAK_MBPS``, default 0 = unknown)."""
    return max(0.0, float(get_env("DMLC_TPU_STEP_PEAK_MBPS", 0.0)))


def ici_peak_gbps() -> float:
    """Per-direction per-link interconnect peak in GB/s
    (``DMLC_TPU_ICI_PEAK_GBPS``, the reference's default 45)."""
    return max(0.0, float(get_env("DMLC_TPU_ICI_PEAK_GBPS", 45.0)))


def peak_flops() -> float:
    """Model-based roofline peak in FLOP/s (``DMLC_TPU_PEAK_FLOPS``,
    default 0 = auto: the measured ``xla_cost.probed_peak_flops``)."""
    return max(0.0, float(get_env("DMLC_TPU_PEAK_FLOPS", 0.0)))


def peak_hbm_gbps() -> float:
    """Model-based device-memory-bandwidth peak in GB/s
    (``DMLC_TPU_PEAK_HBM_GBPS``, default 0 = auto: the measured
    ``xla_cost.probed_hbm_gbps``)."""
    return max(0.0, float(get_env("DMLC_TPU_PEAK_HBM_GBPS", 0.0)))


def default_ceilings() -> Dict[str, float]:
    """Roofline ceilings from the env settings (see module docstring);
    callers overlay measured values."""
    return {
        "parse_mbps": parse_peak_mbps(),
        "h2d_mbps": 0.0,
        "step_mbps": step_peak_mbps(),
        "ici_gbps": ici_peak_gbps(),
        "peak_flops": peak_flops(),
        "hbm_gbps": peak_hbm_gbps(),
    }


def _rate_mbps(num_bytes: float, seconds: float) -> float:
    return num_bytes / seconds / 1e6 if seconds > 0 else 0.0


def _roofline(stages: Dict[str, float], counters: Dict[str, float],
              ceilings: Dict[str, float]) -> Dict[str, Dict]:
    """Per-stage achieved rate vs ceiling; ``utilization`` is None when
    the ceiling is unknown (0)."""
    nbytes = counters.get("bytes", 0.0)
    out: Dict[str, Dict] = {}
    for stage, ceiling_key in (("parse", "parse_mbps"),
                               ("h2d", "h2d_mbps"),
                               ("device_step", "step_mbps")):
        achieved = _rate_mbps(nbytes, stages.get(stage, 0.0))
        ceiling = float(ceilings.get(ceiling_key, 0.0) or 0.0)
        out[stage] = {
            "achieved_mbps": round(achieved, 3),
            "ceiling_mbps": round(ceiling, 3),
            "utilization": round(achieved / ceiling, 4) if ceiling > 0
            else None,
        }
    coll_s = stages.get("collective", 0.0)
    coll_gbps = (counters.get("collective_bytes", 0.0) / coll_s / 1e9
                 if coll_s > 0 else 0.0)
    ici = float(ceilings.get("ici_gbps", 0.0) or 0.0)
    out["collective"] = {
        "achieved_gbps": round(coll_gbps, 4),
        "ceiling_gbps": round(ici, 3),
        "utilization": round(coll_gbps / ici, 4) if ici > 0 else None,
    }
    return out


def _finish(stages: Dict[str, float], counters: Dict[str, float],
            wall_s: float, ceilings: Optional[Dict] = None) -> Dict:
    """Shared verdict builder for :func:`attribute` and :func:`rolled`."""
    wall_s = max(float(wall_s), 1e-9)
    ceil = default_ceilings()
    if ceilings:
        ceil.update({k: v for k, v in ceilings.items() if v is not None})
    serial = (stages["parse"] + stages["h2d"] + stages["device_step"]
              + stages["collective"] + stages["checkpoint"]
              + stages["host_wait"])
    idle = max(0.0, wall_s - serial)
    budget = dict(stages, idle=idle)
    # binding: the stage whose time budget dominates the window. The
    # input-bound signature is host production time PLUS the consumer's
    # wait on it (overlapped pipelines starve via host_wait, serial
    # ones via host_batch) — both accrue to "parse".
    scores = {
        "parse": stages["parse"] + stages["host_wait"],
        "h2d": stages["h2d"],
        "device_step": stages["device_step"],
        "collective": stages["collective"],
        "checkpoint": stages["checkpoint"],
    }
    binding = max(scores, key=lambda k: scores[k])
    if scores[binding] <= 0.0 or idle > scores[binding]:
        binding = "idle"
    nbytes = counters.get("bytes", 0.0)
    rows = counters.get("rows", 0.0)
    # goodput = the fraction of wall the pipeline spent doing useful
    # device-side work (submission + step); badput = waiting + residual
    ratio = min(1.0, (stages["h2d"] + stages["device_step"]) / wall_s)
    roofline = _roofline(stages, counters, ceil)
    at_roof = False
    util = roofline.get(binding, {}).get("utilization")
    if util is not None and util >= 0.8:
        at_roof = True
    out = {
        "window_s": round(wall_s, 6),
        "budget_s": {k: round(v, 6) for k, v in budget.items()},
        "counters": {k: round(v, 3) for k, v in counters.items()},
        "goodput": {
            "rows_s": round(rows / wall_s, 3),
            "mbps": round(_rate_mbps(nbytes, wall_s), 3),
            "ratio": round(ratio, 4),
        },
        "roofline": roofline,
        "binding": binding,
        "at_roof": at_roof,
    }
    # model-based roofline: the window's XLA flop/byte estimate (steps ×
    # per-step compiled-program analytics, injected by attribute() or
    # summed across ranks by rolled()) against the peak knobs, with the
    # measured probes standing in for unset knobs. All three keys stay
    # absent when nothing is computable — conditional surfaces key off
    # their presence.
    xla_flops = counters.get("xla_flops", 0.0)
    if xla_flops > 0.0:
        peak = float(ceil.get("peak_flops", 0.0) or 0.0)
        if peak <= 0.0:
            from dmlc_tpu_torch.obs import xla_cost

            peak = xla_cost.probed_peak_flops()
        if peak > 0.0:
            out["mfu"] = round(min(1.0, xla_flops / wall_s / peak), 4)
            out["compute"] = {
                "flops": round(xla_flops, 3),
                "peak_flops": round(peak, 3),
                "floor_s": round(xla_flops / peak, 6),
                "measured_s": round(stages["device_step"], 6),
            }
    xla_bytes = counters.get("xla_bytes", 0.0)
    if xla_bytes > 0.0:
        gbps = float(ceil.get("hbm_gbps", 0.0) or 0.0)
        if gbps <= 0.0:
            from dmlc_tpu_torch.obs import xla_cost

            gbps = xla_cost.probed_hbm_gbps()
        if gbps > 0.0:
            out["hbm_fraction"] = round(
                min(1.0, xla_bytes / wall_s / (gbps * 1e9)), 4)
    return out


def attribute(delta: Dict[str, float], wall_s: float,
              ceilings: Optional[Dict] = None,
              current: Optional[Dict[str, float]] = None) -> Dict:
    """One window's attribution verdict from a flat-registry delta.

    ``delta`` is :func:`flat_delta` between two ``flat_values()``
    snapshots (or the totals themselves for a whole-run window);
    ``current`` optionally supplies the live snapshot for gauge reads
    (the straggler rank, the per-step XLA cost gauges — flat_delta
    clamps gauges, so they must come from a real snapshot)."""
    counters = progress_counters(delta)
    steps = counters.get("steps", 0.0)
    if steps > 0.0:
        from dmlc_tpu_torch.obs import xla_cost

        costs = xla_cost.step_costs(current if current else delta)
        # only materialize the model-based counters when a compiled hot
        # step has actually been analyzed — their absence keeps the
        # mfu/compute keys (and every conditional surface) absent too
        if costs["flops"] > 0.0:
            counters["xla_flops"] = steps * costs["flops"]
        if costs["bytes"] > 0.0:
            counters["xla_bytes"] = steps * costs["bytes"]
    att = _finish(stage_seconds(delta), counters, wall_s, ceilings)
    if current:
        att["straggler_rank"] = int(_max_named(
            current, "dmlc_job_straggler_rank", default=-1.0))
    return att


def rolled(atts: Sequence[Dict]) -> Optional[Dict]:
    """Job-level roll-up of per-rank attributions: budgets and counters
    sum, the window is the widest rank's, and the verdict re-derives
    from the summed budgets via the same code path."""
    atts = [a for a in atts if isinstance(a, dict) and "budget_s" in a]
    if not atts:
        return None
    stages = {k: 0.0 for k in STAGES if k != "idle"}
    counters: Dict[str, float] = {}
    wall = 0.0
    straggler = -1
    for att in atts:
        for key, v in att.get("budget_s", {}).items():
            if key in stages:
                stages[key] += float(v)
        for key, v in att.get("counters", {}).items():
            counters[key] = counters.get(key, 0.0) + float(v)
        wall = max(wall, float(att.get("window_s", 0.0)))
        straggler = max(straggler, int(att.get("straggler_rank", -1)))
    out = _finish(stages, counters, wall)
    out["ranks"] = len(atts)
    out["straggler_rank"] = straggler
    return out


def format_attribution(att: Dict, label: str = "goodput") -> str:
    """The human table every surface prints (the reference's obs-report
    and obs-top, the fit loop's log) — one verdict, one renderer."""
    g = att.get("goodput", {})
    lines = [
        "%s: binding=%s  ratio %.2f  %.1f MB/s  %.0f rows/s  "
        "window %.2fs%s" % (
            label, att.get("binding", "?"), g.get("ratio", 0.0),
            g.get("mbps", 0.0), g.get("rows_s", 0.0),
            att.get("window_s", 0.0),
            "  (at roof)" if att.get("at_roof") else ""),
        "%-12s %10s %6s %14s %14s %6s" % (
            "stage", "budget_s", "share", "achieved", "ceiling", "util"),
    ]
    wall = max(float(att.get("window_s", 0.0)), 1e-9)
    budget = att.get("budget_s", {})
    roofline = att.get("roofline", {})
    for stage in STAGES:
        sec = float(budget.get(stage, 0.0))
        roof = roofline.get(stage, {})
        achieved = roof.get("achieved_mbps", roof.get("achieved_gbps"))
        ceiling = roof.get("ceiling_mbps", roof.get("ceiling_gbps"))
        util = roof.get("utilization")
        mark = " <- binding" if stage == att.get("binding") else ""
        lines.append("%-12s %10.3f %5.0f%% %14s %14s %6s%s" % (
            stage, sec, 100.0 * sec / wall,
            "-" if achieved is None else "%.1f" % achieved,
            "-" if not ceiling else "%.1f" % ceiling,
            "-" if util is None else "%.0f%%" % (100.0 * util),
            mark))
    comp = att.get("compute")
    if comp:
        # the model-based floor under device_step: what the window's
        # XLA flop estimate predicts at peak vs what was measured
        mfu = att.get("mfu")
        lines.append(
            "compute      %10.3f floor vs %.3f measured  "
            "(%.3g FLOPs @ %.3g FLOP/s%s)" % (
                comp.get("floor_s", 0.0), comp.get("measured_s", 0.0),
                comp.get("flops", 0.0), comp.get("peak_flops", 0.0),
                "" if mfu is None else ", mfu %.0f%%" % (100.0 * mfu)))
    return "\n".join(lines)


class GoodputLedger:
    """Per-step runtime ledger: cheap progress notes on the hot path,
    window attribution at ``tick()`` boundaries.

    Construct via :func:`ledger` so ``DMLC_TPU_METRICS=0`` collapses to
    the shared no-op child."""

    def __init__(self, reg: Optional[Registry] = None,
                 ceilings: Optional[Dict] = None,
                 history: int = DEFAULT_HISTORY):
        self._reg = reg if reg is not None else registry()
        self._ceilings = dict(ceilings or {})
        self._g_ratio = self._reg.gauge(
            "dmlc_goodput_ratio_value",
            "useful-work fraction of the last ledger window")
        self._g_mfu = self._reg.gauge(
            "dmlc_goodput_mfu_ratio",
            "model FLOP utilization of the last ledger window (window "
            "XLA flop estimate over the peak-FLOPs ceiling; stays 0 "
            "until a compiled hot step has been analyzed)")
        self.windows: Deque[Dict] = collections.deque(maxlen=history)
        self._steps = 0
        self._prev = self._reg.flat_values()
        self._t0 = time.monotonic_ns()

    def note_step(self, n: int = 1) -> None:
        """Hot-path progress marker — one integer add, no allocation."""
        self._steps += n

    def tick(self, wall_ns: Optional[int] = None) -> Dict:
        """Close the current window: snapshot the registry, attribute
        the delta since the last tick, and return the window verdict."""
        now = time.monotonic_ns()
        flat = self._reg.flat_values()
        wall_s = ((wall_ns if wall_ns is not None else now - self._t0)
                  / 1e9)
        delta = flat_delta(flat, self._prev)
        att = attribute(delta, wall_s, self._ceilings, current=flat)
        if self._steps and att["counters"].get("steps", 0.0) <= 0.0:
            # registry fit counters can lag a custom loop; the ledger's
            # own notes still count as progress (watchdog stall input)
            att["counters"]["steps"] = float(self._steps)
        self._steps = 0
        self._prev = flat
        self._t0 = now
        self._g_ratio.set(att["goodput"]["ratio"])
        if att.get("mfu") is not None:
            self._g_mfu.set(att["mfu"])
        self.windows.append(att)
        return att


def ledger(reg: Optional[Registry] = None,
           ceilings: Optional[Dict] = None):
    """A :class:`GoodputLedger`, or the shared no-op child when the
    metrics registry is disabled (``DMLC_TPU_METRICS=0``) — the
    fit-loop hot path then costs one empty method call per step."""
    if not metrics_enabled():
        return NOOP
    return GoodputLedger(reg, ceilings)

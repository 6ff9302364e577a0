"""Perf sentry: turn bench history into a noise-aware regression gate (the
port of ``dmlc_tpu/obs/sentry.py``: the same record shapes, directions and
gate math; the SLO watchdog, obs/watchdog.py, reuses its median/MAD band).

The bench driver leaves two artifact shapes behind (bench.py):

- ``BENCH_r*.json`` — one per round, ``{"n", "cmd", "rc", "tail",
  "parsed"}`` where ``parsed`` is the compact summary line (may be null
  when a round produced no summary);
- ``bench_detail.json`` — the full unshed record for the latest run
  (``DMLC_TPU_BENCH_DETAIL``), one JSON object per line.

Both reduce to the same record: ``{"metric", "value", "unit", "extra"}``.
:func:`gate` compares a fresh record against the history series per
metric:

- the headline metric (``value``, e.g. ``higgs_libsvm_ingest`` MB/s) and
  every ``extra`` key ending ``_mbps``/``_gbps``/``_mrows_s`` are
  higher-is-better throughputs, as is the suffix-less
  ``cache_cross_job_hit_ratio`` (multijob bench tier — a drop below its
  1.0 history means a second tenant started re-parsing shared chunks);
- ``extra["pipelined_stall_stages"]`` keys ending ``_s`` are gated
  lower-is-better as ``stall.<key>`` (a stall stage growing is exactly
  the regression shape flow tracing exists to localize);
- ``extra["device_telemetry"]`` (obs/device_telemetry.py) contributes
  ``compiles.<fn>`` (per-function XLA compile counts) and
  ``hbm.peak_bytes`` lower-is-better — a compile-count increase is a
  recompile regression, an HBM peak increase is memory pressure — plus
  ``h2d_mbps`` (mean H2D submission bandwidth) higher-is-better.

Bench numbers are noisy (the recorded higgs history spans 468–678 MB/s
across environments), so the baseline is robust: per metric, take the
``window`` most recent history values, baseline = median, spread = MAD
(median absolute deviation), and tolerance = ``max(rel_tol·|median|,
mad_mult·MAD)`` — a metric whose history is jumpy earns a wide band, a
stable one a tight band. Metrics with fewer than ``min_samples`` history
points are skipped (no noise estimate to gate against). Regressions are
ranked by how far past the tolerance band they land, in tolerance units.

``python -m dmlc_tpu_torch.tools bench_gate`` drives it (``--smoke``
runs the canned :data:`SMOKE_HISTORY` pair as its self-check). Each
reported regression is also recorded as a ``sentry.regression``
flight-recorder event (docs/observability.md event catalog).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from dmlc_tpu_torch.obs.flight import record_event

# baseline window / tolerances, the reference's (tuned there against its
# bench history: the newest record passes, a 20% headline degradation
# fails; tests/test_torch_goodput.py holds the port to the same verdicts)
DEFAULT_WINDOW = 3
DEFAULT_REL_TOL = 0.10
DEFAULT_MAD_MULT = 2.0
DEFAULT_MIN_SAMPLES = 2

_HIGHER_SUFFIXES = ("_mbps", "_gbps", "_mrows_s")
# higher-is-better extras that carry no unit suffix: the cross-job
# source-cache hit ratio from the multijob bench tier (1.0 = the second
# tenant parsed nothing), and the SPMD in-graph step's ICI utilization
# (achieved/peak on the gradient psum — the ≥90% ROADMAP target).
# spmd_psum_step_gbps and the baked-shard tier keys (shard_ingest_gbps /
# sgd_e2e_shard_mbps / bake_mbps, the ISSUE's acceptance trio) are listed
# too for explicitness, though the suffix rule already gates them.
_HIGHER_KEYS = (
    "cache_cross_job_hit_ratio",
    "ici_utilization",
    "spmd_psum_step_gbps",
    "shard_ingest_gbps",
    "sgd_e2e_shard_mbps",
    "bake_mbps",
)
_STALL_PREFIX = "stall."
# lower-is-better key families: stall stages, XLA compile counts, and
# peak HBM (device_telemetry section)
_LOWER_PREFIXES = (_STALL_PREFIX, "compiles.", "hbm.")

# canned record pair for the self-check: a miniature history in the
# artifact shape plus a degraded twin of the last round (the
# reference's). Canned rather than read from disk so the self-check runs
# anywhere.
SMOKE_HISTORY: List[Dict] = [
    {
        "metric": "higgs_libsvm_ingest", "value": 560.1, "unit": "MB/s",
        "extra": {
            "recordio_ingest_mbps": 2250.0,
            "pipelined_stall_stages": {
                "host_batch_s": 2.10, "dispatch_s": 0.40,
                "host_wait_s": 0.55, "consume_s": 1.95,
            },
        },
    },
    {
        "metric": "higgs_libsvm_ingest", "value": 612.4, "unit": "MB/s",
        "extra": {
            "recordio_ingest_mbps": 2310.0,
            "pipelined_stall_stages": {
                "host_batch_s": 2.02, "dispatch_s": 0.38,
                "host_wait_s": 0.49, "consume_s": 1.90,
            },
        },
    },
    {
        "metric": "higgs_libsvm_ingest", "value": 646.3, "unit": "MB/s",
        "extra": {
            "recordio_ingest_mbps": 2341.3,
            "pipelined_stall_stages": {
                "host_batch_s": 1.98, "dispatch_s": 0.41,
                "host_wait_s": 0.52, "consume_s": 1.88,
            },
        },
    },
    {
        "metric": "higgs_libsvm_ingest", "value": 678.0, "unit": "MB/s",
        "extra": {
            "recordio_ingest_mbps": 2338.0,
            "pipelined_stall_stages": {
                "host_batch_s": 1.95, "dispatch_s": 0.39,
                "host_wait_s": 0.50, "consume_s": 1.85,
            },
        },
    },
]


def smoke_degraded() -> Dict:
    """The canned fresh record with a 20% headline regression and a
    doubled host_wait stall — the shapes the gate must catch."""
    rec = json.loads(json.dumps(SMOKE_HISTORY[-1]))  # deep copy
    rec["value"] = round(rec["value"] * 0.8, 1)
    stalls = rec["extra"]["pipelined_stall_stages"]
    stalls["host_wait_s"] = round(stalls["host_wait_s"] * 2.0, 2)
    return rec


def _median(values: Sequence[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _mad(values: Sequence[float], med: float) -> float:
    return _median([abs(v - med) for v in values])


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def load_record(path: str) -> List[Dict]:
    """Parse one bench artifact into normalized records.

    Accepts either driver shape (``{"parsed": {...}}`` — a null
    ``parsed`` yields no record, matching rounds that printed no
    summary) or a raw summary/detail object; files may hold one JSON
    object or one per line (bench_detail.json appends)."""
    text = open(path).read()
    try:
        objs = [json.loads(text)]
    except ValueError:
        objs = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                objs.append(json.loads(line))
            except ValueError:
                continue  # torn tail line: keep what parses
    out = []
    for obj in objs:
        if not isinstance(obj, dict):
            continue
        if "parsed" in obj:
            obj = obj["parsed"]
        if isinstance(obj, dict) and _is_number(obj.get("value")) \
                and obj.get("metric"):
            out.append(dict(obj, source=path))
    return out


def load_records(paths: Sequence[str]) -> List[Dict]:
    out: List[Dict] = []
    for path in paths:
        out.extend(load_record(path))
    return out


def record_values(rec: Dict) -> Dict[str, float]:
    """The gateable metric values of one record (see module docstring
    for the key→direction rules). Keys named in the record's optional
    ``directions`` map are gated too, whatever their suffix — the
    per-record direction registry that replaces growing
    ``_HIGHER_KEYS`` (``record_directions`` collects the map for
    :func:`gate`). That is how bench's ``sgd_goodput_ratio`` and
    ``sgd_mfu`` (model FLOP utilization, higher-is-better) gate with no
    sentry-side changes."""
    vals: Dict[str, float] = {}
    if _is_number(rec.get("value")) and rec.get("metric"):
        vals[str(rec["metric"])] = float(rec["value"])
    extra = rec.get("extra") or {}
    if not isinstance(extra, dict):
        return vals
    directions = rec.get("directions")
    if isinstance(directions, dict):
        for key in directions:
            v = extra.get(key)
            if _is_number(v):
                vals[str(key)] = float(v)
    for key, v in extra.items():
        if _is_number(v) and (key.endswith(_HIGHER_SUFFIXES)
                              or key in _HIGHER_KEYS):
            vals[key] = float(v)
    stalls = extra.get("pipelined_stall_stages")
    if isinstance(stalls, dict):
        for key, v in stalls.items():
            if _is_number(v) and key.endswith("_s"):
                vals[_STALL_PREFIX + key] = float(v)
    devtel = extra.get("device_telemetry")
    if isinstance(devtel, dict):
        compiles = devtel.get("compiles")
        if isinstance(compiles, dict):
            for fn, v in compiles.items():
                if _is_number(v):
                    vals["compiles." + str(fn)] = float(v)
        if _is_number(devtel.get("peak_hbm_bytes")):
            vals["hbm.peak_bytes"] = float(devtel["peak_hbm_bytes"])
        if _is_number(devtel.get("h2d_mbps")):
            vals["h2d_mbps"] = float(devtel["h2d_mbps"])
    return vals


def metric_series(records: Sequence[Dict]) -> Dict[str, List[float]]:
    """Per-metric history series, in record order (oldest first)."""
    series: Dict[str, List[float]] = {}
    for rec in records:
        for key, v in record_values(rec).items():
            series.setdefault(key, []).append(v)
    return series


def record_directions(records: Sequence[Dict]) -> Dict[str, str]:
    """Merge the per-record ``directions`` maps of a history series
    (latest record wins per key) — the second argument
    :func:`lower_is_better` consults before its prefix rules."""
    out: Dict[str, str] = {}
    for rec in records:
        d = rec.get("directions") if isinstance(rec, dict) else None
        if isinstance(d, dict):
            for key, v in d.items():
                if v in ("higher", "lower"):
                    out[str(key)] = v
    return out


def lower_is_better(key: str,
                    directions: Optional[Dict[str, str]] = None) -> bool:
    """Direction of one gated key: an explicit per-record ``directions``
    entry wins; otherwise the suffix/prefix rules in the module
    docstring decide (default: higher is better)."""
    if directions:
        d = directions.get(key)
        if d == "lower":
            return True
        if d == "higher":
            return False
    return key.startswith(_LOWER_PREFIXES)


def gate(
    fresh: Dict[str, float],
    series: Dict[str, List[float]],
    rel_tol: float = DEFAULT_REL_TOL,
    mad_mult: float = DEFAULT_MAD_MULT,
    window: int = DEFAULT_WINDOW,
    min_samples: int = DEFAULT_MIN_SAMPLES,
    directions: Optional[Dict[str, str]] = None,
) -> List[Dict]:
    """Compare fresh metric values against their history series.

    Returns the regressions ranked worst-first; each carries the fresh
    value, the baseline (median), the tolerance band, and ``severity``
    (how far past the band, in tolerance units). Also records each as a
    ``sentry.regression`` flight event (no-op unless the recorder is
    armed)."""
    regressions: List[Dict] = []
    for key in sorted(fresh):
        hist = series.get(key, [])[-window:]
        if len(hist) < min_samples:
            continue
        med = _median(hist)
        tol = max(rel_tol * abs(med), mad_mult * _mad(hist, med))
        value = fresh[key]
        if lower_is_better(key, directions):
            breach = value - (med + tol)
        else:
            breach = (med - tol) - value
        if breach <= 0:
            continue
        reg = {
            "metric": key,
            "value": value,
            "baseline": med,
            "tolerance": tol,
            "direction": "lower" if lower_is_better(key, directions)
            else "higher",
            "samples": len(hist),
            "severity": breach / tol if tol > 0 else float("inf"),
        }
        regressions.append(reg)
        record_event(
            "sentry.regression", metric=key, value=value,
            baseline=med, tolerance=tol,
        )
    regressions.sort(key=lambda r: -r["severity"])
    return regressions


def format_report(
    regressions: Sequence[Dict], fresh_source: Optional[str] = None
) -> str:
    """The ranked regression table bench-gate prints on failure."""
    lines = []
    head = "perf sentry: %d regression(s)" % len(regressions)
    if fresh_source:
        head += " in %s" % fresh_source
    lines.append(head)
    lines.append(
        "%-28s %12s %12s %12s %9s" % (
            "metric", "fresh", "baseline", "tolerance", "severity")
    )
    for r in regressions:
        lines.append(
            "%-28s %12.4g %12.4g %12.4g %8.1fx  (%s is better)" % (
                r["metric"], r["value"], r["baseline"], r["tolerance"],
                r["severity"], r["direction"])
        )
    return "\n".join(lines)

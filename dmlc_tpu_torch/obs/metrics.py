"""Thread-safe, label-aware metrics registry: Counter / Gauge / Histogram
(the port of ``dmlc_tpu/obs/metrics.py``, the same names, buckets and
flat formats).

Every stage counter of the ingest → device stack is a named metric that
the exporters, the goodput ledger and the cross-host aggregation
(obs/aggregate.py) all read — the uniform layer the tf.data
input-pipeline work (arXiv:2101.12127 §5) argues for.

- **Naming.** ``dmlc_<area>_<name>_<unit>`` with the unit last
  (``_total`` for counters, ``_ns``/``_bytes``/... for measures); every
  name is documented in docs/observability.md, which
  ``tests/test_torch_metric_names.py`` holds the port to.
- **Labels.** ``registry().counter("dmlc_feed_batches_total", feed="f0")``
  returns the child for that label set; same (name, labels) → same child.
  Metric *names* are string literals at the call site (the lint walks the
  source).
- **Cheap by default, free when off.** The default-on hot path is one
  lock-and-add. With ``DMLC_TPU_METRICS=0`` registration returns a shared
  no-op child whose methods are empty. The flag is read at *registration*
  time (instance construction), never per increment.
- **Histograms** use fixed log-scale buckets (powers of 4: 1 ns .. ~18
  min for the ns timings recorded here). ``sum`` and ``count`` make a
  histogram a superset of a counter, so a stage timing registers one
  histogram, not a histogram + counter pair.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Optional, Tuple

from dmlc_tpu_torch.params.env import get_env
from dmlc_tpu_torch.utils.logging import check

# log-scale bucket bounds: 4^0 .. 4^20 (≈1.1e12); values above the last
# bound land in the implicit +inf overflow bucket
DEFAULT_BUCKETS: Tuple[int, ...] = tuple(4 ** k for k in range(21))

LabelKey = Tuple[Tuple[str, str], ...]


def metrics_enabled() -> bool:
    """Whether the registry hands out live children (``DMLC_TPU_METRICS``,
    default on). Read at metric *registration* time, never on the
    per-increment path."""
    return get_env("DMLC_TPU_METRICS", True)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def escape_label_value(value) -> str:
    """Prometheus text-format label-value escaping: ``\\`` → ``\\\\``,
    ``"`` → ``\\"``, newline → ``\\n`` (exposition format spec). Backslash
    first, or the escapes it introduces would be re-escaped."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def format_name(name: str, labels: LabelKey) -> str:
    """``name{k="v",...}`` — the Prometheus-style flat identity used by
    snapshots, exporters, and the cross-host vector ordering. Label
    values are escaped per the Prometheus text format, so the flat name
    stays parseable (and servable as a Prometheus line)
    whatever the value contains."""
    if not labels:
        return name
    inner = ",".join(
        '%s="%s"' % (k, escape_label_value(v)) for k, v in labels
    )
    return "%s{%s}" % (name, inner)


class Counter:
    """Monotonic counter. ``inc``/``add`` are the same lock-and-add."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, v: int = 1) -> None:
        with self._lock:
            self._value += v

    add = inc

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (last write wins; ``inc``/``dec`` for levels)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        with self._lock:
            self._value -= v

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bound log-scale histogram with ``sum`` and ``count``.

    ``observe(v)`` counts v in the first bucket whose bound is >= v
    (Prometheus ``le`` semantics); values past the last bound go to the
    overflow bucket. Bounds are fixed at registration so merging across
    hosts/instances is element-wise.
    """

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count")

    def __init__(self, buckets: Optional[Iterable[float]] = None):
        self.bounds = tuple(buckets) if buckets else DEFAULT_BUCKETS
        check(list(self.bounds) == sorted(self.bounds),
              "histogram buckets must be sorted")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)  # +1 = overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    # counter-compatible accumulation: stage code that measured a delta
    # can hist.add(dt) like it used to counter.add(dt)
    add = observe

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def count(self):
        with self._lock:
            return self._count

    def buckets(self) -> Dict[str, int]:
        """Non-cumulative per-bucket counts, only non-empty buckets
        (``"+Inf"`` = overflow) — the compact JSON form."""
        with self._lock:
            counts = list(self._counts)
        out = {}
        for bound, n in zip(self.bounds, counts):
            if n:
                out[repr(int(bound) if float(bound).is_integer() else bound)] = n
        if counts[-1]:
            out["+Inf"] = counts[-1]
        return out

    def cumulative(self) -> Iterable[Tuple[str, int]]:
        """(le, cumulative count) pairs over ALL bounds plus +Inf — the
        Prometheus textfile form."""
        with self._lock:
            counts = list(self._counts)
        acc = 0
        out = []
        for bound, n in zip(self.bounds, counts):
            acc += n
            out.append((repr(int(bound) if float(bound).is_integer()
                             else bound), acc))
        out.append(("+Inf", acc + counts[-1]))
        return out

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (Prometheus
        ``histogram_quantile`` semantics).

        Linear interpolation inside the bucket holding the q-th
        observation; the first bucket interpolates from 0, and anything
        in the overflow bucket reports the last finite bound (the
        distribution above it is unknown). Empty histogram → 0.0;
        q clamps to [0, 1]."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        q = min(1.0, max(0.0, float(q)))
        target = q * total
        acc = 0
        for i, n in enumerate(counts[:-1]):
            if n == 0:
                continue
            if acc + n >= target:
                lo = float(self.bounds[i - 1]) if i > 0 else 0.0
                hi = float(self.bounds[i])
                frac = (target - acc) / n
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
            acc += n
        return float(self.bounds[-1])  # overflow bucket


class _Noop:
    """Shared do-nothing child handed out when DMLC_TPU_METRICS=0. Every
    mutator is an empty method (the disabled-path cost IS one no-op call);
    reads report zero so formatters stay total."""

    __slots__ = ()
    bounds: Tuple[float, ...] = ()
    value = 0
    sum = 0.0
    count = 0

    def inc(self, v=1):
        pass

    def add(self, v=1):
        pass

    def set(self, v):
        pass

    def dec(self, v=1.0):
        pass

    def observe(self, v):
        pass

    # goodput-ledger / watchdog surface (obs/goodput.py, obs/watchdog.py
    # factories hand this same child out under DMLC_TPU_METRICS=0, so
    # the fit-loop hot path stays one empty call, zero allocations)
    windows = ()
    alerts = ()

    def note_step(self, n=1):
        pass

    def tick(self, *args, **kwargs):
        return None

    def buckets(self):
        return {}

    def cumulative(self):
        return []

    def quantile(self, q):
        return 0.0


NOOP = _Noop()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    __slots__ = ("kind", "help", "children")

    def __init__(self, kind: str, help: str):
        self.kind = kind
        self.help = help
        self.children: Dict[LabelKey, object] = {}


class Registry:
    """Process-wide metric store. All methods are thread-safe; the
    per-increment path is on the child (one fine-grained lock), not here."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get(self, kind: str, name: str, help: str, labels: Dict,
             buckets=None):
        if not metrics_enabled():
            return NOOP
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(kind, help)
            else:
                check(fam.kind == kind,
                      "metric %s already registered as a %s (asked for %s)",
                      name, fam.kind, kind)
            child = fam.children.get(key)
            if child is None:
                if kind == "histogram":
                    child = Histogram(buckets)
                else:
                    child = _KINDS[kind]()
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", buckets=None,
                  **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    # ---- read side ------------------------------------------------------

    def families(self) -> Dict[str, Tuple[str, str, Dict[LabelKey, object]]]:
        """{name: (kind, help, {labelkey: child})} — a consistent shallow
        copy for exporters (children are live; their reads take the
        per-child lock)."""
        with self._lock:
            return {
                name: (fam.kind, fam.help, dict(fam.children))
                for name, fam in self._families.items()
            }

    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-ready view: counters/gauges → number, histograms →
        {"count", "sum", "buckets"} with only non-empty buckets."""
        out: Dict[str, object] = {}
        for name, (kind, _help, children) in sorted(self.families().items()):
            for key, child in sorted(children.items()):
                flat = format_name(name, key)
                if kind == "histogram":
                    out[flat] = {
                        "count": child.count,
                        "sum": child.sum,
                        "buckets": child.buckets(),
                    }
                else:
                    out[flat] = child.value
        return out

    def flat_values(self) -> Dict[str, float]:
        """Numeric-only flat view for cross-host allreduce: counters and
        gauges by flat name; each histogram contributes ``_sum`` and
        ``_count`` entries (its distribution stays host-local)."""
        out: Dict[str, float] = {}
        for name, (kind, _help, children) in sorted(self.families().items()):
            for key, child in sorted(children.items()):
                flat = format_name(name, key)
                if kind == "histogram":
                    out[flat + ":sum"] = float(child.sum)
                    out[flat + ":count"] = float(child.count)
                else:
                    out[flat] = float(child.value)
        return out

    def reset(self) -> None:
        """Drop every family (tests; a fresh process state)."""
        with self._lock:
            self._families.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    """The process-wide default registry."""
    return _REGISTRY

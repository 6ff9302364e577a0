"""Pluggable exporters over the obs registry (the port of
``dmlc_tpu/obs/exporters.py``: the same JSONL, Prometheus and summary
formats).

Three sinks, all fed from :meth:`Registry.families` / ``snapshot()``:

- **JSONL** (:func:`export_jsonl`) — appends one ``{"ts_unix": ...,
  "metrics": {...}}`` line per export; the machine-readable epoch trail.
- **Prometheus textfile** (:func:`export_prometheus`) — the node-exporter
  textfile-collector format.
- **Log sink** (:func:`summary_line`) — one compact ``k=v`` line through
  ``utils.logging`` for epoch-boundary fit-loop logs; histograms render
  as ``p50~<quantile>/<count>`` via :meth:`Histogram.quantile`.

Both file sinks write atomically (tmp file + ``os.replace``) so a
scraper never reads a torn file; JSONL preserves append semantics by rewriting the
file with the new line attached.

:func:`export_epoch` is the fit loops' single call: it honors the
``DMLC_TPU_METRICS_EXPORT`` setting (``*.prom`` → Prometheus, else
JSONL), flushes any active trace, feeds the flight recorder its metric
deltas, and returns the summary line for the caller to log. With the
settings unset and no metrics, it is a cheap no-op. The reference also
publishes an obs heartbeat to its tracker's status plane
(``obs/plane.py``), which the port does not have yet.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

from dmlc_tpu_torch.obs import trace
from dmlc_tpu_torch.obs.metrics import (
    Registry,
    escape_label_value,
    format_name,
    registry,
)
from dmlc_tpu_torch.params.env import get_env


def metrics_export_path() -> str:
    """Epoch-boundary registry export target (``DMLC_TPU_METRICS_EXPORT``;
    ``*.prom`` → Prometheus textfile, anything else → JSONL appends,
    empty = no file export)."""
    return get_env("DMLC_TPU_METRICS_EXPORT", "")


def _atomic_write(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def export_jsonl(path: str, reg: Optional[Registry] = None) -> None:
    """Append one snapshot line, atomically: the previous content plus
    the new line land via tmp + ``os.replace``, so a concurrent reader
    sees either the old file or the new one — never a torn tail."""
    reg = reg or registry()
    line = json.dumps({"ts_unix": time.time(), "metrics": reg.snapshot()})
    prev = ""
    try:
        with open(path) as fh:
            prev = fh.read()
    except FileNotFoundError:
        pass
    if prev and not prev.endswith("\n"):
        prev += "\n"
    _atomic_write(path, prev + line + "\n")


def _prom_labels(labelkey) -> str:
    if not labelkey:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (k, escape_label_value(v)) for k, v in labelkey
    )


def prometheus_lines(reg: Optional[Registry] = None) -> List[str]:
    """The registry rendered as Prometheus exposition lines (cumulative
    ``le`` buckets for histograms) — shared by the textfile exporter and
    a status server's ``/metrics`` handler."""
    reg = reg or registry()
    lines: List[str] = []
    for name, (kind, help_, children) in sorted(reg.families().items()):
        if help_:
            lines.append("# HELP %s %s" % (name, help_))
        lines.append("# TYPE %s %s" % (name, kind))
        for key, child in sorted(children.items()):
            if kind == "histogram":
                for le, acc in child.cumulative():
                    lk = key + (("le", le),)
                    lines.append("%s_bucket%s %d"
                                 % (name, _prom_labels(lk), acc))
                lines.append("%s_sum%s %s"
                             % (name, _prom_labels(key), child.sum))
                lines.append("%s_count%s %d"
                             % (name, _prom_labels(key), child.count))
            else:
                lines.append("%s%s %s"
                             % (name, _prom_labels(key), child.value))
    return lines


def export_prometheus(path: str, reg: Optional[Registry] = None) -> None:
    """Write the whole registry in Prometheus textfile format, atomically."""
    _atomic_write(path, "\n".join(prometheus_lines(reg)) + "\n")


def summary_line(prefix: Optional[str] = None,
                 reg: Optional[Registry] = None) -> str:
    """Compact one-line ``name=value`` summary (histograms as
    ``p50~<median>/<count>`` — a typical value beats a raw sum for
    eyeballing a log line), optionally filtered to names starting with
    ``prefix`` — the log-sink form for epoch boundaries."""
    reg = reg or registry()
    parts = []
    for name, (kind, _help, children) in sorted(reg.families().items()):
        if prefix and not name.startswith(prefix):
            continue
        for key, child in sorted(children.items()):
            flat = format_name(name, key)
            if kind == "histogram":
                parts.append("%s=p50~%g/%d"
                             % (flat, child.quantile(0.5), child.count))
            else:
                v = child.value
                parts.append("%s=%g" % (flat, v))
    return " ".join(parts)


def export_epoch(reg: Optional[Registry] = None,
                 log_prefix: Optional[str] = None) -> str:
    """Epoch-boundary export: write the ``DMLC_TPU_METRICS_EXPORT`` file
    (if configured), flush the active trace (if any), publish an obs
    heartbeat to the tracker (if running under an armed one), note the
    metric deltas in the flight recorder, and return the log-sink summary
    line (callers decide whether/at what level to log it). Export failures degrade to a summary-only return — telemetry
    must never fail a fit loop."""
    reg = reg or registry()
    path = metrics_export_path()
    if path:
        try:
            if path.endswith(".prom"):
                export_prometheus(path, reg)
            else:
                export_jsonl(path, reg)
        except OSError:
            pass
    try:
        trace.flush()
    except OSError:
        pass
    # the worker side of the status plane: metrics and spans ride a
    # tracker heartbeat; one cached check outside an armed tracker job
    from dmlc_tpu_torch.obs import flight, plane

    plane.publish_epoch()
    flight.recorder().note_metrics(reg)
    return summary_line(prefix=log_prefix, reg=reg)

"""dmlc_tpu_torch.obs — unified metrics and tracing (the port of
``dmlc_tpu/obs``, on the reference's metric names, span names, event kinds
and file formats).

- :func:`registry` — the process-wide label-aware Counter/Gauge/Histogram
  store every stage counter lives in (``DMLC_TPU_METRICS=0`` disables;
  obs/metrics.py)
- :func:`span` / :func:`step_span` — Chrome-trace spans gated by
  ``DMLC_TPU_TRACE=<path>`` (obs/trace.py); each live span is also a
  ``torch.profiler.record_function`` range
- :func:`new_flow` / :func:`flow_start` / :func:`flow_step` /
  :func:`flow_end` — causal dataflow arrows connecting a chunk's
  io_read → parse → stage → dispatch → consume → train_step journey across
  threads; :func:`current_flow` / :func:`set_current_flow` carry the
  in-flight chunk's id through the fit loop
- exporters — JSONL / Prometheus textfile / log-sink summary, driven at
  epoch boundaries by :func:`export_epoch` via ``DMLC_TPU_METRICS_EXPORT``
- :func:`cross_host_snapshot` / :func:`report_skew` — per-host
  min/median/max over a ``collective.DeviceEngine`` allreduce
- ``obs.flight`` — crash flight recorder dumped to
  ``flightrec-rank<k>.json`` when ``DMLC_TPU_FLIGHTREC`` names a directory
- ``obs.device_telemetry`` — :func:`instrumented_step` (the one-shape-per-
  bucket sentinel, the counterpart of the reference's ``instrumented_jit``),
  device-memory gauges, H2D metering, ``torch.profiler`` capture
  (``DMLC_TPU_DEVICE_TELEMETRY``)
- ``obs.xla_cost`` — per-site step cost records (flops, bytes accessed,
  peak bytes, collective bytes) and the measured device peaks
- ``obs.goodput`` — the runtime goodput ledger: per-window stage budgets,
  roofline attribution, and the binding-constraint verdict
- ``obs.watchdog`` — the in-run SLO watchdog over ledger windows
- ``obs.audit`` — the determinism audit: per-stage content-digest chains
  (io_read/parse/batch/model), epoch self-checks, ``audit-rank<k>.json``
  replay bundles (``DMLC_TPU_AUDIT``)

- ``obs.plane`` — the job-wide status plane: workers publish payloads on
  their tracker heartbeats, and the tracker serves them merged over HTTP
  (``DMLC_TPU_STATUS_PORT``; ``/profile`` captures ``torch.profiler`` in
  every publishing rank)

Metric names follow ``dmlc_<area>_<name>_<unit>``, and every
registered name is documented in docs/observability.md
(``tests/test_torch_metric_names.py``).
"""

from dmlc_tpu_torch.obs.aggregate import cross_host_snapshot, report_skew
from dmlc_tpu_torch.obs.device_telemetry import instrumented_step
from dmlc_tpu_torch.obs.goodput import GoodputLedger, attribute, ledger
from dmlc_tpu_torch.obs.watchdog import Watchdog, make_watchdog
from dmlc_tpu_torch.obs.exporters import (
    export_epoch,
    export_jsonl,
    export_prometheus,
    prometheus_lines,
    summary_line,
)
from dmlc_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    registry,
)
from dmlc_tpu_torch.obs.trace import (
    clear as clear_trace,
    current_flow,
    events as trace_events,
    flow_end,
    flow_start,
    flow_step,
    flush as flush_trace,
    new_flow,
    set_current_flow,
    span,
    step_span,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "registry",
    "span",
    "step_span",
    "new_flow",
    "flow_start",
    "flow_step",
    "flow_end",
    "current_flow",
    "set_current_flow",
    "trace_events",
    "clear_trace",
    "flush_trace",
    "export_epoch",
    "export_jsonl",
    "export_prometheus",
    "prometheus_lines",
    "summary_line",
    "cross_host_snapshot",
    "report_skew",
    "instrumented_step",
    "GoodputLedger",
    "attribute",
    "ledger",
    "Watchdog",
    "make_watchdog",
]

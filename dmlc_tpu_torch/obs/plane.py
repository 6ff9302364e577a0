"""Job-wide observability plane (the port of ``dmlc_tpu/obs/plane.py``,
on its wire bytes, JSON keys and endpoints): heartbeat piggyback and the
tracker's status server.

- **Worker side**: :class:`ObsPublisher` piggybacks a compact JSON payload
  (metric snapshot, span batch, clock probe, audit chains) onto the
  tracker ``heartbeat`` command behind the ``PAYLOAD_MARK`` suffix.
  Payloads are capped at ``DMLC_TPU_OBS_PAYLOAD_MAX`` bytes: the oldest
  spans go first, counted in ``dmlc_obs_spans_dropped_total``. Publishing
  is opt-in through ``DMLC_TPU_OBS_PUBLISH``, which the tracker exports
  only when its status plane is armed, so a worker never sends payloads to
  a tracker that does not read them. :func:`publish_epoch` is the hook
  ``obs.export_epoch`` calls at every epoch boundary.
- **Tracker side**: :class:`StatusPlane` keeps per-rank state and
  :class:`StatusServer` (stdlib ``http.server``, armed by
  ``DMLC_TPU_STATUS_PORT``) serves ``/healthz``, ``/workers`` (membership
  ``world_version``, the event log, rank -> last seen / lag / straggler),
  ``/metrics`` (Prometheus text merged across ranks), ``/trace`` (the
  job-wide Chrome trace), ``/data`` (an attached data dispatcher's
  lease view), ``/goodput`` (obs/goodput.py's attribution between
  consecutive metric snapshots), ``/audit`` (obs/audit.py's
  ``AuditPlane``), ``/xla`` (obs/xla_cost.py's per-site cost tables) and
  ``/profile``.
- **Clock skew**: each payload carries the worker's send time and its
  last heartbeat RTT; the tracker takes a rank's offset as
  ``recv - sent - rtt/2`` and rebases its spans onto the tracker's clock,
  so the merged trace is monotonic per rank and aligned across ranks.
- **Critical path**: :meth:`StatusPlane.stage_slack` sums span time per
  (stage, rank) into ``dmlc_job_stage_slack_ns{stage=}`` and
  ``dmlc_job_straggler_rank`` (a heartbeat-lag straggler wins over a
  span-slack one; -1 = none).
- **On-demand profiling**: ``GET /profile?seconds=N`` arms a job-wide
  request; the tracker sends it encoded on every heartbeat ack (a second
  int frame) and each publishing worker runs ``torch.profiler`` for the
  window (``obs.device_telemetry.capture_profile``), writing
  ``profile-rank<k>-req<n>/trace.json`` beside its flight-recorder dump.

With ``DMLC_TPU_STATUS_PORT`` unset the tracker binds no socket, starts no
thread and holds the shared :data:`NOOP_PLANE`; with
``DMLC_TPU_OBS_PUBLISH`` unset :func:`publish_epoch` is one early return.
None of these settings picks a kernel, a device or a route.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Deque, Dict, List, Optional, Tuple

from dmlc_tpu_torch.obs import audit, goodput, trace, xla_cost
from dmlc_tpu_torch.obs.exporters import prometheus_lines
from dmlc_tpu_torch.obs.metrics import Registry, registry
from dmlc_tpu_torch.params.env import get_env
from dmlc_tpu_torch.utils.logging import DMLCError

logger = logging.getLogger("dmlc_tpu_torch.obs.plane")

#: heartbeat tries an epoch's publish makes before it drops its batch
PUBLISH_ATTEMPTS = 3

PAYLOAD_MARK = "\nOBS1 "  # heartbeat-line suffix carrying the JSON payload

# /profile request encoding for the heartbeat-ack side channel: one i32,
# (req_id << PROFILE_SHIFT) | seconds. 0 = never requested. Workers act
# when the req_id part advances past the last one they served.
PROFILE_SHIFT = 12
PROFILE_MAX_S = (1 << PROFILE_SHIFT) - 1


def obs_publish_enabled() -> bool:
    """Whether this worker piggybacks obs payloads onto tracker
    heartbeats (``DMLC_TPU_OBS_PUBLISH``; the tracker exports it when its
    status plane is armed; default off)."""
    return get_env("DMLC_TPU_OBS_PUBLISH", False)


def obs_payload_max() -> int:
    """Byte cap of one heartbeat obs payload (``DMLC_TPU_OBS_PAYLOAD_MAX``,
    default 64 KiB, floor 1 KiB so liveness and the clock probe fit)."""
    return max(1024, get_env("DMLC_TPU_OBS_PAYLOAD_MAX", 65536))


def encode_profile_word(req_id: int, seconds: int) -> int:
    return (int(req_id) << PROFILE_SHIFT) | max(
        0, min(int(seconds), PROFILE_MAX_S))


def decode_profile_word(word: int) -> Tuple[int, int]:
    """→ ``(req_id, seconds)``; any non-positive word decodes to (0, 0)."""
    word = int(word)
    if word <= 0:
        return 0, 0
    return word >> PROFILE_SHIFT, word & PROFILE_MAX_S


# ---------------------------------------------------------------------------
# Worker side: payload building + publisher
# ---------------------------------------------------------------------------


def build_payload(
    rank: int,
    epoch: int = -1,
    spans: Optional[List[Dict]] = None,
    reg: Optional[Registry] = None,
    max_bytes: Optional[int] = None,
    rtt_ns: int = 0,
) -> Tuple[str, int]:
    """Serialize one obs heartbeat payload, honoring the size cap.

    Returns ``(json_blob, spans_dropped)``. Oldest spans are shed first
    (halving until the blob fits); if metrics alone still exceed the cap
    they are dropped too — liveness plus the clock probe always fit.
    """
    reg = reg or registry()
    cap = max_bytes if max_bytes is not None else obs_payload_max()
    spans = list(spans or ())
    dropped = 0
    obj = {
        "v": 1,
        "rank": int(rank),
        "epoch": int(epoch),
        "sent_unix_ns": time.time_ns(),
        "rtt_ns": int(rtt_ns),
        "anchor_unix_ns": trace.anchor_unix_ns(),
        "metrics": reg.flat_values(),
        "spans": spans,
        "spans_dropped": 0,
    }
    # determinism-audit chains ride the same payload (obs/audit.py);
    # the key is omitted entirely when audit is off or nothing was
    # digested, so pre-audit payloads stay byte-stable
    audit_obj = audit.auditor().export()
    if audit_obj:
        obj["audit"] = audit_obj
    blob = json.dumps(obj, separators=(",", ":"))
    while len(blob) > cap and obj["spans"]:
        shed = max(1, len(obj["spans"]) // 2)
        dropped += shed
        obj["spans"] = obj["spans"][shed:]
        obj["spans_dropped"] = dropped
        blob = json.dumps(obj, separators=(",", ":"))
    if len(blob) > cap and obj.get("audit"):
        # shed the chain windows before the metrics: heads + totals
        # still let the tracker spot length drift
        for chain in obj["audit"]["chains"].values():
            chain["d"] = []
        blob = json.dumps(obj, separators=(",", ":"))
    if len(blob) > cap and obj["metrics"]:
        obj["metrics"] = {}
        blob = json.dumps(obj, separators=(",", ":"))
    if dropped:
        registry().counter(
            "dmlc_obs_spans_dropped_total",
            "spans shed by the heartbeat payload size cap").inc(dropped)
    return blob, dropped


class ObsPublisher:
    """Worker-side publisher: batches spans via a trace listener and
    ships them (plus a metric snapshot) on tracker heartbeats.

    Publishing is best-effort: a heartbeat whose dial or handshake fails
    with a transient error (a refused, reset or timed-out connection, as
    a loaded host gives) dials again under a ``resilience.RetryPolicy`` at
    site ``obs.publish`` (up to :data:`PUBLISH_ATTEMPTS` tries within the
    call's ``timeout``; each retry counts in
    ``dmlc_retry_attempts_total{site="obs.publish"}``). A failure after
    the payload frame was sent is not retried, since the tracker may
    already have noted it. A publish that fails drops that batch with a
    warning and counts in :attr:`dropped` — telemetry must never wedge a training loop. The measured send→ack RTT
    (a retried dial's wait included) rides in the *next* payload as the
    tracker's skew probe."""

    def __init__(
        self,
        tracker_uri: str,
        tracker_port: int,
        rank: int,
        reg: Optional[Registry] = None,
        max_spans: int = 4096,
        job: Optional[str] = None,
    ):
        self.tracker_uri = tracker_uri
        self.tracker_port = int(tracker_port)
        self.rank = int(rank)
        # multi-tenant fleets: the data-service job this rank consumes;
        # rides every heartbeat as a "job=<name>" token so obs-top /
        # obs-report group per-rank tables by tenant
        self.job = str(job) if job else None
        self._reg = reg
        self._spans: Deque[Dict] = collections.deque(maxlen=max_spans)
        self._rtt_ns = 0
        self._m_publishes = registry().counter(
            "dmlc_obs_publishes_total",
            "obs heartbeat payloads published to the tracker")
        self.dropped = 0  # publishes that failed and dropped their batch
        self._profile_seen = 0
        trace.add_listener(self._on_span)

    def _on_span(self, event: Dict) -> None:
        self._spans.append(event)

    def publish(self, epoch: int = -1, timeout: float = 10.0) -> bool:
        from dmlc_tpu_torch.obs import device_telemetry
        from dmlc_tpu_torch.tracker.rendezvous import send_heartbeat

        # refresh the card's memory gauges so every payload carries the
        # current device picture (no-op when telemetry is off)
        try:
            device_telemetry.sample(self._reg)
        except Exception:  # noqa: BLE001 - telemetry must not block publish
            pass
        spans: List[Dict] = []
        while True:
            try:
                spans.append(self._spans.popleft())
            except IndexError:
                break
        blob, _ = build_payload(
            rank=self.rank, epoch=epoch, spans=spans, reg=self._reg,
            rtt_ns=self._rtt_ns,
        )
        from dmlc_tpu_torch.resilience import RetryPolicy

        # only the dial and the handshake are retried: the tracker notes a
        # payload once it has read it, so a resend would count it twice
        policy = RetryPolicy(max_attempts=PUBLISH_ATTEMPTS, base_s=0.05,
                             cap_s=0.5, deadline_s=timeout)
        t0 = time.monotonic_ns()
        try:
            _, profile_word = send_heartbeat(
                self.tracker_uri, self.tracker_port, self.rank, epoch=epoch,
                metrics=(f"job={self.job}" if self.job else ""),
                obs_json=blob, timeout=timeout, want_profile=True,
                retry=policy, retry_site="obs.publish")
        except (OSError, ValueError, DMLCError) as err:
            self.dropped += 1
            logger.warning("obs publish of epoch %d dropped: %s", epoch,
                           str(err).split("\n\nStack trace:")[0])
            return False
        self._rtt_ns = time.monotonic_ns() - t0
        self._m_publishes.inc()
        self._maybe_capture(profile_word)
        return True

    def _maybe_capture(self, profile_word: int) -> None:
        """Serve a ``/profile`` request seen in the heartbeat ack: a req_id
        past the last one served (with seconds > 0) starts one background
        ``torch.profiler`` capture (``device_telemetry.capture_profile``:
        on a machine with a card a failed start raises here)."""
        req_id, seconds = decode_profile_word(profile_word)
        if req_id <= self._profile_seen:
            return
        self._profile_seen = req_id
        if seconds <= 0:
            return
        from dmlc_tpu_torch.obs import device_telemetry

        logger.info(
            "profile request %d: capturing %ds (rank %d)",
            req_id, seconds, self.rank)
        device_telemetry.capture_profile(seconds, req_id=req_id)

    def close(self) -> None:
        trace.remove_listener(self._on_span)


_DEFAULT_LOCK = threading.Lock()
_DEFAULT_PUBLISHER: Optional[ObsPublisher] = None
_DEFAULT_INIT = False
_EPOCH_SEQ = 0


def default_publisher() -> Optional[ObsPublisher]:
    """The env-configured publisher for this worker process, or None.

    Built once from ``DMLC_TRACKER_URI``/``PORT`` + ``DMLC_TASK_ID`` when
    the tracker advertised ``DMLC_TPU_OBS_PUBLISH`` (status plane armed);
    None everywhere else — the disabled path is one cached check."""
    global _DEFAULT_PUBLISHER, _DEFAULT_INIT
    if _DEFAULT_INIT:
        return _DEFAULT_PUBLISHER
    with _DEFAULT_LOCK:
        if _DEFAULT_INIT:
            return _DEFAULT_PUBLISHER
        uri = os.environ.get("DMLC_TRACKER_URI")
        if uri and obs_publish_enabled():
            try:
                _DEFAULT_PUBLISHER = ObsPublisher(
                    uri,
                    int(os.environ.get("DMLC_TRACKER_PORT", "0") or 0),
                    int(os.environ.get("DMLC_TASK_ID", "0") or 0),
                )
            except ValueError:
                _DEFAULT_PUBLISHER = None
        _DEFAULT_INIT = True
        return _DEFAULT_PUBLISHER


def publish_epoch() -> bool:
    """Epoch-boundary publish through the default publisher (the hook
    ``obs.export_epoch`` calls). No-op outside an armed tracker job."""
    global _EPOCH_SEQ
    pub = default_publisher()
    if pub is None:
        return False
    with _DEFAULT_LOCK:
        _EPOCH_SEQ += 1
        epoch = _EPOCH_SEQ
    return pub.publish(epoch=epoch)


def reset_default_publisher() -> None:
    """Forget the cached env publisher (tests; env changed)."""
    global _DEFAULT_PUBLISHER, _DEFAULT_INIT, _EPOCH_SEQ
    with _DEFAULT_LOCK:
        if _DEFAULT_PUBLISHER is not None:
            _DEFAULT_PUBLISHER.close()
        _DEFAULT_PUBLISHER = None
        _DEFAULT_INIT = False
        _EPOCH_SEQ = 0


# ---------------------------------------------------------------------------
# Tracker side: per-rank state, skew rebase, analysis
# ---------------------------------------------------------------------------


class _WorkerView:
    __slots__ = ("rank", "last_seen_unix", "info", "epoch", "anchor_unix_ns",
                 "offset_ns", "rtt_ns", "metrics", "spans", "spans_dropped",
                 "payloads", "metrics_recv_unix_ns", "goodput")

    def __init__(self, rank: int, max_spans: int):
        self.rank = rank
        self.last_seen_unix = 0.0
        self.info = ""
        self.epoch = -1
        self.anchor_unix_ns: Optional[int] = None
        self.offset_ns = 0
        self.rtt_ns = 0
        self.metrics: Dict[str, float] = {}
        self.spans: Deque[Dict] = collections.deque(maxlen=max_spans)
        self.spans_dropped = 0
        self.payloads = 0
        # goodput attribution between consecutive metric snapshots
        # (obs/goodput.py — the same code path every surface renders)
        self.metrics_recv_unix_ns = 0
        self.goodput: Optional[Dict] = None


def _split_flat(flat: str) -> Tuple[str, str]:
    """``name{a="b"}`` → ``("name", 'a="b"')``; histogram ``:sum`` /
    ``:count`` scalars become Prometheus-legal ``_sum``/``_count``.
    The suffix sits at the very end of the flat key — after the ``}`` of
    a labeled family (``name{a="b"}:sum``), directly on the name of an
    unlabeled one (``name:sum``) — so strip it first, then split."""
    suffix = ""
    for s in (":sum", ":count"):
        if flat.endswith(s):
            flat = flat[: -len(s)]
            suffix = "_" + s[1:]
            break
    name, _, rest = flat.partition("{")
    labels = rest[:-1] if rest.endswith("}") else ""
    return name + suffix, labels


class StatusPlane:
    """Tracker-side accumulator behind the status server endpoints."""

    def __init__(self, num_workers: int = 0, heartbeat_gap: float = 60.0,
                 max_spans_per_rank: int = 20000):
        self.num_workers = int(num_workers)
        self.heartbeat_gap = float(heartbeat_gap)
        self._max_spans = int(max_spans_per_rank)
        self._lock = threading.Lock()
        self._views: Dict[int, _WorkerView] = {}
        self._start_unix = time.time()
        self._g_straggler = registry().gauge(
            "dmlc_job_straggler_rank",
            "rank currently flagged as the job straggler (-1 = none)")
        self._g_straggler.set(-1)
        # elastic membership: generation counter + transition log
        self.world_version = 0
        self._events: Deque[Dict] = collections.deque(maxlen=512)
        # on-demand profiling: /profile?seconds=N bumps the request id;
        # the encoded word rides every heartbeat ack until superseded
        self._profile_req = 0
        self._profile_seconds = 0
        self._g_world = registry().gauge(
            "dmlc_tracker_world_version",
            "current membership generation committed by the tracker")
        self._g_world.set(0)
        # fault-tolerant data service (data/dispatcher.py): a snapshot
        # provider installed by DataDispatcher.attach_plane backs /data
        self._data_provider = None
        # determinism audit: cross-rank chain comparison behind /audit
        # (obs/audit.py; idle until a payload carries an "audit" key)
        self.audit = audit.AuditPlane()

    def _view(self, rank: int) -> _WorkerView:
        view = self._views.get(rank)
        if view is None:
            view = self._views[rank] = _WorkerView(rank, self._max_spans)
        return view

    # ---- ingestion (called by the tracker's heartbeat path) ------------
    def note_live(self, rank: int, when_unix: float, info: str) -> None:
        with self._lock:
            view = self._view(rank)
            view.last_seen_unix = when_unix
            view.info = info

    def note_payload(self, rank: int, obj: Dict, recv_unix_ns: int) -> None:
        if not isinstance(obj, dict):
            return
        with self._lock:
            view = self._view(rank)
            view.payloads += 1
            view.epoch = int(obj.get("epoch", view.epoch) or -1)
            anchor = obj.get("anchor_unix_ns")
            if anchor is not None:
                view.anchor_unix_ns = int(anchor)
            rtt = int(obj.get("rtt_ns", 0) or 0)
            if rtt > 0:
                view.rtt_ns = rtt
            sent = obj.get("sent_unix_ns")
            if sent:
                # RTT-midpoint skew estimate: worker clock + offset ≈ ours
                view.offset_ns = recv_unix_ns - int(sent) - view.rtt_ns // 2
            metrics = obj.get("metrics")
            if isinstance(metrics, dict) and metrics:
                # attribute the delta between consecutive snapshots —
                # the per-rank half of the /goodput endpoint (the job
                # roll-up re-derives from these via goodput.rolled)
                prev = view.metrics
                prev_ns = view.metrics_recv_unix_ns
                if prev and prev_ns and recv_unix_ns > prev_ns:
                    view.goodput = goodput.attribute(
                        goodput.flat_delta(metrics, prev),
                        (recv_unix_ns - prev_ns) / 1e9,
                        current=metrics)
                view.metrics = dict(metrics)
                view.metrics_recv_unix_ns = recv_unix_ns
            spans = obj.get("spans")
            if isinstance(spans, list):
                view.spans.extend(
                    e for e in spans if isinstance(e, dict) and "ts" in e)
            view.spans_dropped += int(obj.get("spans_dropped", 0) or 0)
        audit_obj = obj.get("audit")
        if audit_obj:
            self.audit.note_audit(rank, audit_obj)
        self.stage_slack()  # refresh straggler/slack gauges as data lands

    def note_membership(self, kind: str, **fields) -> None:
        """Record one membership transition (``join`` / ``evict`` /
        ``rebuild``) for the ``/workers`` event log; a ``world_version``
        field also advances the generation gauge."""
        event = dict(fields, kind=kind, unix=round(time.time(), 3))
        with self._lock:
            self._events.append(event)
            if "world_version" in fields:
                self.world_version = int(fields["world_version"])
        if "world_version" in fields:
            self._g_world.set(int(fields["world_version"]))

    def request_profile(self, seconds: int) -> Dict:
        """Arm a job-wide profiler capture request (the ``/profile``
        endpoint). Every worker that heartbeats with ``want_profile``
        sees the new request id in its ack and captures once."""
        seconds = max(1, min(int(seconds), PROFILE_MAX_S))
        with self._lock:
            self._profile_req += 1
            self._profile_seconds = seconds
            req = self._profile_req
        logger.info("profile capture requested: %ds (req %d)", seconds, req)
        return {"profile_req": req, "seconds": seconds}

    def profile_word(self) -> int:
        """The current request encoded for the heartbeat-ack side channel
        (0 = never requested)."""
        with self._lock:
            if not self._profile_req:
                return 0
            return encode_profile_word(self._profile_req,
                                       self._profile_seconds)

    def set_data_provider(self, fn) -> None:
        """Install the data-dispatcher snapshot callable behind ``/data``
        (``DataDispatcher.attach_plane``). Latest wins — one dispatcher
        per epoch, same lifecycle as the service."""
        self._data_provider = fn

    def data_view(self) -> Dict:
        """The ``/data`` body: live worker/lease/requeue view from the
        attached dispatcher, or ``{"attached": false}`` when no data
        service is running behind this tracker."""
        fn = self._data_provider
        if fn is None:
            return {"attached": False}
        try:
            return dict(fn(), attached=True)
        except Exception as err:  # noqa: BLE001 — a dying dispatcher must
            # not take the status server down with it
            return {"attached": True, "error": str(err)}

    def audit_view(self) -> Dict:
        """The ``/audit`` body: per-rank chain summaries and the
        cross-rank fork table (obs/audit.py AuditPlane.view)."""
        return self.audit.view()

    def goodput_view(self) -> Dict:
        """The ``/goodput`` body: per-rank attribution windows plus the
        job roll-up, all produced by obs/goodput.py's one code path
        (``attribute`` per rank in :meth:`note_payload`, ``rolled``
        across ranks here). Ranks appear once two metric snapshots have
        landed (a window needs a delta)."""
        with self._lock:
            per_rank = {
                str(rank): v.goodput
                for rank, v in sorted(self._views.items())
                if v.goodput is not None
            }
        return {
            "ranks": per_rank,
            "job": goodput.rolled(list(per_rank.values())),
        }

    def xla_view(self) -> Dict:
        """The ``/xla`` body: per-rank compiled-program cost tables plus
        this process's own record cache.

        ``ranks`` is parsed back out of each worker's latest flat metric
        snapshot (the ``dmlc_xla_*{fn=}`` gauges ride the heartbeat like
        every other metric — no new wire field), keyed rank → jit site →
        {flops, bytes_accessed, peak_bytes, collective_bytes};
        ``local`` is obs/xla_cost.py's in-process view (per-site latest
        records with bucket counts, plus the extraction count) for
        single-process runs and the tracker's own jits."""
        with self._lock:
            per_rank = {
                str(rank): sites
                for rank, v in sorted(self._views.items())
                for sites in (xla_cost.sites_from_flat(v.metrics),)
                if sites
            }
        return {"ranks": per_rank, "local": xla_cost.detail_section()}

    def membership(self) -> Dict:
        """``{"world_version": N, "events": [...]}`` — the elastic half of
        the ``/workers`` response."""
        with self._lock:
            return {
                "world_version": self.world_version,
                "events": list(self._events),
            }

    # ---- read side (HTTP handlers, obs-report) -------------------------
    def health(self) -> Dict:
        with self._lock:
            seen = len(self._views)
        return {
            "status": "ok",
            "workers_seen": seen,
            "workers_expected": self.num_workers,
            "uptime_s": round(time.time() - self._start_unix, 3),
        }

    def workers(self) -> Dict[str, Dict]:
        now = time.time()
        with self._lock:
            out = {}
            for rank, v in sorted(self._views.items()):
                lag = now - v.last_seen_unix if v.last_seen_unix else None
                out[str(rank)] = {
                    "last_seen_unix": v.last_seen_unix,
                    "lag_s": round(lag, 3) if lag is not None else None,
                    "straggler": bool(
                        lag is not None and lag > self.heartbeat_gap),
                    "epoch": v.epoch,
                    "info": v.info,
                    "clock_offset_ns": v.offset_ns,
                    "rtt_ns": v.rtt_ns,
                    "spans": len(v.spans),
                    "spans_dropped": v.spans_dropped,
                    "payloads": v.payloads,
                }
        return out

    def merged_trace(self) -> Dict:
        """Job-wide Chrome trace: every rank's spans rebased onto the
        tracker clock (anchor + ts, minus the skew offset estimate) and
        merged; ``pid`` is the rank, so Perfetto shows one process row
        per worker."""
        with self._lock:
            per_rank = [
                (rank, v.anchor_unix_ns, v.offset_ns, list(v.spans))
                for rank, v in sorted(self._views.items())
            ]
        stamped: List[Tuple[int, Dict, int]] = []
        offsets: Dict[str, int] = {}
        for rank, anchor, offset, spans in per_rank:
            if anchor is None:
                continue
            offsets[str(rank)] = offset
            for e in spans:
                abs_ns = anchor + int(e["ts"] * 1e3) + offset
                stamped.append((abs_ns, e, rank))
        stamped.sort(key=lambda item: item[0])
        base_ns = stamped[0][0] if stamped else 0
        events = []
        for abs_ns, e, rank in stamped:
            out = dict(e)
            out["ts"] = (abs_ns - base_ns) / 1e3
            out["pid"] = rank
            events.append(out)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "merged": True,
                "base_unix_ns": base_ns,
                "clock": "tracker",
                "offsets_ns": offsets,
            },
        }

    def stage_slack(self) -> Dict[str, Dict]:
        """Per-stage cross-rank slack from the merged spans.

        For each span name, sums duration per rank; slack is the
        max−min spread (the straggler's surplus on that stage). Updates
        ``dmlc_job_stage_slack_ns{stage=}`` and
        ``dmlc_job_straggler_rank`` (a heartbeat-lag straggler, if any,
        wins over the span-slack candidate)."""
        now = time.time()
        with self._lock:
            per_stage: Dict[str, Dict[int, float]] = {}
            lag_straggler = -1
            worst_lag = self.heartbeat_gap
            for rank, v in self._views.items():
                if v.last_seen_unix and now - v.last_seen_unix > worst_lag:
                    worst_lag = now - v.last_seen_unix
                    lag_straggler = rank
                for e in v.spans:
                    if e.get("ph") not in (None, "X"):
                        continue  # flow points carry no duration
                    per_stage.setdefault(e.get("name", "?"), {}).setdefault(
                        rank, 0.0)
                    per_stage[e.get("name", "?")][rank] += float(
                        e.get("dur", 0.0))
        out: Dict[str, Dict] = {}
        slack_straggler, widest = -1, 0.0
        reg = registry()
        for name, per_rank in sorted(per_stage.items()):
            mx_rank = max(per_rank, key=lambda r: per_rank[r])
            slack_us = per_rank[mx_rank] - min(per_rank.values())
            out[name] = {
                "slack_us": slack_us,
                "max_rank": mx_rank,
                "per_rank_us": {str(r): v for r, v in sorted(
                    per_rank.items())},
            }
            reg.gauge(
                "dmlc_job_stage_slack_ns",
                "cross-rank span-time spread per stage (max-min)",
                stage=name).set(slack_us * 1e3)
            if len(per_rank) > 1 and slack_us > widest:
                widest, slack_straggler = slack_us, mx_rank
        straggler = lag_straggler if lag_straggler >= 0 else slack_straggler
        self._g_straggler.set(straggler)
        return out

    def merged_metrics_text(self, reg: Optional[Registry] = None) -> str:
        """Prometheus exposition: the tracker's own registry (via the
        existing exporter) plus every rank's flat metrics re-labeled with
        ``rank=`` (worker values export as-is; their kind lives in the
        worker process)."""
        lines = prometheus_lines(reg)
        with self._lock:
            per_rank = [
                (rank, dict(v.metrics))
                for rank, v in sorted(self._views.items()) if v.metrics
            ]
        if per_rank:
            lines.append("# worker metrics merged from heartbeat payloads")
        for rank, metrics in per_rank:
            for flat, value in sorted(metrics.items()):
                name, labels = _split_flat(flat)
                labels = (labels + "," if labels else "") + 'rank="%d"' % rank
                lines.append("%s{%s} %g" % (name, labels, value))
        return "\n".join(lines) + "\n"


class _NoopPlane:
    """Shared disabled plane (``DMLC_TPU_STATUS_PORT`` unset): ingestion
    is two empty method calls, mirroring the no-op metrics child."""

    __slots__ = ()

    def note_live(self, rank, when_unix, info):
        pass

    def note_payload(self, rank, obj, recv_unix_ns):
        pass

    def note_membership(self, kind, **fields):
        pass

    def profile_word(self):
        return 0

    def set_data_provider(self, fn):
        pass


NOOP_PLANE = _NoopPlane()


# ---------------------------------------------------------------------------
# HTTP status server (stdlib only)
# ---------------------------------------------------------------------------


class _StatusHandler(BaseHTTPRequestHandler):
    server_version = "dmlc-tpu-status/1"

    def do_GET(self):  # noqa: N802 (http.server API)
        plane: StatusPlane = self.server.plane  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/healthz":
                body = json.dumps(plane.health()).encode()
                ctype = "application/json"
            elif path == "/workers":
                body = json.dumps(
                    dict(plane.membership(), workers=plane.workers())
                ).encode()
                ctype = "application/json"
            elif path == "/metrics":
                body = plane.merged_metrics_text().encode()
                ctype = "text/plain; version=0.0.4"
            elif path == "/trace":
                body = json.dumps(plane.merged_trace()).encode()
                ctype = "application/json"
            elif path == "/data":
                body = json.dumps(plane.data_view()).encode()
                ctype = "application/json"
            elif path == "/goodput":
                body = json.dumps(plane.goodput_view()).encode()
                ctype = "application/json"
            elif path == "/audit":
                body = json.dumps(plane.audit_view()).encode()
                ctype = "application/json"
            elif path == "/xla":
                body = json.dumps(plane.xla_view()).encode()
                ctype = "application/json"
            elif path == "/profile":
                from urllib.parse import parse_qs

                query = parse_qs(self.path.partition("?")[2])
                try:
                    seconds = int(query.get("seconds", ["5"])[0])
                except ValueError:
                    self.send_error(400, "seconds must be an integer")
                    return
                if seconds <= 0:
                    self.send_error(400, "seconds must be > 0")
                    return
                body = json.dumps(plane.request_profile(seconds)).encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown endpoint %r" % path)
                return
        except Exception as err:  # a broken handler must not kill the plane
            self.send_error(500, "status handler failed: %s" % err)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        logger.debug("status http: " + fmt, *args)


class StatusServer:
    """The opt-in tracker HTTP endpoint (``DMLC_TPU_STATUS_PORT``).

    ``port=0`` binds an ephemeral port (tests); the bound port is
    exposed as :attr:`port` and advertised to workers via
    ``DMLC_TPU_STATUS_URI``."""

    def __init__(self, plane: StatusPlane, port: int, host: str = ""):
        self._httpd = ThreadingHTTPServer((host, int(port)), _StatusHandler)
        self._httpd.plane = plane  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="dmlc-status-http",
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

"""In-run SLO watchdog over goodput ledger windows (the port of
``dmlc_tpu/obs/watchdog.py``: the same alert kinds, bands and re-arm).

The tf.data fleet paper's core observation is that jobs silently run
input-bound; the at-scale MLPerf runs live or die by catching
input/step imbalance *while the job is running*. This module is the
live tripwire: the fit loops (models/fitloop.py) feed it one goodput
window per epoch (obs/goodput.py), and it fires on four shapes:

- ``collapse``        — window throughput falls below the rolling
  median − max(rel_tol·|median|, mad_mult·MAD) band over recent healthy
  windows (the same robust gate math as obs/sentry.py, applied in-run);
- ``recompile_storm`` — ``dmlc_xla_recompiles_total`` moved by at least
  ``recompile_limit`` within one window (new shapes reaching an
  instrumented step after its warmup, obs/device_telemetry.py);
- ``stall``           — no ledger progress (steps/batches/bytes all
  flat) for ``DMLC_TPU_WATCHDOG_STALL_S`` cumulative seconds
  (0 disables);
- ``straggler``       — a straggler rank was flagged
  (``dmlc_job_straggler_rank`` ≥ 0; the reference's status plane sets
  it, which the port does not have yet);
- ``numeric``         — the determinism auditor's numeric-health
  sentinel saw non-finite values in the epoch loss or the strided
  parameter sample it already fetches for the model digest chain
  (obs/audit.py; the fit loop stamps the count onto the window as
  ``nonfinite``).

Each kind fires **once** per excursion: on firing it emits one
``watchdog.alert`` flight-recorder event, bumps
``dmlc_watchdog_alerts_total{kind=}``, logs a warning, and optionally
triggers the on-demand device profiler for the regression window
(``DMLC_TPU_WATCHDOG_PROFILE=1`` → device_telemetry.capture_profile).
The kind then stays disarmed until its condition clears — the same
re-arm hysteresis as the reference plane's straggler flag, so a sustained
collapse produces one alert, not an alert storm. Collapsed windows are
kept out of the rolling baseline so the band cannot erode into
accepting the regression.

Under ``DMLC_TPU_METRICS=0`` :func:`make_watchdog` returns the shared
no-op child (metrics.NOOP) — ``observe()`` is one empty method call.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from dmlc_tpu_torch.obs import sentry
from dmlc_tpu_torch.obs.flight import record_event
from dmlc_tpu_torch.obs.metrics import NOOP, Registry, metrics_enabled, registry
from dmlc_tpu_torch.params.env import get_env

logger = logging.getLogger("dmlc_tpu_torch.obs.watchdog")


def watchdog_stall_s() -> float:
    """Cumulative seconds without goodput-ledger progress before a
    ``stall`` alert (``DMLC_TPU_WATCHDOG_STALL_S``, default 60; 0 = off)."""
    return max(0.0, float(get_env("DMLC_TPU_WATCHDOG_STALL_S", 60.0)))


def watchdog_profile() -> bool:
    """Whether a firing watchdog starts the on-demand profiler capture
    (``DMLC_TPU_WATCHDOG_PROFILE``, default off)."""
    return get_env("DMLC_TPU_WATCHDOG_PROFILE", False)

#: alert kinds, in evaluation order
KINDS = ("collapse", "recompile_storm", "stall", "straggler", "numeric")

#: collapse gate defaults: the sentry window/MAD machinery, with a wider
#: relative band — epoch windows are noisier than bench rounds
DEFAULT_REL_TOL = 0.25
DEFAULT_RECOMPILE_LIMIT = 3


class Watchdog:
    """Rolling median±MAD SLO gate over ledger windows (construct via
    :func:`make_watchdog`)."""

    def __init__(self, reg: Optional[Registry] = None,
                 window: int = sentry.DEFAULT_WINDOW,
                 rel_tol: float = DEFAULT_REL_TOL,
                 mad_mult: float = sentry.DEFAULT_MAD_MULT,
                 min_samples: int = sentry.DEFAULT_MIN_SAMPLES,
                 stall_s: Optional[float] = None,
                 recompile_limit: int = DEFAULT_RECOMPILE_LIMIT,
                 profile: Optional[bool] = None,
                 profile_seconds: float = 3.0):
        self._reg = reg if reg is not None else registry()
        self._window = int(window)
        self._rel_tol = float(rel_tol)
        self._mad_mult = float(mad_mult)
        self._min_samples = int(min_samples)
        self._stall_s = (watchdog_stall_s() if stall_s is None
                         else float(stall_s))
        self._recompile_limit = int(recompile_limit)
        self._profile = (watchdog_profile() if profile is None
                         else bool(profile))
        self._profile_seconds = float(profile_seconds)
        self._capture = None  # the running profile capture's thread
        self._armed = {kind: True for kind in KINDS}
        self._signal_hist: List[float] = []
        self._stalled_s = 0.0
        self.alerts: List[Dict] = []

    # ---- firing / re-arm ----------------------------------------------
    def _fire(self, kind: str, **fields) -> Optional[Dict]:
        if not self._armed[kind]:
            return None
        self._armed[kind] = False
        alert = dict(fields, kind=kind)
        # the flight event's own kind is "watchdog.alert"; the alert
        # kind rides as the ``alert`` field
        record_event("watchdog.alert", **dict(fields, alert=kind))
        self._reg.counter(
            "dmlc_watchdog_alerts_total", "SLO watchdog alerts fired",
            kind=kind).inc()
        logger.warning("watchdog: %s alert %s", kind, fields)
        if self._profile:
            from dmlc_tpu_torch.obs import device_telemetry

            self._capture = device_telemetry.capture_profile(
                self._profile_seconds) or self._capture
        self.alerts.append(alert)
        return alert

    def _clear(self, kind: str) -> None:
        self._armed[kind] = True

    # ---- window evaluation --------------------------------------------
    @staticmethod
    def _signal(win: Dict) -> float:
        g = win.get("goodput", {})
        rows_s = float(g.get("rows_s", 0.0))
        return rows_s if rows_s > 0.0 else float(g.get("mbps", 0.0))

    def observe(self, win: Dict) -> List[Dict]:
        """Evaluate one ledger window; returns the alerts fired by it
        (usually empty). A profile capture an earlier alert started is
        joined once it has ended, so its error on the card reaches the fit
        loop here."""
        if self._capture is not None and not self._capture.is_alive():
            capture, self._capture = self._capture, None
            capture.join()
        fired: List[Dict] = []

        def note(alert):
            if alert is not None:
                fired.append(alert)

        # collapse: fresh signal vs rolling baseline over healthy windows
        signal = self._signal(win)
        hist = self._signal_hist[-self._window:]
        collapsed = False
        if len(hist) >= self._min_samples:
            med = sentry._median(hist)
            tol = max(self._rel_tol * abs(med),
                      self._mad_mult * sentry._mad(hist, med))
            if signal < med - tol:
                collapsed = True
                note(self._fire(
                    "collapse", signal=round(signal, 3),
                    baseline=round(med, 3), tolerance=round(tol, 3),
                    binding=win.get("binding")))
        if not collapsed:
            # collapsed windows stay out of their own baseline, so a
            # sustained regression cannot erode the band and re-fire
            self._clear("collapse")
            self._signal_hist.append(signal)
            del self._signal_hist[:-max(self._window * 4, 16)]

        counters = win.get("counters", {})
        # recompile storm
        recompiles = float(counters.get("recompiles", 0.0))
        if recompiles >= self._recompile_limit:
            note(self._fire("recompile_storm", recompiles=int(recompiles)))
        else:
            self._clear("recompile_storm")

        # stall: no forward progress across windows spanning stall_s
        progress = (float(counters.get("steps", 0.0))
                    + float(counters.get("batches", 0.0))
                    + float(counters.get("bytes", 0.0)))
        if progress <= 0.0:
            self._stalled_s += float(win.get("window_s", 0.0))
            if self._stall_s > 0.0 and self._stalled_s >= self._stall_s:
                note(self._fire(
                    "stall", stalled_s=round(self._stalled_s, 3)))
        else:
            self._stalled_s = 0.0
            self._clear("stall")

        # straggler rank flagged (dmlc_job_straggler_rank)
        rank = int(win.get("straggler_rank", -1))
        if rank >= 0:
            note(self._fire("straggler", rank=rank))
        else:
            self._clear("straggler")

        # numeric health: non-finite loss/param-sample values stamped
        # onto the window by the fit loop's audit hook
        nonfinite = int(win.get("nonfinite", 0) or 0)
        if nonfinite > 0:
            note(self._fire("numeric", nonfinite=nonfinite))
        else:
            self._clear("numeric")
        return fired


def make_watchdog(reg: Optional[Registry] = None, **kwargs):
    """A :class:`Watchdog`, or the shared no-op child when the metrics
    registry is disabled (``DMLC_TPU_METRICS=0``)."""
    if not metrics_enabled():
        return NOOP
    return Watchdog(reg, **kwargs)

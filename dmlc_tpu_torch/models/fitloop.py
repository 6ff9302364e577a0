"""Shared fit-loop observability: one epoch-boundary helper for every
learner (the port of ``dmlc_tpu/models/fitloop.py``).

:class:`FitLoopObs` registers the four ``dmlc_fit_*`` metrics, observes
the epoch histogram, closes one goodput-ledger window an epoch
(obs/goodput.py) and feeds it to the SLO watchdog (obs/watchdog.py),
extends the audit's model chain, logs the unified epoch line (the feed's
stall breakdown, goodput and the binding stage) and exports the
registry, inside an ``end_epoch`` span, after resolving the epoch's
device spans (``obs.device_span``). linear, FM and GBDT all funnel
through it, so the epoch log line and the binding-constraint verdict are
uniform across models.

Usage::

    fl = FitLoopObs("linear")
    for epoch in range(epochs):
        t0 = time.monotonic_ns()
        for batch in feed:
            ...
            fl.note_step()
            fl.sample_latency(metrics)
        fl.end_epoch(epoch, nstep, t0, loss, feed=feed,
                     log_every=log_every)

It also owns the sampled device-step latency probe: every
``DMLC_TPU_STEP_SAMPLE_N``-th step (default 64) :meth:`sample_latency`
times one ``torch.cuda.current_stream(dev).synchronize()`` and records
``dmlc_step_device_ms`` — the dispatch-to-drain latency of the step (it
includes whatever the stream still held). The other N−1 steps pay one
integer increment and no sync; with device telemetry or metrics off the
stride is 0 and the call is one attribute read.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.device.feed import stall_breakdown
from dmlc_tpu_torch.obs import audit, goodput, trace
from dmlc_tpu_torch.obs.device_telemetry import device_telemetry_enabled
from dmlc_tpu_torch.obs.metrics import metrics_enabled
from dmlc_tpu_torch.obs.watchdog import make_watchdog
from dmlc_tpu_torch.params.env import get_env
from dmlc_tpu_torch.utils.logging import log_info


def step_sample_n() -> int:
    """Device-step latency sampling stride (``DMLC_TPU_STEP_SAMPLE_N``,
    default 64, floor 0 = never sample). Read once per fit, at FitLoopObs
    construction."""
    return max(0, int(get_env("DMLC_TPU_STEP_SAMPLE_N", 64)))


def _first_device(out) -> Optional[torch.device]:
    """The device of the first tensor in a step's output tree."""
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        for x in out:
            dev = _first_device(x)
            if dev is not None:
                return dev
    return None


class FitLoopObs:
    """Per-fit observability bundle: fit metrics, stall logging, the
    goodput ledger, and the runtime watchdog."""

    def __init__(self, model: str, reg=None):
        self.model = model
        self.reg = reg if reg is not None else obs.registry()
        self.m_steps = self.reg.counter(
            "dmlc_fit_steps_total", "optimizer steps taken", model=model)
        self.m_epochs = self.reg.counter(
            "dmlc_fit_epochs_total", "epochs completed", model=model)
        self.g_loss = self.reg.gauge(
            "dmlc_fit_loss_value", "last epoch mean loss", model=model)
        self.h_epoch = self.reg.histogram(
            "dmlc_fit_epoch_ns", "wall time per epoch", model=model)
        self.ledger = goodput.ledger(self.reg)
        self.watchdog = make_watchdog(self.reg)
        # determinism audit: the model digest chain + numeric sentinel
        # (the shared no-op child when DMLC_TPU_AUDIT is off)
        self.audit = audit.auditor()
        # device-step latency sampling stride: 0 (telemetry or metrics
        # off, or DMLC_TPU_STEP_SAMPLE_N=0) disarms sample_latency down
        # to one attribute read per step — read once, here
        self._sample_n = (
            step_sample_n()
            if device_telemetry_enabled() and metrics_enabled() else 0)
        self._sampled = 0
        self._h_step_ms = self.reg.histogram(
            "dmlc_step_device_ms",
            "sampled dispatch-to-drain latency of the optimizer step (one "
            "stream synchronize on every DMLC_TPU_STEP_SAMPLE_N-th step)",
            model=model) if self._sample_n else None

    def note_step(self, n: int = 1) -> None:
        """Hot-path progress marker (one no-op call under
        ``DMLC_TPU_METRICS=0``)."""
        self.ledger.note_step(n)

    def sample_latency(self, out) -> None:
        """Sampled device-step latency: on every ``_sample_n``-th call,
        time one synchronize of the current stream of ``out``'s device
        and record ``dmlc_step_device_ms``. Every other call is one
        increment and one modulo — no sync; disarmed entirely (one
        attribute read) when the stride is 0."""
        n = self._sample_n
        if not n:
            return
        self._sampled += 1
        if self._sampled % n:
            return
        dev = _first_device(out)
        t0 = time.monotonic_ns()
        if dev is not None and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        self._h_step_ms.observe((time.monotonic_ns() - t0) / 1e6)

    def end_epoch(self, epoch: int, nstep: int, t0_ns: int,
                  loss: Optional[float], feed=None,
                  log_every: int = 0, params=None,
                  snapshotter=None, snap_state=None) -> Optional[dict]:
        """Close one epoch: fit metrics, a goodput-ledger window fed to
        the watchdog, the unified stall/goodput log line (every
        ``log_every``-th epoch), and the registry export. Returns the
        ledger window (None when metrics are disabled).

        ``params`` (optional dict of tensors) extends the audit
        model-digest chain over a strided parameter sample — one small
        epoch-cadence copy that doubles as the numeric-health sentinel.

        ``snapshotter`` + ``snap_state`` (a zero-arg state-tree builder)
        arm job snapshotting after the audit roll, so the exported audit
        state describes the *closed* epoch and a resume re-arms the chains
        where an uninterrupted run would be.

        The body runs in an ``end_epoch`` span and first resolves the
        device spans (``obs.trace.resolve_device_spans``): the caller has
        read the epoch's loss, so the stream has run its steps."""
        with obs.span("end_epoch", model=self.model, epoch=epoch):
            trace.resolve_device_spans()
            self.h_epoch.observe(time.monotonic_ns() - t0_ns)
            self.m_steps.inc(nstep)
            self.m_epochs.inc()
            if loss is not None:
                self.g_loss.set(loss)
            nonfinite = self.audit.note_model(epoch, loss, params)
            win = self.ledger.tick()
            if win is not None:
                win["nonfinite"] = nonfinite
                self.watchdog.observe(win)
            if log_every and (epoch + 1) % log_every == 0:
                parts = ["%s epoch %d" % (self.model, epoch)]
                if loss is not None:
                    parts.append("loss %.6f" % loss)
                if feed is not None:
                    parts.append(stall_breakdown(feed.stats()))
                if win is not None:
                    parts.append("goodput %.2f binding=%s" % (
                        win["goodput"]["ratio"], win["binding"]))
                log_info("%s", " ".join(parts))
            obs.export_epoch(self.reg)
            # roll AFTER the export so the epoch's full data chains were
            # exported; this also runs the epoch-over-epoch self-check (the
            # first divergence writes the replay bundle)
            self.audit.roll_epoch(epoch)
            if snapshotter is not None and snap_state is not None:
                snapshotter.capture(epoch, snap_state)
            return win

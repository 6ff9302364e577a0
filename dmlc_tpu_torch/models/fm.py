"""Factorization machines over csr device batches (the port of
``dmlc_tpu/models/fm.py``).

score(x) = b + Σ_i w_i x_i + ½ Σ_k [(Σ_i v_ik x_i)² − Σ_i v_ik² x_i²]

The libfm format exists to feed this model family. Per entry the work is
gathers; the three row sums — the linear term, s = Σ x·v and
q = Σ (x·v)², [B], [B, K] and [B, K] — are ONE ``coo_segment_sum`` of the
packed [E, 2K + 1] entries (the CUDA kernel on the card, one launch a
step; the reference takes the two [E, K] sums with XLA's segment_sum).
The gradients of w and v are feature-direction sums, packed as ONE
``ops/spmv.feature_segment_sum`` of [E, 1 + K] entries, gw's
values·wg[row] in column 0 beside dv's K columns: one sort and one
``sorted_segment_sum`` launch a step on the card. With ``first_apart``
the call gives gw the bits of ``spmv_transpose`` (the linear fit's [E]
call) and dv those of the [E, K] call; both routes repeat their bits.

Steps:

- single-device (``make_fm_train_step(None, ...)``);
- data-parallel (``make_fm_train_step(group, ...)``): each rank's
  ``(gw, gb, gv, loss_sum, wsum)`` cross the group in ONE
  ``bucketed_all_reduce`` before the update, the counterpart of the
  reference's single bucketed psum; each rank reads its own part.

:class:`FMLearner` trains over a csr ``DeviceFeed`` (libfm or libsvm
files) with the preemption-proof job snapshots of ``collective.snapshot``.
A learner built with a group re-places its params after a membership
rebuild (``models.linear.listen_membership``, the reference's membership
callback). The fit loop carries the reference's observability: the
``fm.step`` instrumented site, ``epoch`` / ``train_step`` spans on the
chunks' flows, ``fm.margin`` / ``fm.scatter`` / ``fm.update`` device
spans over the step's phases (``obs.device_span``), and
``models.fitloop.FitLoopObs`` at each epoch boundary.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.collective.device import bucketed_all_reduce
from dmlc_tpu_torch.models.linear import (EpochMetrics, current_group,
                                          listen_membership, step_batch)
from dmlc_tpu_torch.obs import audit
from dmlc_tpu_torch.obs.device_telemetry import instrumented_step
from dmlc_tpu_torch.ops.kernels import coo_segment_sum
from dmlc_tpu_torch.ops.objectives import OBJECTIVES, margin_loss_grad
from dmlc_tpu_torch.ops.spmv import expand_row_ids, feature_segment_sum
from dmlc_tpu_torch.params.parameter import Parameter, field
from dmlc_tpu_torch.resilience import Preempted, preempt
from dmlc_tpu_torch.utils import prng
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check

_PARAM_KEYS = ("w", "b", "v")


class FMParam(Parameter):
    objective = field(str, "logistic")
    learning_rate = field(float, 0.05, lower_bound=0.0)
    l2 = field(float, 0.0, lower_bound=0.0)
    num_factors = field(int, 8, lower_bound=1)
    num_features = field(int, 0)
    init_scale = field(float, 0.01, lower_bound=0.0)


def init_fm_params(num_features: int, num_factors: int,
                   init_scale: float = 0.01, seed: int = 0,
                   device=None) -> Dict:
    """{"w": [F] zeros, "b": 0-d zero, "v": init_scale · N(0, 1) [F, K]}
    f32 on ``device`` (None means cuda). The draw is the reference's
    ``jax.random.normal(PRNGKey(seed), (F, K))`` within
    ``prng.NORMAL_MAX_ULP``, made on the host, so every device starts from
    the same values."""
    dev = resolve_device(device)
    v = init_scale * prng.normal(prng.PRNGKey(seed),
                                 (num_features, num_factors))
    return {
        "w": torch.zeros(num_features, dtype=torch.float32, device=dev),
        "b": torch.zeros((), dtype=torch.float32, device=dev),
        "v": v.to(dev),
    }


def fm_params_from_numpy(np_params: Dict, device=None) -> Dict:
    """The JAX package's ``{"w": [F], "b": (), "v": [F, K]}`` (as numpy)
    → this package's f32 tensors on ``device`` (copies)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(np_params[k], dtype=np.float32),
                            device=dev) for k in _PARAM_KEYS}


def fm_params_to_numpy(params: Dict) -> Dict:
    """This package's FM params → ``{"w", "b", "v"}`` f32 numpy copies."""
    return {k: params[k].detach().to("cpu", copy=True).numpy()
            for k in _PARAM_KEYS}


def _fm_margin(params, values, indices, row_ids, num_rows: int):
    """(margin [B], s [B, K], xv [E, K]): the three row sums as one
    ``coo_segment_sum`` of [values·w | x·v | (x·v)²], [E, 2K + 1]."""
    xv = values[:, None] * params["v"].index_select(0, indices)
    linear_e = values * params["w"].index_select(0, indices)
    sums = coo_segment_sum(torch.cat([linear_e[:, None], xv, xv * xv],
                                     dim=1), row_ids, num_rows)
    k = xv.shape[1]
    linear, s, q = sums[:, 0], sums[:, 1:k + 1], sums[:, k + 1:]
    margin = params["b"] + linear + 0.5 * torch.sum(s * s - q, dim=-1)
    return margin, s, xv


def _fm_forward_grads(params, batch, objective: str, num_features: int):
    """Local (unreduced) (gw, gb, gv, loss_sum, weight_sum) for one csr
    batch (or one rank's section of it)."""
    label = batch["label"]
    weight = batch["weight"]
    values = batch["values"]
    indices = batch["indices"]
    with obs.device_span("fm.margin", values.device):
        row_ids = expand_row_ids(batch["offsets"], values.shape[0])
        margin, s, xv = _fm_margin(params, values, indices, row_ids,
                                   label.shape[0])
    loss, gmargin = margin_loss_grad(objective, margin, label)
    wg = weight * gmargin  # [B]
    gb = torch.sum(wg)
    # per entry, scaled by wg[r]: gw's x_e in column 0, dv's
    # x_e · (s[r, k] − x_e v[i, k]) in columns 1..K; made first, so that
    # the span holds the feature-direction sum alone
    scale = (wg.index_select(0, row_ids) * values)[:, None]
    s_e = s.index_select(0, row_ids)
    packed = torch.cat([scale, scale * (s_e - xv)], dim=1)
    with obs.device_span("fm.scatter", values.device):
        grads = feature_segment_sum(packed, indices, num_features,
                                    first_apart=True)
    gw, gv = grads[:, 0], grads[:, 1:]
    return gw, gb, gv, torch.sum(weight * loss), torch.sum(weight)


def make_fm_train_step(group=None, num_features: int = 0,
                       objective: str = "logistic",
                       learning_rate: float = 0.05, l2: float = 0.0,
                       donate_batch: bool = False):
    """Build the FM SGD step: step(params, batch) -> (params, metrics),
    metrics = {"loss_sum", "weight_sum"} (0-d tensors).

    ``group`` None gives the single-device step; a ``torch.distributed``
    group the data-parallel step (each rank's gradients and sums cross the
    group in one ``bucketed_all_reduce``; the metrics are the group's).
    ``donate_batch=True`` updates w, b and v in place (for callers that
    own them and rebind them every step, as FMLearner does); the default
    returns new tensors. The batch is never written. l2 applies to w and
    v, not to b, as in the reference."""
    check(num_features > 0, "num_features required")
    check(objective in OBJECTIVES, "unknown objective %r", objective)

    def _apply(params, gw, gb, gv, wsum):
        denom = torch.clamp_min(wsum, 1e-12)
        deltas = {
            "w": learning_rate * (gw / denom + l2 * params["w"]),
            "b": learning_rate * (gb / denom),
            "v": learning_rate * (gv / denom + l2 * params["v"]),
        }
        if donate_batch:
            for k in _PARAM_KEYS:
                params[k].sub_(deltas[k])
            return params
        return {k: params[k] - deltas[k] for k in _PARAM_KEYS}

    def step(params, batch):
        grads = _fm_forward_grads(params, batch, objective, num_features)
        if group is not None:
            grads = bucketed_all_reduce(grads, group)
        gw, gb, gv, loss_sum, wsum = grads
        with obs.device_span("fm.update", wsum.device):
            params = _apply(params, gw, gb, gv, wsum)
        return params, {"loss_sum": loss_sum, "weight_sum": wsum}

    return instrumented_step(step, "fm.step")


class FMLearner:
    """csr ``DeviceFeed`` → fitted FM params.

    ``device=None`` means cuda, and raises without a CUDA device; pass
    ``device="cpu"`` for the plain PyTorch path. ``group`` (a
    ``torch.distributed`` group) gives the data-parallel step. The model's
    size is the ``num_features`` hyper-parameter, as in the reference,
    which sizes it that way whatever the feed says. ``params`` may be set
    before a fit (``fm_params_from_numpy``) to start from given values.
    With a ``group`` the learner re-places its params on the new default
    group after every membership rebuild until it is closed or collected.
    """

    def __init__(self, device=None, group=None, **hyper):
        self.device = resolve_device(device)
        self.group = group
        self.param = FMParam()
        self.param.init(hyper)
        self.params = None
        self._step = None
        self._nf = None
        self._unlisten = (None if group is None
                          else listen_membership(self))

    def close(self) -> None:
        """Drop the membership listener (idempotent)."""
        if self._unlisten is not None:
            self._unlisten()

    def _ensure(self, num_features: int) -> None:
        if self.params is None:
            nf = self.param.num_features or num_features
            self.params = init_fm_params(nf, self.param.num_factors,
                                         self.param.init_scale,
                                         device=self.device)
            self._nf = nf
        if self._step is None:
            # the learner owns params and rebinds them every step: update
            # in place
            self.group = current_group(self.group)
            self._step = make_fm_train_step(
                self.group, self._nf or self.param.num_features
                or num_features, objective=self.param.objective,
                learning_rate=self.param.learning_rate, l2=self.param.l2,
                donate_batch=True)

    def reshard(self, group=None, device=None) -> None:
        """Re-place the params on ``device`` (None: the learner's) for
        training over ``group`` (None: the default group when
        torch.distributed is up, else one device), through host copies,
        and drop the built step: the elastic re-entry hook."""
        if group is None and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        if device is not None:
            self.device = resolve_device(device)
        if self.params is not None:
            self.params = fm_params_from_numpy(
                fm_params_to_numpy(self.params), self.device)
        self._step = None

    def fit_feed(self, feed, epochs: int = 1, snapshotter=None,
                 start_epoch: int = 0, history=None, log_every: int = 0):
        """Train over a csr DeviceFeed; returns the per-epoch mean losses.

        With ``snapshotter`` (a ``collective.Snapshotter``) each epoch
        boundary hands it the state tree, and the loop polls for a
        preemption notice between steps: a notice stops the partial
        epoch (never snapshotted), finalizes the freshest boundary
        snapshot within the grace window and raises ``Preempted`` (exit
        75). ``start_epoch`` / ``history`` continue a resumed run, from
        ``collective.load_snapshot``'s state; the returned history covers
        every epoch, the restored ones too. ``log_every`` > 0 logs the
        unified epoch line every that many epochs."""
        from dmlc_tpu_torch.models.fitloop import FitLoopObs

        check(feed.spec.layout == "csr", "FM consumes csr batches")
        check(feed.device == self.device,
              "feed device %s and learner device %s differ", feed.device,
              self.device)
        fl = FitLoopObs("fm")
        history = list(history) if history else []
        for epoch in range(start_epoch, epochs):
            acc = EpochMetrics()
            nstep = 0
            preempted = False
            t0 = time.monotonic_ns()
            with obs.span("epoch", model="fm", epoch=epoch):
                for batch in feed:
                    self._ensure(self.param.num_features)
                    with obs.span("train_step", model="fm", step=nstep):
                        obs.flow_step(obs.current_flow(), "chunk")
                        self.params, metrics = self._step(
                            self.params, step_batch(batch, "csr"))
                    acc.add(metrics)
                    fl.note_step()
                    fl.sample_latency(metrics)
                    nstep += 1
                    if snapshotter is not None and preempt.poll():
                        preempted = True
                        break
            if preempted:
                snapshotter.finalize()
                raise Preempted(
                    "preempted in epoch %d after %d steps; last committed "
                    "snapshot epoch %d"
                    % (epoch, nstep, snapshotter.committed_epoch))
            loss = acc.mean_loss()
            history.append(loss)
            fl.end_epoch(
                epoch, nstep, t0, loss, feed=feed, log_every=log_every,
                params=self.params, snapshotter=snapshotter,
                snap_state=(None if snapshotter is None else
                            lambda e=epoch: self._snapshot_state(
                                feed, e, history)))
            if epoch + 1 < epochs:
                feed.before_first()
        return history

    def _snapshot_state(self, feed, epoch: int, history) -> Dict:
        """The job-snapshot state tree at one epoch boundary (FM has no
        velocity), with the audit's resumable chain state."""
        state = {
            "model": {"params": dict(self.params)},
            "epoch": int(epoch),
            "history": [float(x) for x in history],
            "rng": None,
            "audit": audit.auditor().export_state(),
        }
        parser = getattr(feed, "_parser", None)
        if hasattr(parser, "snapshot_state"):
            state["data"] = {"parser": parser.snapshot_state()}
        return state

    def restore_snapshot_model(self, model: Dict) -> None:
        """Place a snapshot's host FM params on the learner's device."""
        self.params = fm_params_from_numpy(model["params"], self.device)

    def predict_batch(self, batch) -> np.ndarray:
        """Margins [B] of a csr batch, as numpy."""
        check(self.params is not None, "model not fitted")
        values = batch["values"]
        row_ids = expand_row_ids(batch["offsets"], values.shape[0])
        margin = _fm_margin(self.params, values, batch["indices"], row_ids,
                            batch["label"].shape[0])[0]
        return margin.cpu().numpy()

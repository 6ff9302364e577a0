"""The allreduce-SGD linear learner, in PyTorch.

The port of ``dmlc_tpu/models/linear.py``: ``libsvm file → InputSplit
part → parser → fixed-shape device batch → local gradients → allreduce →
SGD``. Three step flavors share one gradient core and one update:

- single-device (``make_linear_train_step(None)``);
- data-parallel (``make_linear_train_step(group)``): each rank's local
  gradients and its loss and weight sums cross the process group in ONE
  ``bucketed_all_reduce`` of the layout ``bucketed_psum`` traces in the
  reference, ``[gw, gb, loss_sum, wsum]``; no DDP wrapper;
- hostsync (``make_hostsync_train_step``): the same bucket copied to the
  host, reduced by ``collective.allreduce`` (the socket engine's tree or
  ring across processes), copied back.

At world 2 every flavor adds each element once, so they give the same
bits. A fourth step, :func:`make_feature_sharded_train_step`, splits the
weight vector over a model-parallel group as well (dp × mp). The gradient core has two layouts:

- dense (small feature spaces, HIGGS's 28): the whole step is one CUDA
  kernel, ``fused_linear_grads``;
- csr (hashed feature spaces, Criteo's 2^20): ``expand_row_ids`` →
  ``spmv_kernel`` (row reduce on the ``coo_segment_sum`` kernel) →
  ``margin_loss_grad`` → ``spmv_transpose``.

On a CPU tensor each kernel wrapper runs its plain PyTorch version. Every
value is f32, as in the reference. The CUDA kernels add no floats with
atomics; ``spmv_transpose`` reduces with PyTorch's sort-then-reduce on
CUDA and, on the CPU, sums each feature's entries in entry order after a
stable sort (``ops/spmv.py``). So a run repeats its bits on either route.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from dmlc_tpu_torch import collective, obs
from dmlc_tpu_torch.collective.device import bucketed_all_reduce
from dmlc_tpu_torch.io.filesystem import create_stream
from dmlc_tpu_torch.io.serializer import load_obj, save_obj
from dmlc_tpu_torch.obs import audit
from dmlc_tpu_torch.obs.device_telemetry import instrumented_step
from dmlc_tpu_torch.ops.kernels import fused_linear_grads
from dmlc_tpu_torch.ops.objectives import OBJECTIVES, margin_loss_grad
from dmlc_tpu_torch.ops.spmv import expand_row_ids, spmv_kernel, \
    spmv_transpose
from dmlc_tpu_torch.params.parameter import Parameter, field
from dmlc_tpu_torch.resilience import Preempted, preempt
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check


class LinearModelParam(Parameter):
    """Hyper-parameters (a dmlc Parameter struct)."""

    objective = field(
        str,
        "logistic",
        description="Loss: logistic (labels 0/1), squared, or hinge (0/1).",
    )
    learning_rate = field(float, 0.1, lower_bound=0.0)
    l2 = field(float, 0.0, lower_bound=0.0, description="L2 penalty on w.")
    momentum = field(float, 0.0, lower_bound=0.0, upper_bound=1.0)
    num_features = field(int, 0, description="Feature dim (0 = infer).")


_DENSE_KEYS = ("x", "label", "weight")
_CSR_KEYS = ("label", "weight", "indices", "values", "offsets")


def step_batch(batch: Dict, layout: str) -> Dict:
    """Strip DeviceFeed metadata (num_rows/num_nonzero ints) down to the
    tensors a train step consumes."""
    keys = _DENSE_KEYS if layout == "dense" else _CSR_KEYS
    return {k: batch[k] for k in keys}


def init_linear_params(num_features: int, device=None) -> Dict:
    """{"w": [F], "b": 0-d} f32 zeros on ``device`` (None means cuda)."""
    dev = resolve_device(device)
    return {
        "w": torch.zeros(num_features, dtype=torch.float32, device=dev),
        "b": torch.zeros((), dtype=torch.float32, device=dev),
    }


def params_from_numpy(np_params: Dict, device=None) -> Dict:
    """The JAX package's ``{"w": [F], "b": ()}`` (as numpy, e.g. from
    ``jax.device_get``) → this package's f32 tensors on ``device``. The
    tensors are copies: training never writes into the caller's arrays."""
    dev = resolve_device(device)
    return {
        k: torch.tensor(np.asarray(np_params[k], dtype=np.float32),
                        device=dev)
        for k in ("w", "b")
    }


def params_to_numpy(params: Dict) -> Dict:
    """This package's params → ``{"w": f32 [F], "b": f32 0-d}`` numpy."""
    return {k: params[k].detach().cpu().numpy().copy() for k in ("w", "b")}


def feature_shard(array, rank: int, size: int):
    """Block ``rank`` of ``size`` of the last axis of ``array`` (numpy or
    tensor): the feature-sharded layout of w ([F]) and of a dense batch's
    x ([B, F]), the reference's ``LINEAR_MP_PARTITION_RULES`` (w split
    over mp in contiguous blocks; b replicated). F must divide over
    ``size``."""
    nf = array.shape[-1]
    check(nf % size == 0, "feature dim %d must divide over %d shards", nf,
          size)
    per = nf // size
    return array[..., rank * per:(rank + 1) * per]


def linear_predict_dense(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def _build_local_grads(objective: str, layout: str, num_features: int):
    """The gradient core: f(params, batch) -> (gw, gb, loss_sum,
    weight_sum). One definition for every step flavor, as in the
    reference."""
    check(layout in ("dense", "csr"), "layout must be dense or csr")
    check(objective in OBJECTIVES, "unknown objective %r", objective)
    if layout == "csr":
        check(num_features > 0, "csr layout requires num_features")

    def _local_grads(params, batch):
        label = batch["label"]
        weight = batch["weight"]
        if layout == "dense":
            return fused_linear_grads(
                batch["x"], label, weight, params["w"], params["b"],
                objective=objective,
            )
        # the batch carries CSR offsets; expand to per-entry row ids here,
        # on the batch's device
        values = batch["values"]
        indices = batch["indices"]
        row_ids = expand_row_ids(batch["offsets"], values.shape[0])
        margin = spmv_kernel(
            values, indices, row_ids, params["w"], label.shape[0]
        ) + params["b"]
        loss, gmargin = margin_loss_grad(objective, margin, label)
        wg = weight * gmargin
        gw = spmv_transpose(values, indices, row_ids, wg, num_features)
        return gw, torch.sum(wg), torch.sum(weight * loss), torch.sum(weight)

    return _local_grads


def _build_apply(learning_rate: float, l2: float, momentum: float,
                 in_place: bool):
    """The SGD update: f(params, velocity, gw, gb, wsum) with the grads
    already reduced. ``in_place`` writes the new params and velocity into
    the given tensors (the reference donates them to XLA instead); the
    arithmetic, and so the bits, are the same either way."""

    def _apply(params, velocity, gw, gb, wsum):
        denom = torch.clamp_min(wsum, 1e-12)
        gw = gw / denom + l2 * params["w"]
        gb = gb / denom
        if momentum > 0.0:
            if in_place:
                velocity["w"].mul_(momentum).add_(gw)
                velocity["b"].mul_(momentum).add_(gb)
            else:
                velocity = {
                    "w": momentum * velocity["w"] + gw,
                    "b": momentum * velocity["b"] + gb,
                }
            gw, gb = velocity["w"], velocity["b"]
        if in_place:
            params["w"].sub_(learning_rate * gw)
            params["b"].sub_(learning_rate * gb)
            return params, velocity
        params = {
            "w": params["w"] - learning_rate * gw,
            "b": params["b"] - learning_rate * gb,
        }
        return params, velocity

    return _apply


def make_linear_train_step(
    group=None,
    objective: str = "logistic",
    learning_rate: float = 0.1,
    l2: float = 0.0,
    momentum: float = 0.0,
    layout: str = "dense",
    num_features: int = 0,
    donate_batch: bool = False,
):
    """Build the SGD step.

    Returns step(params, velocity, batch) -> (params, velocity, metrics)
    where metrics = {"loss_sum": Σ w·loss, "weight_sum": Σ w} (0-d
    tensors; the host divides). The batch's device picks the kernels' route.

    ``group`` None gives the single-device step. A ``torch.distributed``
    process group (``dist.group.WORLD`` or a sub-group) gives the
    data-parallel step: each rank steps on its own batch, and its local
    gradients, loss sum and weight sum cross the group in ONE
    ``bucketed_all_reduce`` before the update, so every rank applies the
    same summed gradient; the metrics are the group's sums.

    ``donate_batch=True`` is the counterpart of the reference's donation:
    params and velocity are updated in place, for callers that own them and
    rebind them every step (LinearLearner). The default leaves every input
    untouched and returns new tensors. The batch is never written.
    """
    _local_grads = _build_local_grads(objective, layout, num_features)
    _apply = _build_apply(learning_rate, l2, momentum, donate_batch)

    def step(params, velocity, batch):
        grads = _local_grads(params, batch)
        if group is not None:
            grads = bucketed_all_reduce(grads, group)
        gw, gb, loss_sum, wsum = grads
        params, velocity = _apply(params, velocity, gw, gb, wsum)
        return params, velocity, {"loss_sum": loss_sum, "weight_sum": wsum}

    return instrumented_step(step, "linear.step")


def make_hostsync_train_step(
    objective: str = "logistic",
    learning_rate: float = 0.1,
    l2: float = 0.0,
    momentum: float = 0.0,
    layout: str = "dense",
    num_features: int = 0,
):
    """The host-round-trip twin of the data-parallel step: local gradients
    on the device, ONE ``collective.allreduce`` over the process's engine
    (the socket engine's tree or ring across processes), the update on the
    device. The rabit loop behind the step(params, velocity, batch)
    signature, and the flavor that works across socket-engine processes.

    The reduced buffer is one flat f32 ``[gw, gb, loss_sum, wsum]``, the
    bucket the data-parallel step reduces on the device, so at world 2 the
    two flavors give the same bits. Inputs are left untouched."""
    _local_grads = _build_local_grads(objective, layout, num_features)
    _apply = _build_apply(learning_rate, l2, momentum, False)

    def step(params, velocity, batch):
        gw, gb, loss_sum, wsum = _local_grads(params, batch)
        bucket = torch.cat([gw.reshape(-1), torch.stack([gb, loss_sum, wsum])])
        reduced = torch.from_numpy(
            collective.allreduce(bucket.cpu().numpy())).to(gw.device)
        n = gw.numel()
        params, velocity = _apply(params, velocity, reduced[:n].view(
            gw.shape), reduced[n], reduced[n + 2])
        return params, velocity, {"loss_sum": reduced[n + 1],
                                  "weight_sum": reduced[n + 2]}

    return instrumented_step(step, "linear.step")


def make_feature_sharded_train_step(
    dp_group=None,
    mp_group=None,
    objective: str = "logistic",
    learning_rate: float = 0.1,
):
    """dp × mp train step: batch rows split over ``dp_group``, the weight
    vector and the feature dim of x over ``mp_group`` (each a
    ``torch.distributed`` group from ``new_group``, or None for one rank).

    The counterpart of the reference's parameter-server mode: the partial
    margins are summed over mp (the pull of the full response), gw, gb,
    the weight sum and the loss sum over dp in one ``bucketed_all_reduce``
    (the push); the [F/mp] gradient never leaves its mp rank.

    Returns step(params, x, label, weight) -> (params, metrics) with local
    shapes: params ``{"w": [F/mp], "b": ()}`` (:func:`feature_shard`), x
    [B/dp, F/mp], label and weight [B/dp]. New tensors are returned; the inputs are not written. A plain
    SGD step (no momentum, no l2), as in the reference.
    """
    check(objective in OBJECTIVES, "unknown objective %r", objective)

    def step(params, x, label, weight):
        partial_margin = x @ params["w"]
        if mp_group is not None:
            partial_margin = bucketed_all_reduce([partial_margin],
                                                 mp_group)[0]
        margin = partial_margin + params["b"]
        loss, dmargin = margin_loss_grad(objective, margin, label)
        wg = weight * dmargin
        # margin is the same on every mp rank, so wg is too: gw needs
        # only the dp sum
        grads = [x.T @ wg, torch.sum(wg), torch.sum(weight),
                 torch.sum(weight * loss)]
        if dp_group is not None:
            grads = bucketed_all_reduce(grads, dp_group)
        gw, gb, wsum, loss_sum = grads
        denom = torch.clamp_min(wsum, 1e-12)
        new_params = {
            "w": params["w"] - learning_rate * gw / denom,
            "b": params["b"] - learning_rate * gb / denom,
        }
        return new_params, {"loss_sum": loss_sum, "weight_sum": wsum}

    return instrumented_step(step, "linear.step_mp")


class EpochMetrics:
    """Collect per-step metric scalars with no per-step host sync; reading
    fetches them in one copy. The host sums each drained batch of scalars
    as the reference does (numpy over the f32 values) into float64
    running totals."""

    def __init__(self):
        self._loss = []
        self._weight = []
        self._loss_total = 0.0
        self._weight_total = 0.0

    def add(self, metrics: Dict) -> None:
        self._loss.append(metrics["loss_sum"])
        self._weight.append(metrics["weight_sum"])

    def mean_loss(self) -> float:
        if self._loss:
            both = torch.stack(
                [torch.stack(self._loss), torch.stack(self._weight)]
            ).cpu().numpy()
            self._loss_total += float(np.sum(both[0]))
            self._weight_total += float(np.sum(both[1]))
            self._loss.clear()
            self._weight.clear()
        return self._loss_total / max(self._weight_total, 1e-12)


#: a learner's ``group`` between a device re-init's release of the old
#: group and the learner's next ``reshard`` or step, which take the new
#: default group
REGROUP = object()


def listen_membership(learner) -> weakref.finalize:
    """Register ``learner.reshard()`` to run after every membership rebuild
    (``collective.on_membership_change``), and the release of the old
    group and step before a device re-init ends them
    (``collective.on_group_release``: the learner's next step takes the
    new default group), while the learner lives: the listeners hold it by
    a weak reference and are dropped when the learner is collected, or
    when the returned finalizer is called (``close``)."""
    ref = weakref.ref(learner)

    def _on_change() -> None:
        obj = ref()
        if obj is not None and obj.params is not None:
            obj.reshard()

    def _on_release() -> None:
        obj = ref()
        if obj is not None:
            obj.group, obj._step = REGROUP, None

    return weakref.finalize(learner, _unregister_all, (
        collective.on_membership_change(_on_change),
        collective.on_group_release(_on_release)))


def _unregister_all(unregisters) -> None:
    for unregister in unregisters:
        unregister()


def current_group(group):
    """``group``, or the default group for a released one (:data:`REGROUP`)."""
    return dist.group.WORLD if group is REGROUP else group


class LinearLearner:
    """Convenience trainer: uri → fitted params (the rabit-SGD loop).

    ``device=None`` means cuda, and raises without a CUDA device; pass
    ``device="cpu"`` to run the plain PyTorch path. ``params`` takes initial
    ``{"w", "b"}`` numpy arrays (see :func:`params_from_numpy`); the
    learner trains its own copies.

    ``sync`` picks the gradient reduction:

    - ``"spmd"`` (default): :func:`make_linear_train_step` over ``group``
      (None: one device, no reduction; a process group: the
      data-parallel step, one ``bucketed_all_reduce`` a step on the
      device);
    - ``"host"``: :func:`make_hostsync_train_step`, one
      ``collective.allreduce`` a step through the process's collective
      engine (the socket engine across processes); ``group`` must be None.

    Every rank must take the same number of steps: a rank with a batch
    more than the others waits for ever in its extra collective, as in the
    reference. ``fit_uri``'s ``drop_remainder`` and parts of equal size
    keep the counts equal.

    A learner built with a ``group`` re-places its params on the new
    default group after every membership rebuild (``reshard`` through
    ``collective.on_membership_change``) until it is closed or collected.
    """

    def __init__(self, device=None, group=None, sync: str = "spmd",
                 params: Optional[Dict] = None, **hyper):
        check(sync in ("spmd", "host"), "sync must be spmd or host")
        check(group is None or sync == "spmd",
              "sync='host' reduces through the collective engine: pass "
              "group only with sync='spmd'")
        self.device = resolve_device(device)
        self.group = group
        self.sync = sync
        self.param = LinearModelParam()
        self.param.init(hyper)
        self.params = (None if params is None
                       else params_from_numpy(params, self.device))
        self.velocity = None
        self._step = None
        self._layout = None
        self._nf = None
        self._unlisten = (None if group is None
                          else listen_membership(self))

    def close(self) -> None:
        """Drop the membership listener (idempotent)."""
        if self._unlisten is not None:
            self._unlisten()

    def _ensure(self, num_features: int, layout: str) -> None:
        if self.params is None:
            self.params = init_linear_params(
                self.param.num_features or num_features, self.device)
        if self.velocity is None:
            self.velocity = {k: torch.zeros_like(v)
                             for k, v in self.params.items()}
        if self._step is None:
            self._layout = layout
            self._nf = (self.param.num_features or num_features
                        or int(self.params["w"].shape[0]))
            hyper = dict(
                objective=self.param.objective,
                learning_rate=self.param.learning_rate,
                l2=self.param.l2,
                momentum=self.param.momentum,
                layout=self._layout,
                num_features=self._nf,
            )
            if self.sync == "host":
                self._step = make_hostsync_train_step(**hyper)
            else:
                # the learner owns params and velocity: update in place
                self.group = current_group(self.group)
                self._step = make_linear_train_step(
                    self.group, donate_batch=True, **hyper)

    def reshard(self, group=None, device=None) -> None:
        """Re-place params and velocity on ``device`` (None: the learner's)
        for training over ``group`` (None: the default group when
        torch.distributed is up, else one device), through host copies,
        and drop the built step: the elastic re-entry hook, whose old
        placement may name a card or a group that is gone."""
        check(self.sync == "spmd", "reshard re-places a sync='spmd' "
              "learner (sync='host' reduces through the collective engine)")
        if group is None and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        if device is not None:
            self.device = resolve_device(device)
        if self.params is not None:
            self.params = params_from_numpy(params_to_numpy(self.params),
                                            self.device)
        if self.velocity is not None:
            self.velocity = params_from_numpy(
                params_to_numpy(self.velocity), self.device)
        self._step = None

    def fit_uri(
        self,
        uri: str,
        batch_size: int = 4096,
        epochs: int = 1,
        layout: str = "dense",
        num_features: int = 0,
        part_index: Optional[int] = None,
        num_parts: Optional[int] = None,
        drop_remainder: bool = False,
        snapshot_uri: Optional[str] = None,
        resume: bool = False,
        snap_every_epochs: int = 1,
        log_every: int = 0,
    ):
        """One call from data uri to fitted params: InputSplit part →
        parser (``create_parser``'s route: the native pipeline for local
        files, else the Python stack tokenizing on the learner's device)
        → DeviceFeed →
        fit_feed. The part defaults to this process's collective rank and
        world size (``InputSplit::Create(uri, rank, world)``), so the same
        line reads the whole file in one process and its own byte range in
        each rank of a job. Returns the per-epoch mean losses.

        ``snapshot_uri`` (a directory uri on any registered filesystem:
        a local path, ``s3://``, ``mem://``, ...) arms preemption-proof job
        snapshots: every ``snap_every_epochs``-th epoch boundary (and the
        job's ``DMLC_TPU_SNAP_EVERY_S`` clock) commits params, velocity
        and the loss history through the async two-phase-commit writer,
        and a SIGTERM mid-epoch commits the last boundary's state and
        exits with code 75. ``resume=True`` first loads the newest
        committed snapshot (the model, and the parser's read plan where
        the parser has one) and continues at the next epoch: the result
        is bit-identical to a run that was never stopped. ``log_every`` > 0
        logs the running loss every that many steps and the unified epoch
        line (stall breakdown, goodput, binding stage) every that many
        epochs."""
        from dmlc_tpu_torch.data.parsers import create_parser
        from dmlc_tpu_torch.device.feed import BatchSpec, DeviceFeed

        nf = num_features or self.param.num_features
        check(nf > 0, "fit_uri requires num_features")
        check(snapshot_uri is not None or not resume,
              "resume=True requires snapshot_uri")
        if part_index is None:
            part_index = collective.rank()
        if num_parts is None:
            num_parts = collective.world_size()
        feed = DeviceFeed(
            create_parser(uri, part_index, num_parts, device=self.device),
            BatchSpec(batch_size=batch_size, layout=layout, num_features=nf,
                      drop_remainder=drop_remainder),
            device=self.device,
        )
        try:
            if snapshot_uri is None:
                return self.fit_feed(feed, epochs=epochs,
                                     log_every=log_every)
            snap = collective.JobSnapshot(
                snapshot_uri, rank=collective.rank(),
                world_size=collective.world_size())
            snapshotter = collective.Snapshotter(
                snap, every_epochs=snap_every_epochs)
            try:
                start_epoch, history = 0, None
                if resume:
                    version, state, _meta = collective.load_snapshot(snap)
                    if version and state is not None:
                        self._restore_snapshot_model(state["model"])
                        start_epoch = int(state.get("epoch", -1)) + 1
                        history = list(state.get("history", ()))
                        # the read plan: a shuffled shard parser goes on
                        # at the epoch after the snapshotted one
                        pst = (state.get("data") or {}).get("parser")
                        parser = getattr(feed, "_parser", None)
                        if pst and hasattr(parser, "restore_state"):
                            parser.restore_state(pst)
                        snapshotter.mark_restored(start_epoch - 1)
                return self.fit_feed(feed, epochs=epochs,
                                     snapshotter=snapshotter,
                                     start_epoch=start_epoch,
                                     history=history, log_every=log_every)
            finally:
                snapshotter.close()
        finally:
            feed.close()

    def fit_feed(self, feed, epochs: int = 1, snapshotter=None,
                 start_epoch: int = 0, history=None, log_every: int = 0):
        """Train over a DeviceFeed for N epochs; returns per-epoch losses.

        With ``snapshotter`` (a ``collective.Snapshotter``) each epoch
        boundary hands it the state tree, and the loop polls for a
        preemption notice between steps (SIGTERM, or the
        ``preempt.notice`` faultpoint): a notice stops the partial epoch,
        which is never snapshotted (a resume replays it whole: that keeps
        the relaunch bit-identical), finalizes the freshest boundary
        snapshot within the grace window and raises ``Preempted`` (exit
        75). ``start_epoch`` / ``history`` continue a resumed run; the
        returned history covers every epoch, the restored ones too.

        Each epoch is an ``epoch`` span and each step a ``train_step``
        span that steps the in-flight chunk's flow; ``FitLoopObs`` closes
        the epoch (metrics, goodput window, watchdog, audit, export)."""
        from dmlc_tpu_torch.models.fitloop import FitLoopObs
        from dmlc_tpu_torch.utils.logging import log_info

        check(feed.device == self.device,
              "feed device %s and learner device %s differ", feed.device,
              self.device)
        layout = feed.spec.layout
        fl = FitLoopObs("linear")
        history = list(history) if history else []
        for epoch in range(start_epoch, epochs):
            acc = EpochMetrics()
            nstep = 0
            preempted = False
            t0 = time.monotonic_ns()
            with obs.span("epoch", model="linear", epoch=epoch):
                for batch in feed:
                    self._ensure(feed.spec.num_features, layout)
                    # train_step marks the chunk: the feed set the
                    # thread's current flow around this yield
                    with obs.span("train_step", model="linear", step=nstep):
                        obs.flow_step(obs.current_flow(), "chunk")
                        self.params, self.velocity, metrics = self._step(
                            self.params, self.velocity,
                            step_batch(batch, layout))
                    acc.add(metrics)
                    fl.note_step()
                    # every DMLC_TPU_STEP_SAMPLE_N-th step: one timed
                    # stream sync -> dmlc_step_device_ms
                    fl.sample_latency(metrics)
                    nstep += 1
                    if log_every and nstep % log_every == 0:
                        log_info("epoch %d step %d loss %.6f", epoch, nstep,
                                 acc.mean_loss())
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
        """The job-snapshot state tree at one epoch boundary, the JAX
        package's layout (the audit's resumable chain state under
        ``audit``). The snapshotter host-copies it before the next
        step."""
        state = {
            "model": {"params": dict(self.params),
                      "velocity": dict(self.velocity or {})},
            "epoch": int(epoch),
            "history": [float(x) for x in history],
            "rng": None,  # the SGD path draws no step-time randomness
            "audit": audit.auditor().export_state(),
        }
        parser = getattr(feed, "_parser", None)
        if hasattr(parser, "snapshot_state"):
            state["data"] = {"parser": parser.snapshot_state()}
        return state

    def _restore_snapshot_model(self, model: Dict) -> None:
        """Place a snapshot's host params and velocity on the learner's
        device."""
        self.params = params_from_numpy(model["params"], self.device)
        if model.get("velocity"):
            self.velocity = params_from_numpy(model["velocity"], self.device)

    def predict(self, x: np.ndarray) -> np.ndarray:
        check(self.params is not None, "model not fitted")
        xt = torch.as_tensor(np.asarray(x, dtype=np.float32),
                             device=self.device)
        return linear_predict_dense(self.params, xt).cpu().numpy()

    # ---- checkpointing through the Stream surface -------------------------
    def save(self, uri: str) -> None:
        """Write the param dict and ``w``, ``b`` to ``uri`` with the
        serializer: the JAX package's bytes, so either package loads the
        other's model."""
        check(self.params is not None, "model not fitted")
        arrays = params_to_numpy(self.params)
        with create_stream(uri, "w") as out:
            save_obj(out, {"param": self.param.to_dict(),
                           "w": arrays["w"], "b": arrays["b"]})

    def load(self, uri: str) -> None:
        """Read a model written by :meth:`save` (or by the JAX package's
        ``LinearLearner.save``) onto the learner's device. Training goes
        on from it with zero velocity and a fresh step."""
        with create_stream(uri, "r") as stream:
            payload = load_obj(stream)
        self.param.init(payload["param"], allow_unknown=True)
        self.params = params_from_numpy(payload, self.device)
        self.velocity = None
        self._step = None

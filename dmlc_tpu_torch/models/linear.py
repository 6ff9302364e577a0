"""The linear learner with allreduce-SGD's single-device step, in PyTorch.

The port of ``dmlc_tpu/models/linear.py``: ``libsvm file → InputSplit →
parser → fixed-shape device batch → local gradients → SGD``. The gradient
core has two layouts:

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

from typing import Dict, Optional

import numpy as np
import torch

from dmlc_tpu_torch.ops.kernels import fused_linear_grads
from dmlc_tpu_torch.ops.objectives import OBJECTIVES, margin_loss_grad
from dmlc_tpu_torch.ops.spmv import expand_row_ids, spmv_kernel, \
    spmv_transpose
from dmlc_tpu_torch.params.parameter import Parameter, field
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


def linear_predict_dense(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def _build_local_grads(objective: str, layout: str, num_features: int):
    """The gradient core: f(params, batch) -> (gw, gb, loss_sum,
    weight_sum). One definition for every step flavor, as in the
    reference."""

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
    mesh=None,
    objective: str = "logistic",
    learning_rate: float = 0.1,
    l2: float = 0.0,
    momentum: float = 0.0,
    layout: str = "dense",
    num_features: int = 0,
    donate_batch: bool = False,
):
    """Build the single-device SGD step.

    Returns step(params, velocity, batch) -> (params, velocity, metrics)
    where metrics = {"loss_sum": Σ w·loss, "weight_sum": Σ w} (0-d
    tensors; the host divides). The batch's device picks the kernels' route.

    ``donate_batch=True`` is the counterpart of the reference's donation:
    params and velocity are updated in place, for callers that own them and
    rebind them every step (LinearLearner). The default leaves every input
    untouched and returns new tensors. The batch is never written.

    ``mesh`` must be None: the mesh step is not ported yet.
    """
    check(mesh is None, "mesh steps are not ported yet: pass mesh=None")
    check(layout in ("dense", "csr"), "layout must be dense or csr")
    check(objective in OBJECTIVES, "unknown objective %r", objective)
    if layout == "csr":
        check(num_features > 0, "csr layout requires num_features")
    _local_grads = _build_local_grads(objective, layout, num_features)
    _apply = _build_apply(learning_rate, l2, momentum, donate_batch)

    def step(params, velocity, batch):
        gw, gb, loss_sum, wsum = _local_grads(params, batch)
        params, velocity = _apply(params, velocity, gw, gb, wsum)
        return params, velocity, {"loss_sum": loss_sum, "weight_sum": wsum}

    return step


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


class LinearLearner:
    """Convenience trainer: uri → fitted params (the rabit-SGD loop) on one
    device.

    ``device=None`` means cuda, and raises without a CUDA device; pass
    ``device="cpu"`` to run the plain PyTorch path. ``params`` takes initial
    ``{"w", "b"}`` numpy arrays (see :func:`params_from_numpy`); the
    learner trains its own copies in place.
    """

    def __init__(self, device=None, params: Optional[Dict] = None, **hyper):
        self.device = resolve_device(device)
        self.param = LinearModelParam()
        self.param.init(hyper)
        self.params = (None if params is None
                       else params_from_numpy(params, self.device))
        self.velocity = None
        self._step = None
        self._layout = None
        self._nf = None

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
            self._step = make_linear_train_step(
                None,
                objective=self.param.objective,
                learning_rate=self.param.learning_rate,
                l2=self.param.l2,
                momentum=self.param.momentum,
                layout=self._layout,
                num_features=self._nf,
                donate_batch=True,  # the learner owns params and velocity
            )

    def fit_uri(
        self,
        uri: str,
        batch_size: int = 4096,
        epochs: int = 1,
        layout: str = "dense",
        num_features: int = 0,
        part_index: int = 0,
        num_parts: int = 1,
        drop_remainder: bool = False,
    ):
        """One call from data uri to fitted params: InputSplit part →
        parser (tokenizing on the learner's device) → DeviceFeed →
        fit_feed. Returns the per-epoch mean losses."""
        from dmlc_tpu_torch.data.parsers import create_parser
        from dmlc_tpu_torch.device.feed import BatchSpec, DeviceFeed

        nf = num_features or self.param.num_features
        check(nf > 0, "fit_uri requires num_features")
        feed = DeviceFeed(
            create_parser(uri, part_index, num_parts, device=self.device),
            BatchSpec(batch_size=batch_size, layout=layout, num_features=nf,
                      drop_remainder=drop_remainder),
            device=self.device,
        )
        try:
            return self.fit_feed(feed, epochs=epochs)
        finally:
            feed.close()

    def fit_feed(self, feed, epochs: int = 1):
        """Train over a DeviceFeed for N epochs; returns per-epoch losses."""
        check(feed.device == self.device,
              "feed device %s and learner device %s differ", feed.device,
              self.device)
        layout = feed.spec.layout
        history = []
        for epoch in range(epochs):
            acc = EpochMetrics()
            for batch in feed:
                self._ensure(feed.spec.num_features, layout)
                self.params, self.velocity, metrics = self._step(
                    self.params, self.velocity, step_batch(batch, layout))
                acc.add(metrics)
            history.append(acc.mean_loss())
            if epoch + 1 < epochs:
                feed.before_first()
        return history

    def predict(self, x: np.ndarray) -> np.ndarray:
        check(self.params is not None, "model not fitted")
        xt = torch.as_tensor(np.asarray(x, dtype=np.float32),
                             device=self.device)
        return linear_predict_dense(self.params, xt).cpu().numpy()

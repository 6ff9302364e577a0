"""Learners: the allreduce-SGD linear learner (single-device, data-parallel
and hostsync steps)."""

from dmlc_tpu_torch.models.linear import (
    EpochMetrics,
    LinearLearner,
    LinearModelParam,
    init_linear_params,
    linear_predict_dense,
    make_hostsync_train_step,
    make_linear_train_step,
    params_from_numpy,
    params_to_numpy,
    step_batch,
)

__all__ = [
    "EpochMetrics", "LinearLearner", "LinearModelParam",
    "init_linear_params", "linear_predict_dense", "make_hostsync_train_step",
    "make_linear_train_step",
    "params_from_numpy", "params_to_numpy", "step_batch",
]

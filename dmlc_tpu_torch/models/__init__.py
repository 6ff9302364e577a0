"""Learners: the allreduce-SGD linear learner (single-device, data-parallel,
hostsync and feature-sharded steps), factorization machines and histogram
GBDT."""

from dmlc_tpu_torch.models.fm import (
    FMLearner,
    FMParam,
    fm_params_from_numpy,
    fm_params_to_numpy,
    init_fm_params,
    make_fm_train_step,
)
from dmlc_tpu_torch.models.gbdt import GBDTLearner, GBDTParam
from dmlc_tpu_torch.models.linear import (
    EpochMetrics,
    LinearLearner,
    LinearModelParam,
    feature_shard,
    init_linear_params,
    linear_predict_dense,
    make_feature_sharded_train_step,
    make_hostsync_train_step,
    make_linear_train_step,
    params_from_numpy,
    params_to_numpy,
    step_batch,
)

__all__ = [
    "EpochMetrics", "FMLearner", "FMParam", "GBDTLearner", "GBDTParam", "LinearLearner",
    "LinearModelParam", "feature_shard",
    "init_linear_params", "linear_predict_dense",
    "make_feature_sharded_train_step", "make_hostsync_train_step",
    "make_linear_train_step",
    "params_from_numpy", "params_to_numpy", "step_batch",
    "fm_params_from_numpy", "fm_params_to_numpy", "init_fm_params",
    "make_fm_train_step",
]

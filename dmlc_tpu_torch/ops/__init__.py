"""Objectives (``ops.objectives``), sparse products (``ops.spmv``), the
long-context attention schedules (``ops.sequence_parallel``), expert
parallelism (``ops.moe``), GPipe pipeline parallelism
(``ops.pipeline_parallel``) and the CUDA
kernels of the port with their plain versions (``ops.kernels``, sources in
``ops/csrc``): ``fused_linear_grads``, ``coo_segment_sum``,
``flash_attention_fwd``, ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv``. ``ops.kernels.KERNELS`` holds every wrapper
and its launch count; ``ops.flash_attention`` joins the three flash kernels
into an autograd Function."""

from dmlc_tpu_torch.ops.flash_attention import flash_attention
from dmlc_tpu_torch.ops.moe import (
    init_moe_params,
    make_moe_layer,
    moe_dense_oracle,
    shard_moe_params,
)
from dmlc_tpu_torch.ops.pipeline_parallel import (
    make_pipeline,
    pipeline_oracle,
    shard_pipeline_params,
)
from dmlc_tpu_torch.ops.sequence_parallel import (
    full_attention,
    make_flash_local,
    make_ring_attention,
    make_ulysses_attention,
    zigzag_shard,
    zigzag_unshard,
)

__all__ = [
    "flash_attention",
    "full_attention",
    "make_flash_local",
    "make_ring_attention",
    "make_ulysses_attention",
    "zigzag_shard",
    "zigzag_unshard",
    "init_moe_params",
    "make_moe_layer",
    "moe_dense_oracle",
    "shard_moe_params",
    "make_pipeline",
    "pipeline_oracle",
    "shard_pipeline_params",
]

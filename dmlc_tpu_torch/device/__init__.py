"""Static-shape device batches and the device feed (its producer thread
and transfer window)."""

from dmlc_tpu_torch.device.csr import (
    DeviceCSRBatch,
    ShardedCSRBatch,
    block_to_dense,
    emit_to_bucket,
    pad_to_bucket,
    pad_to_bucket_sharded,
    round_up_bucket,
)
from dmlc_tpu_torch.device.feed import BatchSpec, DeviceFeed, PinnedPool

__all__ = [
    "BatchSpec", "DeviceCSRBatch", "DeviceFeed", "PinnedPool",
    "ShardedCSRBatch", "block_to_dense", "emit_to_bucket", "pad_to_bucket",
    "pad_to_bucket_sharded", "round_up_bucket",
]

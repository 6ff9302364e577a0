"""Logging/check layer, the device rule and the prefetch iterator."""

from dmlc_tpu_torch.utils.device import resolve_device, strict_f32
from dmlc_tpu_torch.utils.logging import DMLCError, check, check_eq, log_info
from dmlc_tpu_torch.utils.threaded_iter import ThreadedIter

__all__ = [
    "DMLCError", "ThreadedIter", "check", "check_eq", "log_info",
    "resolve_device", "strict_f32",
]

"""Utility layer: the logging/check layer, the device rule, the prefetch
iterator, timing, the managed threads and small helpers
(``include/dmlc/logging.h``, ``timer.h``, ``thread_group.h``,
``common.h``)."""

from dmlc_tpu_torch.utils.common import hash_combine, split_string
from dmlc_tpu_torch.utils.device import resolve_device, strict_f32
from dmlc_tpu_torch.utils.logging import (
    DMLCError,
    LogOncePer,
    check,
    check_eq,
    check_ge,
    check_gt,
    check_le,
    check_lt,
    check_ne,
    check_notnull,
    get_logger,
    log_debug,
    log_error,
    log_fatal,
    log_info,
    log_warning,
    set_log_sink,
)
from dmlc_tpu_torch.utils.thread_group import (
    BlockingQueueThread,
    ManualEvent,
    ThreadGroup,
    TimerThread,
)
from dmlc_tpu_torch.utils.threaded_iter import ThreadedIter
from dmlc_tpu_torch.utils.timer import Timer, get_time

__all__ = [
    "BlockingQueueThread", "DMLCError", "LogOncePer", "ManualEvent",
    "ThreadGroup", "ThreadedIter", "Timer", "TimerThread", "check",
    "check_eq", "check_ge", "check_gt", "check_le", "check_lt", "check_ne",
    "check_notnull", "get_logger", "get_time", "hash_combine", "log_debug",
    "log_error", "log_fatal", "log_info", "log_warning", "resolve_device",
    "set_log_sink", "split_string", "strict_f32",
]

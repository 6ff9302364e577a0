"""Fault handling (the port of ``dmlc_tpu/resilience``):

- :mod:`~dmlc_tpu_torch.resilience.faults`: deterministic
  :func:`faultpoint` hooks armed by ``configure`` or ``DMLC_TPU_FAULTS``;
- :mod:`~dmlc_tpu_torch.resilience.preempt`: SIGTERM preemption notices,
  the :data:`EXIT_PREEMPTED` relaunch code and the ``preempt.notice``
  faultpoint;
- :mod:`~dmlc_tpu_torch.resilience.retry`: the retry policy (transient
  classification, jittered backoff, deadlines, a process-wide retry
  budget) behind the remote filesystems' reads and writes, the tracker
  dials and the recovery loop;
- :mod:`~dmlc_tpu_torch.resilience.hedge`: :func:`hedged_call`, one
  backup request after a latency threshold, for the remote readahead's
  range fetches (``DMLC_TPU_HEDGE_S``).
"""

from dmlc_tpu_torch.resilience import preempt
from dmlc_tpu_torch.resilience.faults import (
    FaultSpecError,
    InjectedFault,
    configure,
    faultpoint,
    parse_spec,
    reset,
)
from dmlc_tpu_torch.resilience.hedge import hedged_call
from dmlc_tpu_torch.resilience.preempt import EXIT_PREEMPTED, Preempted
from dmlc_tpu_torch.resilience.retry import (
    CONFIG_ERRORS,
    RetryBudget,
    RetryPolicy,
    RetryState,
    backoff_sleep,
    classify_transient,
    global_budget,
    reset_global_budget,
    reset_stats,
    retry_call,
)

__all__ = [
    "CONFIG_ERRORS", "EXIT_PREEMPTED", "FaultSpecError", "InjectedFault",
    "Preempted", "RetryBudget", "RetryPolicy", "RetryState",
    "backoff_sleep", "classify_transient", "configure", "faultpoint",
    "global_budget", "hedged_call", "parse_spec", "preempt", "reset",
    "reset_global_budget", "reset_stats", "retry_call",
]

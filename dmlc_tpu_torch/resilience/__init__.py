"""Fault handling for the snapshot plane (the port of part of
``dmlc_tpu/resilience``):

- :mod:`~dmlc_tpu_torch.resilience.faults`: deterministic
  :func:`faultpoint` hooks armed by ``configure`` or ``DMLC_TPU_FAULTS``;
- :mod:`~dmlc_tpu_torch.resilience.preempt`: SIGTERM preemption notices,
  the :data:`EXIT_PREEMPTED` relaunch code and the ``preempt.notice``
  faultpoint.

The reference's retry policy and hedged calls serve remote filesystems
and the data service, which the port does not have yet.
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
from dmlc_tpu_torch.resilience.preempt import EXIT_PREEMPTED, Preempted

__all__ = [
    "EXIT_PREEMPTED", "FaultSpecError", "InjectedFault", "Preempted",
    "configure", "faultpoint", "parse_spec", "preempt", "reset",
]

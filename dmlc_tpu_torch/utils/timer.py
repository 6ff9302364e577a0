"""Timing helpers (the port of ``dmlc_tpu/utils/timer.py``; reference:
include/dmlc/timer.h GetTime, timer.h:27-47)."""

from __future__ import annotations

import time
from typing import Optional

from dmlc_tpu_torch.utils.logging import check


def get_time() -> float:
    """Seconds from a monotonic high-resolution clock, as double.

    The reference prefers chrono high_resolution_clock (timer.h:29-33); the
    Python equivalent is time.perf_counter()."""
    return time.perf_counter()


class Timer:
    """Context-manager stopwatch with accumulated elapsed time: pipeline
    stages (and ``obs.span`` durations) time several enters with one
    Timer, so it accumulates across them."""

    def __init__(self) -> None:
        self.elapsed = 0.0
        self._start: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._start = get_time()
        return self

    def __exit__(self, *exc) -> None:
        # a library-surface misuse, not an internal invariant: raise the
        # catchable DMLCError, never a stripped-out assert
        check(self._start is not None,
              "Timer.__exit__ without a matching __enter__")
        self.elapsed += get_time() - self._start
        self._start = None

    def reset(self) -> None:
        """Zero the accumulated time. Safe mid-timing: an in-flight enter
        restarts from now instead of being forgotten (its exit would
        otherwise raise)."""
        self.elapsed = 0.0
        if self._start is not None:
            self._start = get_time()

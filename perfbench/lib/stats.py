"""Frozen arithmetic of the end-to-end metrics. Plain Python: no device,
no numpy."""

from __future__ import annotations

import statistics
from typing import Sequence


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of every value given (linear interpolation
    between order statistics, ``statistics.quantiles(..., n=20,
    method="inclusive")``)."""
    values = list(values)
    if not values:
        raise ValueError("p95 of no values")
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=20, method="inclusive")[18])


def rate(work: float, seconds: float) -> float:
    """Work over the whole window's seconds."""
    if seconds <= 0:
        raise ValueError("a window of %r s" % seconds)
    return work / seconds

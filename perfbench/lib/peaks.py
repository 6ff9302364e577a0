"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W power limit), the yardstick of every roofline and mfu
share."""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take for the work: the larger of
    its operations over the float32 peak and its bytes over the memory
    rate."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def share(flops: float, nbytes: float, seconds: float):
    """The least time over the time taken, in %; None where nothing was
    timed."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * least_seconds(flops, nbytes) / seconds

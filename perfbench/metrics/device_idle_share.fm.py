"""device_idle_share.fm: the share (%) of the traced FM epoch in which no
operation ran on the device (``torch.profiler``)."""

from __future__ import annotations


def read(r: dict):
    trace = r.get("trace") or {}
    if not trace.get("busy_s") or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])

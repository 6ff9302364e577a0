"""fm_step_device_ms.fm: device milliseconds a FM step, the busy time of
the traced epoch (``torch.profiler``: the union of every device
operation) over its steps."""

from __future__ import annotations


def read(r: dict):
    trace = r.get("trace") or {}
    steps = trace.get("steps")
    if not steps or not trace.get("busy_s"):
        return None
    return 1e3 * trace["busy_s"] / steps

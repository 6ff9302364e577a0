"""Device time: a function timed alone with CUDA events and a cold L2, and
a stretch of the job traced with ``torch.profiler`` (busy seconds,
device operations by time, idle gaps by what the host was doing)."""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Sequence

import torch

#: bytes written between timed launches: far larger than the H100's
#: 50 MB L2, so each launch starts with a cold cache, and long enough on
#: the card (~0.3 ms) that the host's enqueue of a small call hides
#: behind it
FLUSH_BYTES = 1 << 30


def time_alone(fn: Callable, args: Sequence[tuple], device,
               iters: int = 20) -> float:
    """Median milliseconds of ``fn(*args[i % len(args)])`` on the card,
    each launch behind a write of :data:`FLUSH_BYTES` (a cold L2, and the
    host's enqueue hidden behind it), bracketed by CUDA events."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    fn(*args[0])
    torch.cuda.synchronize(device)
    times = []
    for i in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args[i % len(args)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    return statistics.median(times)


def short_name(name: str) -> str:
    """An operation's name without its trailing argument list (a kernel's
    ``(int, float*, ...)``)."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip() or name
    return name


def _merge(intervals: List[tuple]) -> List[list]:
    merged: List[list] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(device_ops: List[tuple], host_ops: List[tuple],
              window_s: float, top: int = 10) -> dict:
    """``device_ops`` / ``host_ops``: (start_us, end_us, name) on one
    clock. Returns busy_s (the union of the device operations), window_s,
    ``ops`` {name: device seconds} and ``breakdown``: the ``top`` device
    operations by time and the ``top`` longest idle gaps between device
    operations, each named by the innermost host operation running at its
    middle ("host idle" where none was)."""
    ops: Dict[str, float] = {}
    for start, end, name in device_ops:
        name = short_name(name)
        ops[name] = ops.get(name, 0.0) + (end - start) * 1e-6
    merged = _merge([(s, e) for s, e, _ in device_ops])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(merged, merged[1:])), reverse=True)[:top]
    named = []
    for length, start, end in gaps:
        mid = 0.5 * (start + end)
        inner = None
        for s, e, name in host_ops:
            if s <= mid <= e and (inner is None or s >= inner[0]):
                inner = (s, name)
        named.append([short_name(inner[1]) if inner else "host idle",
                      length * 1e-6])
    device = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "window_s": window_s, "ops": ops,
            "breakdown": {"device_ops": [[k, v] for k, v in device],
                          "idle_gaps": named}}


def traced(fn: Callable, device) -> dict:
    """Run ``fn()`` under ``torch.profiler`` (host and device), between
    two synchronizes, and :func:`summarize` it; ``window_s`` is the host
    clock's seconds from the first synchronize to the last."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_ops = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.device_type == cuda:
            device_ops.append(span)
        else:
            host_ops.append(span)
    return summarize(device_ops, host_ops, window_s)


def sync(device) -> None:
    """Wait for the card's work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The process's peak of allocated device memory (0 on the CPU)."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def release(device) -> None:
    """Hand the allocator's cached blocks back to the card."""
    if device.type == "cuda":
        torch.cuda.empty_cache()

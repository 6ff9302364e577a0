"""Cross-host metric aggregation over ``collective.DeviceEngine`` (the port
of ``dmlc_tpu/obs/aggregate.py``, over a ``torch.distributed`` group).

A multi-host job's ingest skew is invisible in per-host logs (the MLPerf pod
studies, arXiv:1909.09756: one slow host gates every step). This module
turns the local registry into a fixed-order float vector and exchanges it
through the engine's allreduce so EVERY rank — and rank 0 in particular —
can report per-host min/median/max for each metric.

The exchange is one sum-allreduce of a ``[world, n]`` matrix where each
rank fills only its own row: the reduced matrix IS the per-host table, so
exact medians (not just allreduce-expressible min/mean/max) come out of a
single collective. n is the metric count — these are counters, not
gradients; the O(world·n) payload is trivial next to one data batch.

Vector order must agree across hosts (SPMD processes registering the same
metrics in the same order do); a crc of the name list rides in front of
the values and any mismatch raises instead of silently mis-pairing
counters. On a 1-host engine allreduce degenerates to identity and the
snapshot is exact trivially.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

import numpy as np

from dmlc_tpu_torch.obs.metrics import Registry, registry
from dmlc_tpu_torch.utils.logging import check, log_info


def cross_host_snapshot(engine, reg: Optional[Registry] = None,
                        prefix: Optional[str] = None) -> Dict:
    """Allreduce the registry's counter/gauge vector across hosts.

    Returns ``{"world": W, "rank": r, "metrics": {name: {"min", "median",
    "max", "sum", "mean"}}}`` on every rank (the collective is symmetric).
    ``prefix`` filters metric names before the exchange — all ranks must
    pass the same value. Histograms contribute their ``:sum``/``:count``
    scalars (see :meth:`Registry.flat_values`)."""
    reg = reg or registry()
    values = reg.flat_values()
    if prefix:
        values = {k: v for k, v in values.items() if k.startswith(prefix)}
    names = sorted(values)
    world = int(getattr(engine, "world_size", 1))
    rank = int(getattr(engine, "rank", 0))
    crc = float(zlib.crc32("\n".join(names).encode()))
    mat = np.zeros((world, len(names) + 1), dtype=np.float64)
    mat[rank, 0] = crc
    mat[rank, 1:] = [values[n] for n in names]
    table = np.asarray(engine.allreduce(mat, op="sum"))
    check(
        bool(np.all(table[:, 0] == crc)),
        "cross-host metric snapshot: hosts registered different metric "
        "sets (name-list crc mismatch) — pass a common prefix or align "
        "registrations",
    )
    per_host = table[:, 1:]
    out: Dict[str, Dict[str, float]] = {}
    for i, name in enumerate(names):
        col = per_host[:, i]
        out[name] = {
            "min": float(col.min()),
            "median": float(np.median(col)),
            "max": float(col.max()),
            "sum": float(col.sum()),
            "mean": float(col.mean()),
        }
    return {"world": world, "rank": rank, "metrics": out}


def report_skew(engine, reg: Optional[Registry] = None,
                prefix: Optional[str] = None, top: int = 5) -> Dict:
    """Take a cross-host snapshot and, on rank 0, log the ``top`` metrics
    with the widest per-host spread (max/min ratio; max-min for metrics
    whose min is 0). Returns the snapshot on every rank."""
    snap = cross_host_snapshot(engine, reg=reg, prefix=prefix)
    if snap["rank"] != 0:
        return snap

    def spread(stats: Dict[str, float]) -> float:
        if stats["min"] > 0:
            return stats["max"] / stats["min"]
        return stats["max"] - stats["min"]

    ranked = sorted(
        ((spread(s), name, s) for name, s in snap["metrics"].items()),
        reverse=True,
    )
    for _sp, name, s in ranked[:top]:
        log_info(
            "host skew %s: min %g / median %g / max %g over %d host(s)",
            name, s["min"], s["median"], s["max"], snap["world"],
        )
    return snap

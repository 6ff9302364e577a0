"""fit_prep_ms.gbdt: milliseconds a GBDT fit spends before its first tree,
from inside the program: the means of the ``gbdt.copy_x`` (x to the
card), ``gbdt.edges`` (the quantile edges) and ``gbdt.bin`` (the bin
ids) device spans, summed. None where the program lacks any of them."""

from __future__ import annotations

SPANS = ("gbdt.copy_x", "gbdt.edges", "gbdt.bin")


def read(r: dict):
    try:
        from dmlc_tpu_torch.obs import trace
    except ImportError:
        return None
    if not hasattr(trace, "device_span_totals"):
        return None
    trace.resolve_device_spans()
    totals = trace.device_span_totals()
    got = [totals.get(name) for name in SPANS]
    if not all(g and g["count"] for g in got):
        return None
    return sum(g["ms"] / g["count"] for g in got)

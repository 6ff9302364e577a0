"""level_histogram_ms.gbdt: milliseconds of one level's (g, h) histogram
in the GBDT fit, from inside the program: the ``gbdt.histogram`` device
span's total over its count, every level of every tree of the traced fit
(depth 5 alone is what ``level_histogram_roofline`` times). None where
the program has no such span."""

from __future__ import annotations


def read(r: dict):
    try:
        from dmlc_tpu_torch.obs import trace
    except ImportError:
        return None
    if not hasattr(trace, "device_span_totals"):
        return None
    trace.resolve_device_spans()
    got = trace.device_span_totals().get("gbdt.histogram")
    if not got or not got["count"]:
        return None
    return got["ms"] / got["count"]

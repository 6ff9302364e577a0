"""fm_scatter_ms.fm: milliseconds of the FM step's feature-direction sums
(gw and gv) on the stream, from inside the program: the ``fm.scatter``
device span's total over its count (``obs.trace.device_span_totals``,
after resolving the pairs the stream has finished), one a step of the
traced epoch. None where the program has no such span."""

from __future__ import annotations


def read(r: dict):
    try:
        from dmlc_tpu_torch.obs import trace
    except ImportError:
        return None
    if not hasattr(trace, "device_span_totals"):
        return None
    trace.resolve_device_spans()
    got = trace.device_span_totals().get("fm.scatter")
    if not got or not got["count"]:
        return None
    return got["ms"] / got["count"]

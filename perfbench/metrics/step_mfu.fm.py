"""step_mfu.fm: the FM window's least device time over its time (%): the
sum over the window's steps of max(flops / 67 TFLOP/s, bytes / 3.35
TB/s), the H100's float32 and memory peaks, with each step's work
counted from its batch (rows B, entries E, distinct ids U) by
:func:`work`."""

from __future__ import annotations

from perfbench.lib import peaks


def work(rows: int, entries: int, distinct: int, k: int) -> tuple:
    """(flops, bytes) one SGD step of a K-factor FM needs on a batch.

    Flops: per entry 4K + 2 forward (x*v, x*w, the sums s and q of x*v
    and (x*v)^2, the linear sum) and 3K + 3 backward (wg*x, s - x*v, its
    product, the sums into gv and gw); per row 3K + 13 (s*s - q, its sum,
    the margin, the loss and its gradient); per distinct id 2(K + 1) for
    the update of its w and v. Bytes (4 each): each entry's value and id,
    the offsets, labels and weights, and the touched rows of w and v read
    once and written once, and b."""
    flops = entries * (7 * k + 5) + rows * (3 * k + 13) \
        + 2 * distinct * (k + 1)
    nbytes = 4 * (2 * entries + (rows + 1) + 2 * rows
                  + 2 * distinct * (k + 1) + 2)
    return flops, nbytes


def read(r: dict):
    steps = r.get("window_batches") or []
    if not steps:
        return None
    least = sum(peaks.least_seconds(*work(b, e, u, r["num_factors"]))
                for b, e, u in steps)
    return 100.0 * least / r["window_s"]

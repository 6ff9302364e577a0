"""step_mfu.gbdt: the GBDT window's least device time over its time (%):
for each whole fit of the window, its binning and its trees, each
max(flops / 67 TFLOP/s, bytes / 3.35 TB/s) (the H100's float32 and
memory peaks), counted by :func:`binning_work` and :func:`tree_work`."""

from __future__ import annotations

import math

from perfbench.lib import peaks


def id_bytes(count: int) -> int:
    """The least whole bytes that hold ``count`` distinct ids."""
    return max(1, math.ceil(math.log2(max(count, 2)) / 8))


def binning_work(n: int, f: int, bins: int) -> tuple:
    """(flops, bytes) of the edges and the bins: each value read once and
    placed by a search of log2(bins) steps; each bin id written once."""
    flops = n * f * (1 + math.log2(bins))
    nbytes = n * f * (4 + id_bytes(bins)) + 4 * f * (bins - 1)
    return flops, nbytes


def level_work(n: int, f: int, bins: int, nodes: int) -> tuple:
    """(flops, bytes) of one level's (g, h) histogram: every row's bin ids,
    node and (g, h) read once, two adds a (row, feature), the [nodes, f,
    bins, 2] float32 histogram written once."""
    flops = 2 * n * f
    nbytes = n * (f * id_bytes(bins) + id_bytes(nodes) + 8) \
        + nodes * f * bins * 8
    return flops, nbytes


def tree_work(n: int, f: int, bins: int, depth: int) -> tuple:
    """(flops, bytes) of one tree: the gradients (margin and label read,
    g and h written; ~16 flops a row with the loss), each level's
    histogram (:func:`level_work`), its split search (the histogram read
    again, ~20 flops a cell) and the descent (the split column's bin read,
    the node written; 3 flops a row), the leaf sums (node, g, h read) and
    the margin update (margin and node read, margin written)."""
    flops, nbytes = 16 * n, 16 * n
    node = id_bytes(1 << depth)
    for d in range(depth):
        nodes = 1 << d
        hf, hb = level_work(n, f, bins, nodes)
        flops += hf + 20 * nodes * f * bins + 3 * n
        nbytes += hb + nodes * f * bins * 8 + n * (id_bytes(bins) + node)
    flops += 4 * n
    nbytes += n * (node + 8) + n * (node + 8)
    return flops, nbytes


def read(r: dict):
    if not r.get("fits"):
        return None
    n, f, bins = r["rows"], r["features"], r["num_bins"]
    per_fit = peaks.least_seconds(*binning_work(n, f, bins)) + r["trees"] \
        * peaks.least_seconds(*tree_work(n, f, bins, r["max_depth"]))
    return 100.0 * r["fits"] * per_fit / r["window_s"]

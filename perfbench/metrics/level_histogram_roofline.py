"""level_histogram_roofline: the GBDT's (g, h) histogram of its deepest
level (``models/gbdt._level_histogram``, depth max_depth - 1) at the
cell's rows, with the nodes the fit's first tree gives them and the
first tree's gradients, timed alone with CUDA events and a cold L2,
against its least time (``step_mfu.gbdt``'s ``level_work``), in %."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.lib import bench, devtime, peaks


def nodes_at(xb: torch.Tensor, feature, split, depth: int) -> torch.Tensor:
    """Each row's node [N] int32 after ``depth`` levels of one tree given
    level by level (a feature below 0 sends every row left)."""
    feature = torch.as_tensor(np.asarray(feature), device=xb.device).long()
    split = torch.as_tensor(np.asarray(split), device=xb.device).long()
    node = torch.zeros(xb.shape[0], dtype=torch.int64, device=xb.device)
    for d in range(depth):
        at = (1 << d) - 1 + node
        f_row = feature[at]
        value = xb.gather(1, f_row.clamp_min(0)[:, None])[:, 0].long()
        node = 2 * node + ((f_row >= 0) & (value > split[at])).long()
    return node.to(torch.int32)


def read(r: dict):
    try:
        from dmlc_tpu_torch.models.gbdt import _level_histogram, apply_bins
    except ImportError:
        return None
    dev, bins = r["device"], r["num_bins"]
    depth = r["max_depth"] - 1
    xb = apply_bins(torch.as_tensor(r["x"], device=dev), r["edges"])
    node = nodes_at(xb, r["forest"]["feature"][0], r["forest"]["bin"][0],
                    depth)
    y = torch.as_tensor(r["y"], device=dev)
    g = 0.5 - y  # sigmoid(0) - y at the first tree's zero margin
    h = torch.full_like(y, 0.25)
    nodes = 1 << depth
    ms = devtime.time_alone(
        lambda: _level_histogram(xb, node, g, h, nodes, bins), [()], dev,
        iters=10)
    mfu = bench.load_module("metrics", "step_mfu.gbdt")
    flops, nbytes = mfu.level_work(r["rows"], r["features"], bins, nodes)
    return peaks.share(flops, nbytes, ms * 1e-3)

"""Plain histogram boosting, the yardstick of the GBDT cells: xgboost's
hist method with its documented defaults, level by level.

- Edges: for each feature the ``num_bins - 1`` cut points at quantiles
  i / num_bins (numpy's linear method: order statistics of the column and
  numpy's interpolation between them), then made strictly increasing by
  e[b] = max(e[b], e[b-1] + 4 eps max(|e[b-1]|, 1)), eps the float32
  epsilon, with the increments from the cut points as computed.
- Bins: the left ``searchsorted`` of each value in its feature's edges.
- Gradients of the logistic loss at margin m: g = sigmoid(m) - y,
  h = max(sigmoid(m) (1 - sigmoid(m)), 1e-16); the first margin is 0.
- A depth-D tree is a complete binary tree. At each level every node
  sums (g, h) by (feature, bin), and takes the split (feature f, bin t:
  bins <= t go left) of the largest gain
  1/2 [GL^2/(HL+lambda) + GR^2/(HR+lambda) - G^2/(H+lambda)], the first
  one in (feature, bin) order, over splits whose children both hold a
  hessian sum of at least min_child_weight (the last bin is no split). A
  node whose best gain is not above 0 sends every row left. Node n's
  children are 2n and 2n + 1.
- Leaves: -G / (H + lambda); the margin moves by learning_rate * leaf.

Float32 throughout, sums by ``index_add_``. Imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def quantile_edges(x: torch.Tensor, num_bins: int) -> np.ndarray:
    """Cut points [F, num_bins - 1] float32 of the float32 columns of x
    [N, F] (on any device), as ``np.quantile(x, q, axis=0)`` at q = i /
    num_bins, made strictly increasing (module docstring)."""
    n = x.shape[0]
    qs = np.linspace(0.0, 1.0, num_bins + 1)[1:-1]
    virtual = (n - 1) * qs
    lo = np.floor(virtual).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    gamma = (virtual - lo)[:, None]
    ranks = torch.as_tensor(np.concatenate([lo, hi]), device=x.device)
    stats = torch.sort(x.float(), dim=0).values.index_select(0, ranks)
    stats = stats.cpu().numpy()
    a, b = stats[:len(qs)], stats[len(qs):]
    # numpy's _lerp: the difference in float32, the rest in float64
    diff = np.subtract(b, a)
    cut = np.add(a, diff * gamma)
    high = np.broadcast_to(gamma >= 0.5, cut.shape)
    cut[high] = np.subtract(b, diff * (1 - gamma))[high]
    edges = cut.T.astype(np.float32).astype(np.float64)  # [F, B-1]
    step = 4.0 * np.finfo(np.float32).eps * np.maximum(np.abs(edges), 1.0)
    for j in range(1, edges.shape[1]):
        edges[:, j] = np.maximum(edges[:, j], edges[:, j - 1] + step[:, j - 1])
    return edges.astype(np.float32)


def bin_rows(x: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """Bin ids [N, F] int64 of x [N, F] on x's device."""
    e = torch.as_tensor(np.ascontiguousarray(edges), device=x.device)
    return torch.searchsorted(e, x.float().T.contiguous(), side="left").T


def grad_hess(margin: torch.Tensor, y: torch.Tensor):
    p = torch.sigmoid(margin)
    return p - y, torch.clamp_min(p * (1.0 - p), 1e-16)


def build_tree(bins: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
               max_depth: int, num_bins: int, reg_lambda: float,
               min_child_weight: float) -> dict:
    """One tree: {"feature", "bin": [2^D - 1] level by level, "leaf":
    [2^D], "node": [N] each row's leaf}."""
    n, nf = bins.shape
    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    feats, splits = [], []
    for depth in range(max_depth):
        nodes = 1 << depth
        size = nodes * nf * num_bins
        hist_g = torch.zeros(size, dtype=g.dtype, device=g.device)
        hist_h = torch.zeros(size, dtype=g.dtype, device=g.device)
        for f in range(nf):
            key = (node * nf + f) * num_bins + bins[:, f]
            hist_g.index_add_(0, key, g)
            hist_h.index_add_(0, key, h)
        gl = hist_g.view(nodes, nf, num_bins).cumsum(dim=2)
        hl = hist_h.view(nodes, nf, num_bins).cumsum(dim=2)
        gt = gl[:, :1, -1:]
        ht = hl[:, :1, -1:]
        gr, hr = gt - gl, ht - hl
        gain = 0.5 * (gl * gl / (hl + reg_lambda) + gr * gr / (hr + reg_lambda)
                      - gt * gt / (ht + reg_lambda))
        ok = (hl >= min_child_weight) & (hr >= min_child_weight)
        ok[:, :, -1] = False
        gain = torch.where(ok, gain, torch.full_like(gain, -float("inf")))
        best_gain, best = gain.view(nodes, -1).max(dim=1)
        first = torch.argmax(gain.view(nodes, -1), dim=1)
        feature = torch.where(best_gain > 0, first // num_bins,
                              torch.full_like(first, -1))
        split = first % num_bins
        feats.append(feature)
        splits.append(split)
        f_row = feature[node]
        value = bins.gather(1, f_row.clamp_min(0)[:, None])[:, 0]
        node = 2 * node + ((f_row >= 0) & (value > split[node])).long()
    leaves = 1 << max_depth
    gs = torch.zeros(leaves, dtype=g.dtype, device=g.device).index_add_(
        0, node, g)
    hs = torch.zeros(leaves, dtype=g.dtype, device=g.device).index_add_(
        0, node, h)
    return {"feature": torch.cat(feats), "bin": torch.cat(splits),
            "leaf": -gs / (hs + reg_lambda), "node": node}


def descend(bins: torch.Tensor, feature, split, max_depth: int):
    """Each row's leaf [N] under one tree's level-by-level ``feature`` and
    ``bin`` arrays (a feature below 0 sends every row left)."""
    feature = torch.as_tensor(np.asarray(feature), device=bins.device).long()
    split = torch.as_tensor(np.asarray(split), device=bins.device).long()
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for depth in range(max_depth):
        at = (1 << depth) - 1 + node
        f_row = feature[at]
        value = bins.gather(1, f_row.clamp_min(0)[:, None])[:, 0]
        node = 2 * node + ((f_row >= 0) & (value > split[at])).long()
    return node


def boost(bins: torch.Tensor, y: torch.Tensor, trees: int, param: dict,
          dtype=torch.float32) -> dict:
    """``trees`` rounds from margin 0 in ``dtype``. Returns {"loss":
    [trees + 1] mean loss before each tree and after the last, "leaf":
    [trees] leaf arrays (float64 numpy), "margin": the final margin [N],
    "feature", "bin": [trees] split arrays}."""
    y = y.to(dtype)
    margin = torch.zeros(bins.shape[0], dtype=dtype, device=bins.device)
    out: Dict[str, List] = {"loss": [], "leaf": [], "feature": [],
                            "bin": []}
    for _ in range(trees):
        out["loss"].append(float(F.binary_cross_entropy_with_logits(
            margin.float(), y.float())))
        g, h = grad_hess(margin, y)
        tree = build_tree(bins, g, h, param["max_depth"], param["num_bins"],
                          param["reg_lambda"], param["min_child_weight"])
        margin = margin + param["learning_rate"] * tree["leaf"][tree["node"]]
        out["leaf"].append(tree["leaf"].double().cpu().numpy())
        out["feature"].append(tree["feature"].cpu().numpy())
        out["bin"].append(tree["bin"].cpu().numpy())
    out["loss"].append(float(F.binary_cross_entropy_with_logits(
        margin.float(), y.float())))
    out["margin"] = margin
    return out


def forest_margin(bins: torch.Tensor, trees: Dict[str, np.ndarray],
                  count: int, max_depth: int, learning_rate: float):
    """The margin [N] (float64) of the first ``count`` trees of a forest
    given as {"feature", "bin": [T, 2^D - 1], "leaf": [T, 2^D]}."""
    margin = torch.zeros(bins.shape[0], dtype=torch.float64,
                         device=bins.device)
    for t in range(count):
        node = descend(bins, trees["feature"][t], trees["bin"][t], max_depth)
        leaf = torch.as_tensor(np.asarray(trees["leaf"][t], np.float64),
                               device=bins.device)
        margin = margin + learning_rate * leaf[node]
    return margin

"""Histogram gradient-boosted decision trees with one histogram all-reduce
a level, in PyTorch: the port of ``dmlc_tpu/models/gbdt.py``.

The workload dmlc-core exists to serve: xgboost's hist mode, with rabit
allreducing per-level gradient histograms across workers.

- **quantile binning**: features → bin ids once, up front
  (:func:`fit_bins`, :func:`apply_bins`), so split finding never touches
  floats;
- **level-wise growth with static shapes**: a depth-D tree is a complete
  binary tree; level ℓ builds one ``[2^ℓ, F, num_bins, 2C]`` (grad, hess)
  histogram by a segment sum (:func:`_level_histogram`), finds every
  node's best split with a prefix sum over the bins and an argmax
  (:func:`_find_splits`), and descends each row's node id with one
  gather;
- **rabit's allreduce**: with a ``torch.distributed`` group each rank holds
  its own rows, sums its local histogram, and ONE ``bucketed_all_reduce``
  a level makes every rank's histogram the group's; the splits after it
  are the same on every rank. The leaf sums take one more all-reduce a
  tree, and the loss and weight sums one.

Summation orders are the reference's on its CPU backend, so that the CPU
route gives its bits: each histogram cell and each leaf sums its rows in
row order from 0 (a stable sort by key, then ``torch.segment_reduce``,
which adds each segment serially on both devices: no float atomics, the
same bits run after run), and the prefix sum over the bins is XLA's CPU
cumulative sum (serial inside blocks of 16, the block totals scanned the
same way, then added; :func:`_cumsum_bins`). The card route runs the same
ops; it differs from the CPU route only where a transcendental function
(``sigmoid``, ``exp``, ``log1p``, ``softmax``) rounds differently.

Each rank draws its row mask with the port's copy of jax's threefry
(``utils/prng``), folding in its rank in the group where the reference
folds in ``axis_index``. The forest is a Python loop over trees with no
host sync inside it: the losses stay stacked on the device and come back
in one copy.

Absent sparse entries densify to 0.0 and bin like any value; a NaN lands
in the last bin (the reference's semantics, not xgboost's missing-value
direction).

Observability follows the reference: the forest, each tree build, the
gradient and the margin update are instrumented sites (``gbdt.forest``,
``gbdt.build_tree``, ``gbdt.grad``, ``gbdt.margin_update``), ``fit_uri``
bins each chunk in a ``bin_block`` span that ends its flow, and one fit
is one ``FitLoopObs`` epoch whose trees are its steps (the epoch
histogram is the goodput ledger's device_step for a feed-less fit).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.collective.device import DeviceEngine, \
    bucketed_all_reduce
from dmlc_tpu_torch.io.filesystem import create_stream
from dmlc_tpu_torch.io.serializer import load_obj, save_obj
from dmlc_tpu_torch.obs.device_telemetry import instrumented_step
from dmlc_tpu_torch.params.parameter import Parameter, field
from dmlc_tpu_torch.utils import prng
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check, log_info


class GBDTParam(Parameter):
    """Hyper-parameters (a dmlc Parameter struct, parameter.h style)."""

    objective = field(
        str, "logistic",
        description="Loss: logistic (labels 0/1), squared, or softmax "
                    "(labels are class ids; set num_class).",
    )
    num_class = field(
        int, 0, lower_bound=0,
        description="Class count for objective=softmax (>= 2); 0 for "
                    "scalar objectives.",
    )
    num_trees = field(int, 20, lower_bound=1)
    max_depth = field(int, 6, lower_bound=1, upper_bound=12)
    learning_rate = field(float, 0.3, lower_bound=0.0)
    num_bins = field(
        int, 256, lower_bound=2, upper_bound=65536,
        description="Histogram bins per feature (255 cut points).",
    )
    reg_lambda = field(
        float, 1.0, lower_bound=0.0,
        description="L2 regularization on leaf values (xgboost lambda).",
    )
    min_child_weight = field(
        float, 1.0, lower_bound=0.0,
        description="Minimum hessian sum in a child for a split to count.",
    )
    subsample = field(
        float, 1.0, lower_bound=0.0, upper_bound=1.0,
        description="Per-tree row subsampling rate (stochastic gradient "
                    "boosting; bernoulli mask on (g, h)).",
    )
    colsample_bytree = field(
        float, 1.0, lower_bound=0.0, upper_bound=1.0,
        description="Per-tree feature subsampling rate (ceil(c*F) "
                    "features drawn without replacement).",
    )
    seed = field(
        int, 0,
        description="PRNG seed for subsample/colsample masks "
                    "(deterministic per (seed, tree)).",
    )


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


def _lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """numpy's quantile interpolation (``numpy.lib._function_base_impl.
    _lerp``) on f32 order statistics and float64 weights: the difference
    is taken in f32, everything after it in float64."""
    diff = np.subtract(b, a)
    out = np.add(a, diff * t)
    np.subtract(b, diff * (1 - t), out=out, where=t >= 0.5)
    return out


def _quantiles_on_device(x: torch.Tensor, qs: np.ndarray) -> np.ndarray:
    """``np.quantile(x, qs, axis=0)`` (linear method) for a float32 tensor
    on the card: each column sorted there, only the two order statistics
    each cut point needs copied back, then numpy's interpolation in
    float64 on the host. ``torch.quantile`` is not used: it refuses inputs
    of 2^24 elements or more."""
    n = x.shape[0]
    virtual = (n - 1) * qs
    prev = np.floor(virtual)
    nxt = prev + 1
    above = virtual >= n - 1
    prev[above] = -1
    nxt[above] = -1
    gamma = (virtual - prev)[:, None]
    # -1 (past the last rank) is numpy's index of the largest value; the
    # largest value itself comes back too: NaN sorts last on both sides,
    # and numpy gives a column holding a NaN NaN quantiles
    ranks = torch.as_tensor(np.concatenate([prev, nxt, [-1]]).astype(
        np.int64) % n, device=x.device)
    stats = torch.sort(x, dim=0).values.index_select(0, ranks).cpu().numpy()
    q = len(qs)
    out = _lerp(stats[:q], stats[q:2 * q], gamma)
    out[:, np.isnan(stats[-1])] = np.nan
    return out


def fit_bins(x, num_bins: int = 256) -> np.ndarray:
    """Per-feature quantile cut points → edges [F, num_bins-1] (f32).

    Bin b holds values in (edges[b-1], edges[b]]; ids come from
    ``searchsorted(edges, x, side="left")`` so they land in [0, num_bins).

    The cut points are ``np.quantile``'s (linear method) on both routes:
    numpy itself for a numpy array or a CPU tensor, and for a tensor on the
    card a sort of each column there with numpy's interpolation on the host
    (:func:`_quantiles_on_device`), so both give the reference's CPU edges
    bit for bit. The reference's accelerator route (``jnp.quantile`` in
    f32) is not the oracle here: it rounds the interpolation to f32.
    """
    on_card = isinstance(x, torch.Tensor) and x.device.type != "cpu"
    if not on_card:
        x = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x,
                       dtype=np.float32)
    check(x.ndim == 2, "fit_bins expects [N, F]")
    qs = np.linspace(0.0, 1.0, num_bins + 1)[1:-1]
    if on_card:
        edges = _quantiles_on_device(x.float(), qs).T.astype(np.float32)
    else:
        edges = np.quantile(x, qs, axis=0).T.astype(np.float32)  # [F, B-1]
    # strictly increasing edges keep searchsorted stable when a feature has
    # few distinct values: the recurrence e[b] = max(e[b], e[b-1] + d[b-1])
    # with d = 4·eps·max(|e|, 1), solved in closed form as a running
    # maximum of e - c (c the exclusive cumsum of d), in float64 so the
    # increments survive, as the reference does.
    eps = np.finfo(np.float32).eps
    e = edges.astype(np.float64)
    d = 4.0 * eps * np.maximum(np.abs(e), 1.0)
    c = np.cumsum(d, axis=1) - d  # exclusive prefix sum
    return (c + np.maximum.accumulate(e - c, axis=1)).astype(np.float32)


def apply_bins(x: torch.Tensor, edges) -> torch.Tensor:
    """x [N, F] float tensor → bin ids [N, F] int32 on x's device, by a
    batched left ``searchsorted`` of each column in its edges, in the
    reference's total order, where NaN sorts above +inf: a NaN edge
    searches as +inf, and a NaN value takes the count of its column's
    non-NaN edges (the last bin for fitted edges)."""
    x = x.float()
    e = torch.as_tensor(np.ascontiguousarray(edges, dtype=np.float32),
                        device=x.device)
    nan_edge = torch.isnan(e)
    ids = torch.searchsorted(
        torch.where(nan_edge, torch.full_like(e, float("inf")), e),
        x.T.contiguous(), side="left", out_int32=True).T
    below_nan = (~nan_edge).sum(dim=1, dtype=torch.int32)
    return torch.where(torch.isnan(x), below_nan[None, :], ids).contiguous()


def _apply_bins_np(x: np.ndarray, edges: np.ndarray,
                   num_bins: int) -> np.ndarray:
    """Host-side twin of :func:`apply_bins` in the smallest dtype that
    holds the ids, for fit_uri's pass 2, which bins block by block on the
    host."""
    dt = (np.uint8 if num_bins <= 256
          else np.uint16 if num_bins <= 65536 else np.int32)
    out = np.empty(x.shape, dtype=dt)
    for f in range(x.shape[1]):
        out[:, f] = np.searchsorted(edges[f], x[:, f], side="left")
    return out


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _grad_hess(objective: str, margin, label):
    """Per-row (g, h) for the second-order boosting objective.

    softmax: margin is [N, K], label holds class ids; (g, h) are [N, K]
    with the diagonal-hessian approximation p(1−p) (xgboost's
    multi:softprob; the K channels share one tree structure)."""
    if objective == "logistic":
        p = torch.sigmoid(margin)
        return p - label, torch.clamp_min(p * (1.0 - p), 1e-16)
    if objective == "squared":
        return margin - label, torch.ones_like(margin)
    if objective == "softmax":
        p = torch.softmax(margin, dim=-1)
        onehot = torch.nn.functional.one_hot(
            label.long(), margin.shape[-1]).to(margin.dtype)
        return p - onehot, torch.clamp_min(p * (1.0 - p), 1e-16)
    raise ValueError(f"unknown objective {objective!r}")


def _loss(objective: str, margin, label):
    if objective == "logistic":
        return torch.clamp_min(margin, 0.0) - margin * label + torch.log1p(
            torch.exp(-torch.abs(margin)))
    if objective == "softmax":
        logp = torch.log_softmax(margin, dim=-1)
        return -logp.gather(1, label.long()[:, None])[:, 0]
    return 0.5 * (margin - label) ** 2


def _group_sum(tensors, group):
    return tensors if group is None else bucketed_all_reduce(tensors, group)


def _grad_loss_core(objective: str, margin, y, w, group):
    """(g, h, weighted mean loss) for one boosting round. Instance weights
    scale (g, h): a weight-2 row trains exactly like two copies of it.
    With a group the loss and weight sums (or the mean loss) cross it in
    one all-reduce."""
    g, h = _grad_hess(objective, margin, y)
    if w is not None:
        wexp = w if g.ndim == 1 else w[:, None]
        g = g * wexp
        h = h * wexp
        lsum, wsum = _group_sum(
            [torch.sum(w * _loss(objective, margin, y)), torch.sum(w)],
            group)
        return g, h, lsum / torch.clamp_min(wsum, 1e-12)
    loss = torch.mean(_loss(objective, margin, y))
    if group is not None:
        loss = _group_sum([loss], group)[0] / dist.get_world_size(group)
    return g, h, loss


def _margin_update_core(margin, leaf, node, learning_rate):
    # leaf [2^D] (scalar objectives) or [2^D, K] (softmax): the row gather
    # serves both, yielding [N] or [N, K] updates
    return margin + learning_rate * leaf[node]


# ---------------------------------------------------------------------------
# one tree, level by level (all static shapes)
# ---------------------------------------------------------------------------


def _segment_sum(keys: torch.Tensor, vals: torch.Tensor, n_seg: int,
                 rows=None) -> torch.Tensor:
    """out[k] = Σ vals[e] over the entries e with keys[e] == k, [n_seg,
    C], each segment summed in entry order from 0. A stable sort by key,
    then ``torch.segment_reduce`` over every segment's offsets (empty ones
    give 0). ``rows`` maps an entry to its row of ``vals`` (the histogram's
    entries share their row's (g, h)); None means entry e is row e."""
    order = torch.sort(keys, stable=True)
    entries = order.indices if rows is None else rows(order.indices)
    bounds = torch.arange(n_seg + 1, dtype=keys.dtype, device=keys.device)
    offsets = torch.searchsorted(order.values, bounds)
    # the offsets run from 0 to len(keys) and never decrease, by
    # construction, so unsafe=True skips segment_reduce's own checks of them
    return torch.segment_reduce(vals.index_select(0, entries), "sum",
                                offsets=offsets, axis=0, unsafe=True)


def _level_histogram(xb, node, g, h, n_nodes, num_bins):
    """(grad, hess) histogram [n_nodes, F, num_bins, C] by one segment sum.

    One flat key (node, feature, bin) per (row, feature) cell; the 2C
    channels share the key, so the softmax's K classes cost one wider sum.
    Every row stays live through the build (leaf-in-place nodes route
    left), so no masking pass is needed.
    """
    nf = xb.shape[1]
    n_seg = n_nodes * nf * num_bins
    # the reference's int32 guard, kept so that both packages refuse the
    # same configurations
    check(
        n_seg < (1 << 31),
        "histogram key space nodes*features*bins = %d*%d*%d = %d overflows "
        "int32; reduce max_depth, num_bins, or the feature count "
        "(or shard features) so the product stays below 2**31",
        n_nodes, nf, num_bins, n_seg,
    )
    feat = torch.arange(nf, dtype=torch.int32, device=xb.device)[None, :]
    flat = ((node[:, None] * nf + feat) * num_bins
            + xb.to(torch.int32)).reshape(-1)
    g2 = g[:, None] if g.ndim == 1 else g
    h2 = h[:, None] if h.ndim == 1 else h
    c = g2.shape[1]
    gh = torch.cat([g2, h2], dim=1)  # [N, 2C]
    hist = _segment_sum(flat, gh, n_seg, rows=lambda e: e // nf)
    return hist.reshape(n_nodes, nf, num_bins, 2 * c)


def _cumsum_bins(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Inclusive prefix sum over axis 2 in the order of XLA's CPU
    cumulative sum, which the reference's ``jnp.cumsum`` compiles to:
    serial inside blocks of ``block``, the block totals scanned the same
    way, then each block's exclusive prefix added. Explicit f32 adds on
    either device (torch's CPU cumsum accumulates in float64, its CUDA
    cumsum is a parallel scan)."""
    n = x.shape[2]
    if n <= block:
        out = [x[:, :, 0]]
        for j in range(1, n):
            out.append(out[-1] + x[:, :, j])
        return torch.stack(out, dim=2)
    m = -(-n // block)
    pad = x.new_zeros(x.shape[:2] + (m * block - n,) + x.shape[3:])
    blocks = torch.cat([x, pad], dim=2).reshape(
        x.shape[:2] + (m, block) + x.shape[3:])
    inner = _cumsum_bins(blocks.flatten(1, 2)).reshape(blocks.shape)
    totals = _cumsum_bins(inner[:, :, :, -1])
    excl = torch.cat([torch.zeros_like(totals[:, :, :1]),
                      totals[:, :, :-1]], dim=2)
    out = inner + excl[:, :, :, None]
    return out.reshape(x.shape[:2] + (m * block,) + x.shape[3:])[:, :, :n]


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order from 0 (a fixed order on both
    devices)."""
    out = 0.0 + x[..., 0]
    for c in range(1, x.shape[-1]):
        out = out + x[..., c]
    return out


def _find_splits(ghist, hhist, reg_lambda, min_child_weight,
                 feat_mask=None):
    """Vectorized best split per node.

    ghist/hhist [n_nodes, F, B, C] → (feature [n_nodes], bin [n_nodes],
    gain [n_nodes], gtot [n_nodes, C], htot [n_nodes, C]). A split at bin
    t sends bins ≤ t left. gain = ½ Σ_c (GL²/(HL+λ) + GR²/(HR+λ) −
    G²/(H+λ)); a child whose total hessian is under min_child_weight is
    masked out. feature = -1 flags "no positive-gain split" (leaf).
    """
    c = ghist.shape[-1]
    left = _cumsum_bins(torch.cat([ghist, hhist], dim=-1))
    gl, hl = left[..., :c], left[..., c:]
    gtot = gl[:, 0, -1]  # [n, C] (identical for every feature)
    htot = hl[:, 0, -1]
    gr = gtot[:, None, None, :] - gl
    hr = htot[:, None, None, :] - hl

    def score(gsum, hsum):
        # an empty child at reg_lambda=0 is 0/0: select 0 so that no NaN
        # reaches the argmax
        denom = hsum + reg_lambda
        return _channel_sum(torch.where(denom > 0.0, gsum * gsum / denom,
                                        torch.zeros_like(denom)))

    gain = 0.5 * (score(gl, hl) + score(gr, hr)
                  - score(gtot, htot)[:, None, None])
    # cover = total hessian mass across channels (xgboost's multiclass
    # min_child_weight semantics)
    ok = ((_channel_sum(hl) >= min_child_weight)
          & (_channel_sum(hr) >= min_child_weight))
    # the last bin's "split" sends everything left: never a real split
    ok[:, :, -1] = False
    if feat_mask is not None:  # colsample: undrawn features can't split
        ok = ok & feat_mask[None, :, None]
    gain = torch.where(ok, gain, torch.full_like(gain, -float("inf")))
    flat = gain.reshape(gain.shape[0], -1)
    best = torch.argmax(flat, dim=1)  # the first maximum on both devices
    nbins = ghist.shape[2]
    feature = (best // nbins).to(torch.int32)
    split_bin = (best % nbins).to(torch.int32)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    feature = torch.where(best_gain > 0.0, feature,
                          torch.full_like(feature, -1))
    return feature, split_bin, best_gain, gtot, htot


def _stochastic_masks(base_key, tree_idx, n_rows, n_features, subsample,
                      colsample, rank, device):
    """(row_mask [N] f32 | None, feat_mask [F] bool | None) for one tree.

    Deterministic per (seed, tree): ``fold_in(key, t)``. The feature draw
    uses the key before any rank is folded in (every rank must mask the
    same ceil(c·F) features or their histograms disagree); the row draw
    folds in ``rank`` (the rank in the group, None without one), so ranks
    drop different rows. The feature mask is made on the host; the row
    mask on ``device``."""
    k = prng.fold_in(base_key, tree_idx)
    feat_mask = None
    if colsample < 1.0:
        keep = max(1, int(np.ceil(colsample * n_features)))
        order = prng.permutation(prng.fold_in(k, 1), n_features)
        feat_mask = np.zeros(n_features, dtype=bool)
        feat_mask[order[:keep]] = True
    row_mask = None
    if subsample < 1.0:
        rk = prng.fold_in(k, 2)
        if rank is not None:
            rk = prng.fold_in(rk, rank)
        # jax compares the f32 draw with the rate cast to f32
        row_mask = (prng.uniform(rk, n_rows, device)
                    < float(np.float32(subsample))).to(torch.float32)
    return row_mask, feat_mask


def _build_tree_core(xb, g, h, max_depth, num_bins, reg_lambda,
                     min_child_weight, group=None, feat_mask=None):
    """One tree, level by level, all static shapes, no host sync.

    Tree encoding (complete binary tree, n_internal = 2^D − 1 internal
    nodes then 2^D leaves): ``feature``/``bin`` [n_internal] (−1 = the
    node is a leaf-in-place: descent keeps every row left so the subtree
    collapses to its leftmost leaf), ``gain`` [n_internal], ``leaf`` [2^D]
    (or [2^D, K]) f32 leaf values (−G/(H+λ), learning-rate-free), and each
    row's leaf ``node``.

    With ``group``: xb/g/h are this rank's rows; each level sums the local
    histogram and ONE ``bucketed_all_reduce`` makes it the group's.
    Everything after it is the same on every rank.
    """
    n_leaves = 1 << max_depth
    node = torch.zeros(xb.shape[0], dtype=torch.int32, device=xb.device)
    feats, bins, gains = [], [], []
    for depth in range(max_depth):
        hist = _level_histogram(xb, node, g, h, 1 << depth, num_bins)
        hist = _group_sum([hist], group)[0]
        c = hist.shape[-1] // 2
        feature, split_bin, gain, _gt, _ht = _find_splits(
            hist[..., :c], hist[..., c:], reg_lambda, min_child_weight,
            feat_mask=feat_mask)
        feats.append(feature)
        bins.append(split_bin)
        # realized gain per node (0 at leaf-in-place nodes): the raw
        # material of gain-based feature importance
        gains.append(torch.where(feature >= 0, gain,
                                 torch.zeros_like(gain)))
        # descend: right iff this row's bin at the split feature exceeds
        # the threshold; leaf-in-place nodes send all left
        node_l = node.long()
        nfeat = feature[node_l]
        nbin = split_bin[node_l]
        fval = xb.gather(1, torch.clamp_min(nfeat, 0).long()[:, None])[:, 0]
        go_right = (nfeat >= 0) & (fval.to(torch.int32) > nbin)
        node = node * 2 + go_right.to(torch.int32)
    # leaf values from each leaf's (G, H): [2^D] for scalar objectives,
    # [2^D, K] vector leaves for softmax
    g2 = g[:, None] if g.ndim == 1 else g
    h2 = h[:, None] if h.ndim == 1 else h
    c = g2.shape[1]
    sums = _segment_sum(node, torch.cat([g2, h2], dim=1), n_leaves)
    sums = _group_sum([sums], group)[0]
    gleaf, hleaf = sums[:, :c], sums[:, c:]
    if g.ndim == 1:
        gleaf, hleaf = gleaf[:, 0], hleaf[:, 0]
    # empty leaves at reg_lambda=0 are 0/0: emit 0, since unseen data can
    # route there at predict time
    denom = hleaf + reg_lambda
    leaf = torch.where(denom > 0.0, -gleaf / denom, torch.zeros_like(denom))
    return (torch.cat(feats), torch.cat(bins), torch.cat(gains), leaf,
            node.long())


def make_tree_builder(max_depth: int, num_bins: int, reg_lambda: float,
                      min_child_weight: float, group=None,
                      with_feat_mask: bool = False):
    """(xb, g, h[, feat_mask]) → (feature, bin, gain, leaf, node): one
    tree (see :func:`_build_tree_core`); ``with_feat_mask`` adds the
    colsample feature mask ([F] bool) as a trailing argument."""

    def build(xb, g, h, *maybe_mask):
        return _build_tree_core(
            xb, g, h, max_depth, num_bins, reg_lambda, min_child_weight,
            group=group,
            feat_mask=maybe_mask[0] if with_feat_mask else None)

    return instrumented_step(build, "gbdt.build_tree")


def make_forest_builder(
    num_trees: int,
    max_depth: int,
    num_bins: int,
    reg_lambda: float,
    min_child_weight: float,
    learning_rate: float,
    objective: str,
    group=None,
    weighted: bool = False,
    num_class: int = 0,
    with_eval: bool = False,
    subsample: float = 1.0,
    colsample: float = 1.0,
    seed: int = 0,
    log_every: int = 0,
):
    """The boosting loop: ``(xb, y[, w][, xe, ye]) → (trees, losses [T]
    [, eval_losses [T]])``, tensors on xb's device.

    A Python loop over trees with no host sync inside it (the reference
    fuses it into one ``lax.scan``): each tree's masks come from
    (seed, tree), its losses stay on the device, stacked at the end.
    ``trees`` is ``{feature, bin, gain: [T, n_internal], leaf: [T, 2^D]
    or [T, 2^D, K]}``, the layout :func:`predict_trees` consumes. The
    instance weights ``w`` only when ``weighted``; the binned eval set
    (the per-tree post-update eval losses, the xgboost watchlist) only
    when ``with_eval``, and never with a group. ``log_every`` > 0 logs the
    loss every ``log_every`` trees, the one host read inside the loop.
    """
    check(group is None or not with_eval,
          "group forest builds don't take an eval set: evaluate the "
          "replicated model after fit")
    offsets = _tree_level_offsets(max_depth)
    rank = None if group is None else dist.get_rank(group)
    build = make_tree_builder(max_depth, num_bins, reg_lambda,
                              min_child_weight, group,
                              with_feat_mask=colsample < 1.0)
    grad = instrumented_step(
        lambda margin, y, w: _grad_loss_core(objective, margin, y, w, group),
        "gbdt.grad")
    margin_update = instrumented_step(
        lambda margin, leaf, node: _margin_update_core(
            margin, leaf, node, learning_rate),
        "gbdt.margin_update")

    def forest(xb, y, *rest):
        i = 0
        w = rest[i] if weighted else None
        i += 1 if weighted else 0
        xe, ye = (rest[i], rest[i + 1]) if with_eval else (None, None)
        device = xb.device
        n_rows, nf = xb.shape

        def zero_margin(n):
            shape = (n,) if objective != "softmax" else (n, num_class)
            return torch.zeros(shape, dtype=torch.float32, device=device)

        base_key = prng.PRNGKey(seed)
        masks = [_stochastic_masks(base_key, t, n_rows, nf, subsample,
                                   colsample, rank, device)
                 for t in range(num_trees)]
        # the feature masks cross to the device in one copy, before the loop
        feat_masks = None
        if colsample < 1.0:
            feat_masks = torch.as_tensor(
                np.stack([m[1] for m in masks]), device=device)
        margin = zero_margin(n_rows)
        vmargin = zero_margin(xe.shape[0]) if with_eval else None
        feats, bins, gains, leaves, losses, vlosses = [], [], [], [], [], []
        for t in range(num_trees):
            g, h, loss = grad(margin, y, w)
            row_mask = masks[t][0]
            if row_mask is not None:
                rexp = row_mask if g.ndim == 1 else row_mask[:, None]
                g = g * rexp
                h = h * rexp
            mask_args = () if feat_masks is None else (feat_masks[t],)
            feature, split_bin, gain, leaf, node = build(xb, g, h,
                                                         *mask_args)
            margin = margin_update(margin, leaf, node)
            if with_eval:
                vnode = _descend_tree(xe, feature, split_bin, max_depth,
                                      offsets)
                vmargin = _margin_update_core(vmargin, leaf, vnode,
                                              learning_rate)
                vlosses.append(torch.mean(_loss(objective, vmargin, ye)))
            feats.append(feature)
            bins.append(split_bin)
            gains.append(gain)
            leaves.append(leaf)
            losses.append(loss)
            if log_every and (t + 1) % log_every == 0:
                log_info("tree %d loss %.6f", t + 1, float(loss))
        trees = {"feature": torch.stack(feats), "bin": torch.stack(bins),
                 "gain": torch.stack(gains), "leaf": torch.stack(leaves)}
        if with_eval:
            return trees, torch.stack(losses), torch.stack(vlosses)
        return trees, torch.stack(losses)

    # its body is the gbdt.grad / build_tree / margin_update sites: its
    # record is theirs summed, and the trees never run under the cost mode
    return instrumented_step(forest, "gbdt.forest", composite=True)


def _tree_level_offsets(max_depth: int) -> np.ndarray:
    """Start offset of each level's nodes in the flat feature/bin arrays."""
    return np.cumsum([0] + [1 << d for d in range(max_depth)])[:-1]


def _descend_tree(xb, feature, split_bin, max_depth, offsets):
    """Leaf index [N] (int64) for binned rows under one tree's flat arrays:
    the D-gather descent shared by prediction and eval-set tracking."""
    node = torch.zeros(xb.shape[0], dtype=torch.int64, device=xb.device)
    for depth in range(max_depth):
        idx = int(offsets[depth]) + node
        nfeat = feature[idx]
        nbin = split_bin[idx]
        fval = xb.gather(1, torch.clamp_min(nfeat, 0).long()[:, None])[:, 0]
        go_right = (nfeat >= 0) & (fval.to(torch.int32) > nbin)
        node = node * 2 + go_right.long()
    return node


def predict_trees(trees: Dict, xb: torch.Tensor, max_depth: int):
    """Sum of leaf values over all trees for binned rows xb [N, F], tree
    by tree in forest order from 0. trees: {"feature": [T, n_internal],
    "bin": [T, n_internal], "leaf": [T, 2^D] or [T, 2^D, K]}. Returns [N]
    or [N, K]."""
    offsets = _tree_level_offsets(max_depth)
    leaf = trees["leaf"]
    out = torch.zeros((xb.shape[0],) + tuple(leaf.shape[2:]),
                      dtype=leaf.dtype, device=xb.device)
    for t in range(leaf.shape[0]):
        node = _descend_tree(xb, trees["feature"][t], trees["bin"][t],
                             max_depth, offsets)
        out = out + leaf[t][node]
    return out


class GBDTLearner:
    """In-core histogram boosting: fit(x, y) → trees (xgboost hist mode).

    ``device=None`` means cuda, and raises without a CUDA device; pass
    ``device="cpu"`` for the plain PyTorch route. With a ``group`` (a
    ``torch.distributed`` process group) each rank holds its own rows, one
    shard of the distributed-xgboost layout: the histograms all-reduce
    over the group and every rank ends with the same model. The margin is
    updated tree by tree, so training never rescans the forest.
    """

    def __init__(self, device=None, group=None, **hyper):
        self.device = resolve_device(device)
        self.group = group
        self.param = GBDTParam()
        self.param.init(hyper)
        self.edges: Optional[np.ndarray] = None
        self.trees: Optional[Dict] = None
        self._engine = None  # row-count and weighted-ness agreement, lazy
        self.eval_history: Optional[list] = None  # per-tree eval_set loss
        self.best_iteration: Optional[int] = None  # its argmin (0-based)

    # ---- fit -----------------------------------------------------------
    def _multirank(self) -> bool:
        return self.group is not None and dist.get_world_size(self.group) > 1

    def _get_engine(self) -> DeviceEngine:
        if self._engine is None:
            self._engine = DeviceEngine(self.group)
        return self._engine

    def _check_edges(self, num_features: int) -> None:
        """User-supplied edges must match (F, num_bins-1): oversize bin ids
        would walk off the histogram's key space."""
        want = (num_features, self.param.num_bins - 1)
        check(self.edges.shape == want,
              "edges shape %s does not match (num_features, num_bins-1) "
              "= %s", self.edges.shape, want)

    def _sync_row_count(self, n_local: int, trim: bool) -> int:
        """Row-count agreement across the group, as the reference's global
        assembly requires: one allreduce of ``[usable, -usable]`` (min)
        makes ragged input either a trim to the group's minimum
        (``trim=True``) or a clean error."""
        if not self._multirank():
            return n_local
        lo, neg_hi = (int(v) for v in self._get_engine().allreduce(
            np.array([n_local, -n_local]), op="min"))
        if trim:
            return lo
        check(lo == -neg_hi,
              "processes hold unequal row counts (%d..%d); global "
              "assembly requires equal local N — trim (fit_uri: "
              "drop_remainder=True) or pad", lo, -neg_hi)
        return n_local

    def fit(self, x: np.ndarray, y: np.ndarray, log_every: int = 0,
            edges: Optional[np.ndarray] = None,
            weight: Optional[np.ndarray] = None,
            eval_set: Optional[tuple] = None):
        """Train on an in-memory dense [N, F] float matrix. Returns the
        per-tree weighted mean loss history (evaluated before each tree's
        update, so entry 0 is the base-margin loss).

        ``weight`` [N] scales each row's (g, h): a weight-2 row trains
        exactly like two copies of it. ``eval_set=(x_val, y_val)`` tracks
        the held-out loss after every tree; ``self.eval_history`` then
        holds it and ``self.best_iteration`` its argmin, which
        :meth:`truncate` can cut the forest back to (no group).

        With a group of more than one rank, ``x``/``y`` are this rank's
        rows and every rank must pass the same ``edges``.
        """
        p = self.param
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        check(x.ndim == 2 and y.shape == (x.shape[0],),
              "fit expects x [N, F], y [N]")
        if weight is not None:
            weight = np.asarray(weight, dtype=np.float32)
            check(weight.shape == y.shape, "weight must be [N]")
        if eval_set is not None:
            check(self.group is None,
                  "eval_set requires group=None (evaluate the replicated "
                  "model after a group fit)")
            xe = np.asarray(eval_set[0], dtype=np.float32)
            ye = np.asarray(eval_set[1], dtype=np.float32)
            check(xe.ndim == 2 and xe.shape[1] == x.shape[1]
                  and ye.shape == (xe.shape[0],),
                  "eval_set must be (x_val [Ne, F], y_val [Ne])")
        if self._multirank():
            check(edges is not None,
                  "multi-process fit requires shared edges= (per-host "
                  "quantiles would bin the same value differently)")
            self._sync_row_count(x.shape[0], trim=False)
        # one copy of the float matrix feeds both the quantiles and the
        # binning on the learner's device
        xt = torch.as_tensor(x, device=self.device)
        if edges is not None:
            self.edges = np.asarray(edges, dtype=np.float32)
            self._check_edges(x.shape[1])
        else:
            self.edges = fit_bins(xt, p.num_bins)
        eval_xb = eval_y = None
        if eval_set is not None:
            eval_xb = apply_bins(torch.as_tensor(xe, device=self.device),
                                 self.edges)
            eval_y = ye
        return self._fit_binned(apply_bins(xt, self.edges), y, log_every,
                                weight, eval_xb, eval_y)

    def fit_uri(
        self,
        uri: str,
        num_features: int,
        part_index: int = 0,
        num_parts: int = 1,
        sample_rows: int = 1 << 16,
        log_every: int = 0,
        drop_remainder: bool = False,
        edges: Optional[np.ndarray] = None,
        nthread: Optional[int] = None,
    ):
        """Train from a parser uri without materializing the dense float
        matrix: pass 1 streams blocks through a reservoir sample
        (Algorithm R, ``sample_rows`` rows; ≥ N keeps every row and gives
        ``fit``'s edges) to fit the edges; pass 2 re-streams and bins each
        block on the host into the compact binned matrix (uint8/uint16).
        The parser is ``create_parser``'s route (the native pipeline for
        local files; the Python stack tokenizes on the learner's device).

        ``part_index``/``num_parts`` pick this rank's InputSplit part. With
        a group, every rank must pass the same ``edges`` (which also skips
        pass 1), and ``drop_remainder=True`` trims every rank to the
        group's least row count (the default raises on unequal counts).
        """
        from dmlc_tpu_torch.data.parsers import create_parser

        p = self.param
        check(num_features > 0, "fit_uri requires num_features")
        if self._multirank():
            check(edges is not None,
                  "multi-process fit_uri requires shared edges= (per-host "
                  "sketches would bin the same value differently)")
        parser = create_parser(uri, part_index, num_parts, nthread=nthread,
                               device=self.device)
        try:
            if edges is not None:
                self.edges = np.asarray(edges, dtype=np.float32)
                self._check_edges(num_features)
            else:
                # pass 1: reservoir sample for edges
                rng = np.random.RandomState(p.num_bins * 7919 + 13)
                reservoir = np.empty((sample_rows, num_features),
                                     dtype=np.float32)
                seen = 0
                for block in parser:
                    dense = block.to_dense(num_features)
                    n = len(dense)
                    gidx = np.arange(seen, seen + n)
                    take_direct = gidx < sample_rows
                    reservoir[gidx[take_direct]] = dense[take_direct]
                    rest = ~take_direct
                    if rest.any():
                        draws = (rng.random_sample(int(rest.sum()))
                                 * (gidx[rest] + 1)).astype(np.int64)
                        hit = draws < sample_rows
                        reservoir[draws[hit]] = dense[rest][hit]
                    seen += n
                check(seen > 0, "uri produced no rows: %s", uri)
                self.edges = fit_bins(reservoir[:min(seen, sample_rows)],
                                      p.num_bins)
            # pass 2: stream + bin on the host
            parser.before_first()
            xb_parts, y_parts, w_parts = [], [], []
            any_weight = False
            for block in parser:
                # no DeviceFeed here: the binning slice ends each
                # pipelined chunk's flow
                fid = getattr(block, "flow_id", 0)
                with obs.span("bin_block", rows=len(block), flow=fid):
                    obs.flow_end(fid, "chunk")
                    xb_parts.append(_apply_bins_np(
                        block.to_dense(num_features), self.edges,
                        p.num_bins))
                y_parts.append(np.asarray(block.label, dtype=np.float32))
                # libsvm label:weight rows carry instance weights
                if block.weight is not None:
                    any_weight = True
                    w_parts.append(np.asarray(block.weight, np.float32))
                else:
                    w_parts.append(np.ones(len(block), dtype=np.float32))
        finally:
            parser.close()
        check(xb_parts, "uri produced no rows: %s (part %d/%d)",
              uri, part_index, num_parts)
        xb = np.concatenate(xb_parts)
        y = np.concatenate(y_parts)
        if self._multirank():
            # weighted-ness must agree across the group: any rank's
            # weights make the fit weighted
            any_weight = bool(self._get_engine().allreduce(
                np.array([int(any_weight)]), op="max")[0])
        weight = np.concatenate(w_parts) if any_weight else None
        if drop_remainder and self.group is not None:
            n = self._sync_row_count(xb.shape[0], trim=True)
            xb, y = xb[:n], y[:n]
            if weight is not None:
                weight = weight[:n]
        else:
            self._sync_row_count(xb.shape[0], trim=False)
        return self._fit_binned(xb, y, log_every, weight)

    def _fit_binned(self, xb, y: np.ndarray, log_every: int,
                    weight: Optional[np.ndarray] = None,
                    eval_xb=None, eval_y=None):
        from dmlc_tpu_torch.models.fitloop import FitLoopObs

        p = self.param
        # one fit = one FitLoopObs "epoch" whose trees are the steps: the
        # same metrics, goodput window and watchdog pass as the
        # feed-driven learners
        fl = FitLoopObs("gbdt")
        t_fit = time.monotonic_ns()
        if p.objective == "softmax":
            # out-of-range ids would one-hot to nonsense: clean errors here
            check(p.num_class >= 2,
                  "objective=softmax requires num_class >= 2")
            for arr, what in ((y, "softmax labels"),
                              (eval_y, "softmax eval labels")):
                if arr is None:
                    continue
                a = np.asarray(arr)
                check(len(a) == 0 or (
                    float(a.min()) >= 0 and float(a.max()) < p.num_class),
                    "%s must be class ids in [0, %d)", what, p.num_class)
        if isinstance(xb, np.ndarray):
            # torch has few uint16 ops: such ids widen to int32
            xb = torch.as_tensor(
                xb.astype(np.int32) if xb.dtype == np.uint16 else xb,
                device=self.device)
        weighted = weight is not None
        with_eval = eval_xb is not None
        args = [xb, torch.as_tensor(y, device=self.device)]
        if weighted:
            args.append(torch.as_tensor(weight, device=self.device))
        if with_eval:
            args += [eval_xb, torch.as_tensor(eval_y, device=self.device)]
        forest = make_forest_builder(
            p.num_trees, p.max_depth, p.num_bins, p.reg_lambda,
            p.min_child_weight, p.learning_rate, p.objective, self.group,
            weighted=weighted, num_class=p.num_class, with_eval=with_eval,
            subsample=p.subsample, colsample=p.colsample_bytree,
            seed=p.seed, log_every=log_every)
        with obs.span("fit", model="gbdt", trees=p.num_trees):
            out = forest(*args)
        self.eval_history = None
        self.best_iteration = None
        if with_eval:
            self.trees, losses, vlosses = out
            self._set_eval_history(vlosses.cpu().numpy())
        else:
            self.trees, losses = out
        history = [float(v) for v in losses.cpu().numpy()]
        fl.note_step(len(history))
        fl.end_epoch(0, len(history), t_fit,
                     history[-1] if history else None)
        return history

    # ---- predict -------------------------------------------------------
    def predict_margin(self, x: np.ndarray) -> np.ndarray:
        check(self.trees is not None, "model not fitted")
        xb = apply_bins(torch.as_tensor(np.asarray(x, dtype=np.float32),
                                        device=self.device), self.edges)
        margin = self.param.learning_rate * predict_trees(
            self.trees, xb, self.param.max_depth)
        return margin.cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Probabilities under logistic ([N]) and softmax ([N, K],
        multi:softprob; argmax for class ids), the raw margin under
        squared."""
        margin = torch.as_tensor(self.predict_margin(x))
        if self.param.objective == "logistic":
            return torch.sigmoid(margin).numpy()
        if self.param.objective == "softmax":
            return torch.softmax(margin, dim=-1).numpy()
        return margin.numpy()

    # ---- checkpointing through the Stream surface -----------------------
    def save(self, uri: str) -> None:
        """The reference's payload (param dict, edges, feature, bin, leaf,
        gain) through the serializer: either package loads the other's
        file."""
        check(self.trees is not None, "model not fitted")
        with create_stream(uri, "w") as out:
            payload = {
                "param": self.param.to_dict(),
                "edges": np.asarray(self.edges),
                "feature": self.trees["feature"].cpu().numpy(),
                "bin": self.trees["bin"].cpu().numpy(),
                "leaf": self.trees["leaf"].cpu().numpy(),
            }
            if "gain" in self.trees:  # a pre-gain checkpoint stays savable
                payload["gain"] = self.trees["gain"].cpu().numpy()
            save_obj(out, payload)

    def load(self, uri: str) -> None:
        with create_stream(uri, "r") as stream:
            payload = load_obj(stream)
        self.param.init(payload["param"], allow_unknown=True)
        self.edges = payload["edges"]
        self.trees = {k: torch.as_tensor(payload[k], device=self.device)
                      for k in ("feature", "bin", "leaf", "gain")
                      if k in payload}

    def _set_eval_history(self, vlosses: np.ndarray) -> None:
        self.eval_history = [float(v) for v in vlosses]
        self.best_iteration = int(np.argmin(vlosses))

    def truncate(self, num_trees: int) -> None:
        """Cut the forest back to its first ``num_trees`` trees, the
        early-stopping companion to ``best_iteration``::

            learner.fit(x, y, eval_set=(xv, yv))
            learner.truncate(learner.best_iteration + 1)
        """
        check(self.trees is not None, "model not fitted")
        total = self.trees["feature"].shape[0]
        check(1 <= num_trees <= total,
              "num_trees must be in [1, %d]", total)
        self.trees = {k: v[:num_trees] for k, v in self.trees.items()}

    def feature_importance(self, kind: str = "gain") -> np.ndarray:
        """Per-feature importance [F], xgboost get_score semantics:
        ``gain`` sums each feature's realized split gains over the forest;
        ``split`` counts its splits."""
        check(self.trees is not None, "model not fitted")
        check(kind in ("gain", "split"), "kind must be gain or split")
        feats = self.trees["feature"].cpu().numpy().ravel()
        if kind == "split":
            vals = np.ones_like(feats, dtype=np.float32)
        else:
            check("gain" in self.trees,
                  "checkpoint predates gain recording — refit for "
                  "gain importance (split importance still works)")
            vals = self.trees["gain"].cpu().numpy().ravel()
        mask = feats >= 0
        out = np.zeros(self.edges.shape[0], dtype=np.float32)
        np.add.at(out, feats[mask], vals[mask])
        return out

"""The GBDT fit job: ``GBDTLearner.fit(x, y)`` on the seeded HIGGS rows,
fits back to back until the window ends. Each fit does the quantile
edges, the binning and every tree, as a user's fit does.

Set-up makes the rows on the device from the seed and keeps them as the
numpy arrays ``fit`` takes; a one-tree fit at the same shapes warms every
shape. The window's last fit is the answer judged: once the window has
closed (and, with ``trace``, a traced fit and the per-layer readers have
run), the program's state is freed and the reference works out the edges,
the bins and the first three trees from the same rows, and reads the
program's edges, losses and trees against them.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.gen import higgs
from perfbench.lib import devtime, stats
from perfbench.reference import compare
from perfbench.reference import gbdt as reference

FIRST_TREES = 3
PARAM_KEYS = ("max_depth", "num_bins", "learning_rate", "reg_lambda",
              "min_child_weight")


def learner_args(config: dict) -> dict:
    args = {k: config[k] for k in PARAM_KEYS}
    args.update(objective=config["objective"], num_trees=config["num_trees"])
    return args


def gbdt_checks(edges, history, trees, ref: dict, ref_edges, bins,
                config: dict) -> dict:
    """The numbers compared: edges that differ in bits from the
    reference's; the largest relative gap of the loss before trees 1 to
    3 (entry 0 is the base margin's); the gap of the norms of the first
    tree's leaves; the gap of the norms of the margins that the first
    three trees give each row; and the norm of those margins' difference
    (each row's answer), each over the reference's norm."""
    got_edges = np.ascontiguousarray(edges, np.float32).view(np.uint32)
    want_edges = np.ascontiguousarray(ref_edges, np.float32).view(np.uint32)
    margin = reference.forest_margin(bins, trees, FIRST_TREES,
                                     config["max_depth"],
                                     config["learning_rate"])
    ref_margin = ref["margin"].double()
    return {
        "edges_mismatch": int(np.sum(got_edges != want_edges))
        if got_edges.shape == want_edges.shape else int(want_edges.size),
        "loss_gap": compare.loss_gap(history[1:FIRST_TREES + 1],
                                     ref["loss"][1:FIRST_TREES + 1]),
        "leaf_gap": compare.norm_gap({"leaf": trees["leaf"][0]},
                                     {"leaf": ref["leaf"][0]}, ["leaf"]),
        "margin_gap": abs(float(torch.linalg.norm(margin))
                          - float(torch.linalg.norm(ref_margin)))
        / float(torch.linalg.norm(ref_margin)),
        "margin_diff": float(torch.linalg.norm(margin - ref_margin))
        / float(torch.linalg.norm(ref_margin)),
    }


def reference_checks(x: np.ndarray, y: np.ndarray, edges, history, trees,
                     config: dict, device, dtype=torch.float32) -> dict:
    """The reference's edges, bins and first trees from the rows, in
    ``dtype``, and :func:`gbdt_checks` of the program's answer."""
    xt = torch.as_tensor(x, device=device)
    ref_edges = reference.quantile_edges(xt, config["num_bins"])
    bins = reference.bin_rows(xt, ref_edges)
    del xt
    ref = reference.boost(bins, torch.as_tensor(y, device=device),
                          FIRST_TREES, config, dtype=dtype)
    return gbdt_checks(edges, history, trees, ref, ref_edges, bins, config)


def run(ctx) -> dict:
    from dmlc_tpu_torch.models import GBDTLearner

    cfg, dev = ctx.config, ctx.device
    n, nf, trees = cfg["rows"], cfg["features"], cfg["num_trees"]
    xd, yd = higgs.higgs_rows(n, nf, ctx.seed, dev, cfg["data_seed"])
    x, y = xd.cpu().numpy(), yd.cpu().numpy()
    del xd, yd
    args = learner_args(cfg)
    learner = GBDTLearner(device=dev, **args)
    GBDTLearner(device=dev, **dict(args, num_trees=1)).fit(x, y)
    devtime.sync(dev)

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    fits = 0
    while True:
        history = learner.fit(x, y)
        fits += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    devtime.sync(dev)
    window_s = time.perf_counter() - t0
    peak = devtime.peak_bytes(dev)
    edges = np.array(learner.edges, copy=True)
    forest = {k: v.cpu().numpy() for k, v in learner.trees.items()}

    layer, trace = {}, None
    if ctx.trace:
        trace = devtime.traced(lambda: learner.fit(x, y), dev)
        trace["fits"] = 1
        layer = ctx.read_layer({
            "device": dev, "window_s": window_s, "trace": trace,
            "fits": fits, "rows": n, "features": nf, "trees": trees,
            "max_depth": cfg["max_depth"], "num_bins": cfg["num_bins"],
            "x": x, "y": y, "edges": edges, "forest": forest})
    del learner
    gc.collect()
    devtime.release(dev)

    checks = reference_checks(x, y, edges, history, forest, cfg, dev)
    return {
        "end_to_end": {"row_trees_per_s": stats.rate(fits * n * trees,
                                                     window_s),
                       "setup_s": setup_s},
        "per_layer": layer, "trace": trace, "checks": checks,
        "attempted": fits, "failed": 0, "memory_peak_bytes": peak,
    }


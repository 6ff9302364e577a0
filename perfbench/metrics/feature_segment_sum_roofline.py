"""feature_segment_sum_roofline: ``ops/spmv.feature_segment_sum`` (FM's
factor gradient, g[f] = sum of contrib[e] over the entries e of feature
f) at the cell's [E, K], timed alone with CUDA events and a cold L2 on
the ids of the cell's batches, against its least time (:func:`work`),
in %."""

from __future__ import annotations

import torch

from perfbench.lib import devtime, peaks


def work(entries: int, k: int, features: int) -> tuple:
    """(flops, bytes): one add an entry and column; each entry's K values
    and its id read once, the [features, K] float32 output written
    once."""
    return entries * k, 4 * (entries * k + entries + features * k)


def read(r: dict):
    try:
        from dmlc_tpu_torch.ops.spmv import feature_segment_sum
    except ImportError:
        return None
    batches, dev = r.get("batches") or [], r["device"]
    if not batches:
        return None
    k, nf = r["num_factors"], r["num_features"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(r["seed"]) % (1 << 63))
    args = [(torch.randn((b["indices"].shape[0], k), generator=gen,
                         device=dev), b["indices"], nf) for b in batches]
    ms = devtime.time_alone(feature_segment_sum, args, dev,
                            iters=3 * len(args))
    works = [work(int(b["num_nonzero"]), k, nf) for b in batches]
    flops = sum(w[0] for w in works) / len(works)
    nbytes = sum(w[1] for w in works) / len(works)
    return peaks.share(flops, nbytes, ms * 1e-3)

"""binning_ms.gbdt: milliseconds of the GBDT fit's binning at the cell's
rows, on the device: ``fit_bins`` (the quantile edges) and ``apply_bins``
on the float rows already on the card, bracketed by CUDA events (the
edges' host interpolation included), the median of three."""

from __future__ import annotations

import torch

from perfbench.lib import devtime


def read(r: dict):
    try:
        from dmlc_tpu_torch.models.gbdt import apply_bins, fit_bins
    except ImportError:
        return None
    dev = r["device"]
    xt = torch.as_tensor(r["x"], device=dev)
    return devtime.time_alone(
        lambda: apply_bins(xt, fit_bins(xt, r["num_bins"])), [()], dev,
        iters=3)

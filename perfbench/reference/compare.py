"""The comparisons that decide ``correct``: plain numpy, on what the
program produced and what the reference worked out."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's moves by round-off alone, and is left out of the change
STILL_LEAF = 1e-3


def _norm(a) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    """The largest |got - want| / |want| over the steps."""
    return max(abs(float(g) - float(w)) / abs(float(w))
               for g, w in zip(got, want))


def norm_gap(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
             leaves: Sequence[str]) -> float:
    """By the worst leaf: |‖got‖ - ‖want‖| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    norms = {k: _norm(want[k]) for k in leaves}
    median = float(np.median([norms[k] for k in leaves]))
    return max(abs(_norm(got[k]) - norms[k]) / max(norms[k], median)
               for k in leaves)


def moving_leaves(ref_grad: Dict[str, np.ndarray]) -> list:
    """The leaves whose reference gradient norm is at least
    :data:`STILL_LEAF` of the median leaf's."""
    norms = {k: _norm(v) for k, v in ref_grad.items()}
    median = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= STILL_LEAF * median]


def sgd_checks(got_loss, got_params, ref: dict, lr: float) -> dict:
    """The three numbers of a training cell's first three steps.

    ``got_params``: [start, after step 1, ..., after step 3] dicts of
    numpy, the program's; ``ref``: :func:`reference.fm.sgd_steps`' output.
    ``grad_gap`` reads the first gradient as the optimizer got it,
    (start - after step 1) / lr; ``change_gap`` the change after three
    steps, over the leaves that :func:`moving_leaves` keeps."""
    p0 = ref["params"][0]
    leaves = list(p0)
    grad = {k: (p0[k] - np.asarray(got_params[1][k], np.float64)) / lr
            for k in leaves}
    ref_grad = {k: (p0[k] - ref["params"][1][k]) / lr for k in leaves}
    last = len(ref["params"]) - 1
    change = {k: np.asarray(got_params[last][k], np.float64) - p0[k]
              for k in leaves}
    ref_change = {k: ref["params"][last][k] - p0[k] for k in leaves}
    return {
        "loss_gap": loss_gap(got_loss, ref["loss"]),
        "grad_gap": norm_gap(grad, ref_grad, leaves),
        "change_gap": norm_gap(change, ref_change, moving_leaves(ref_grad)),
    }

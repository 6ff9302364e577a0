"""Plain factorization machine SGD, the yardstick of the FM cells.

score(x) = b + sum_i w_i x_i
           + 1/2 sum_k [(sum_i v_ik x_i)^2 - sum_i v_ik^2 x_i^2]

Logistic loss on labels 0/1, averaged over the batch's rows; one SGD step
a batch, p <- p - lr * (grad + l2 * p) for w and v and p <- p - lr * grad
for b. The gradient comes from autograd over the plain forward. Rows come
from the benchmark's generator as dense [B, fields] ids and values; the
parameters start from the values the benchmark drew. Imports nothing of
the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

LEAVES = ("w", "b", "v")


def sgd_steps(labels: np.ndarray, ids: np.ndarray, values: np.ndarray,
              start: Dict[str, np.ndarray], batch: int, steps: int,
              lr: float, l2: float, device, dtype=torch.float32) -> dict:
    """``steps`` SGD steps over consecutive batches of ``batch`` rows from
    row 0, in ``dtype``. Returns {"loss": [steps] mean loss of each batch
    before its update, "params": [steps + 1] dicts of float64 numpy
    params, the start first}."""
    p = {k: torch.tensor(np.asarray(start[k]), dtype=dtype, device=device)
         for k in LEAVES}
    out_params: List[dict] = [{k: np.asarray(start[k], np.float64)
                               for k in LEAVES}]
    losses = []
    for s in range(steps):
        rows = slice(s * batch, (s + 1) * batch)
        idx = torch.as_tensor(ids[rows].astype(np.int64), device=device)
        x = torch.as_tensor(values[rows], device=device).to(dtype)
        y = torch.as_tensor(labels[rows], device=device).to(dtype)
        leaf = {k: p[k].clone().requires_grad_(True) for k in LEAVES}
        vx = leaf["v"][idx] * x[..., None]  # [B, fields, K]
        sums = vx.sum(dim=1)
        squares = (vx * vx).sum(dim=1)
        margin = (leaf["b"] + (leaf["w"][idx] * x).sum(dim=1)
                  + 0.5 * (sums * sums - squares).sum(dim=-1))
        loss = F.binary_cross_entropy_with_logits(margin, y)
        loss.backward()
        with torch.no_grad():
            for k in LEAVES:
                decay = 0.0 if k == "b" else l2
                p[k] = p[k] - lr * (leaf[k].grad + decay * p[k])
        losses.append(float(loss.detach().float()))
        out_params.append({k: p[k].detach().double().cpu().numpy()
                           for k in LEAVES})
    return {"loss": losses, "params": out_params}

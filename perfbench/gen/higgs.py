"""Seeded HIGGS-shaped rows, made on the device in a few large calls.

x [N, F] float32 standard normal features; labels 0/1 from a noisy linear
rule, y = (x . w + e > 0) with w and e standard normal, so that boosting
has something to learn. The rows are drawn from ``data_seed`` and put in
an order drawn from ``seed`` (each taken modulo 2**63, by a
``torch.Generator`` on ``device``): every seed gets the same rows, so the
trees and the work of a fit are the same, in another order, and the same
seed on the same device gives the same rows in the same order.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def higgs_rows(rows: int, features: int, seed: int, device,
               data_seed: int = 0):
    """(x [rows, features] float32, y [rows] float32) on ``device``: the
    rows of ``data_seed`` in the order of ``seed``."""
    gen = generator(data_seed, device)
    x = torch.randn((rows, features), generator=gen, device=device)
    w = torch.randn(features, generator=gen, device=device,
                    dtype=torch.float64)
    noise = torch.randn(rows, generator=gen, device=device,
                        dtype=torch.float64)
    # float64 products: the labels do not depend on a matmul's precision
    y = ((x.double() @ w + noise) > 0).float()
    order = torch.randperm(rows, generator=generator(seed, device),
                           device=device)
    return x[order], y[order]

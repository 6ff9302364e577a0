"""Faults planted in the timed path, underneath a run: each takes a
``pytest.MonkeyPatch`` and breaks one thing of the program for as long as
the patch holds. A run with any of them has to come out not correct;
``perfbench/tests/test_perfbench_correct.py`` holds them to that on the
CPU, and ``perfbench/calibrate.py`` reads their numbers at a cell's size
on the card.
"""

from __future__ import annotations

import torch


def fm_unchanged(monkeypatch):
    """The FM step returns its parameters unchanged."""
    from dmlc_tpu_torch.models import fm

    real = fm.make_fm_train_step

    def broken(*args, **kwargs):
        step = real(*args, **dict(kwargs, donate_batch=False))

        def same(params, batch):
            return params, step(params, batch)[1]
        return same

    monkeypatch.setattr(fm, "make_fm_train_step", broken)


def fm_half(monkeypatch):
    """Half of each batch left out of the FM step, the mean taken over
    the rest."""
    from dmlc_tpu_torch.models import fm

    real = fm._fm_forward_grads

    def half(params, batch, objective, num_features):
        weight = batch["weight"].clone()
        weight[weight.shape[0] // 2:] = 0.0
        return real(params, dict(batch, weight=weight), objective,
                    num_features)

    monkeypatch.setattr(fm, "_fm_forward_grads", half)


def fm_altered(monkeypatch):
    """A value altered as the feed puts each batch on the device."""
    from dmlc_tpu_torch.device.feed import DeviceFeed

    real = DeviceFeed._put

    def put(self, arrays):
        out = real(self, arrays)
        out["values"] = out["values"].clone()
        out["values"][0] += 0.5
        return out

    monkeypatch.setattr(DeviceFeed, "_put", put)


def fm_batch_skipped(monkeypatch):
    """The first batch of every epoch after the first left out by the
    feed: the first steps, which are compared in bits, pass, and the
    window's first batch is already the wrong one."""
    from dmlc_tpu_torch.device.feed import DeviceFeed

    real = DeviceFeed.__iter__
    epochs = []

    def skipping(self):
        first = not epochs
        epochs.append(self)
        for i, batch in enumerate(real(self)):
            if i or first:
                yield batch

    monkeypatch.setattr(DeviceFeed, "__iter__", skipping)


def gbdt_unchanged(monkeypatch):
    """Each tree leaves the margin unchanged."""
    from dmlc_tpu_torch.models import gbdt

    monkeypatch.setattr(gbdt, "_margin_update_core",
                        lambda margin, leaf, node, lr: margin)


def gbdt_half(monkeypatch):
    """Half of the rows left out of the gradients, the loss taken over
    the rest."""
    from dmlc_tpu_torch.models import gbdt

    real = gbdt._grad_loss_core

    def half(objective, margin, y, w, group):
        g, h, _ = real(objective, margin, y, w, group)
        keep = torch.ones_like(g)
        keep[g.shape[0] // 2:] = 0.0
        rest = g.shape[0] // 2
        loss = torch.mean(gbdt._loss(objective, margin[:rest], y[:rest]))
        return g * keep, h * keep, loss

    monkeypatch.setattr(gbdt, "_grad_loss_core", half)


def gbdt_altered(monkeypatch):
    """Each tree's root split moved by one bin where it is built."""
    from dmlc_tpu_torch.models import gbdt

    real = gbdt._build_tree_core

    def altered(*args, **kwargs):
        feature, split, gain, leaf, node = real(*args, **kwargs)
        split = split.clone()
        split[0] += 1
        return feature, split, gain, leaf, node

    monkeypatch.setattr(gbdt, "_build_tree_core", altered)


#: the faults each job's cells can have
BY_JOB = {
    "fm_fit": (fm_unchanged, fm_half, fm_altered, fm_batch_skipped),
    "gbdt_fit": (gbdt_unchanged, gbdt_half, gbdt_altered),
}

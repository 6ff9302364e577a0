"""The FM fit job: ``FMLearner.fit_feed`` over ``DeviceFeed(create_parser(
uri))``, one epoch a call, epochs back to back until the window ends.

Set-up writes the seeded Criteo rows as libfm text (for the ``recordio``
traffic: as libsvm text, since row groups carry no fields, converted with
``convert_to_recordio``, the text then dropped), hands the learner the
seed's initial parameters, and drives it through its first three steps,
one pass of one batch each, keeping the parameters after each and the
three batches as the feed delivered them. Every batch has the shape of
those three (each row has one entry a field, and the rows are whole
batches), so they warm every shape; the epoch is rewound and the same
learner and feed run the window, which sums a digest of each epoch's
batches on the device. Once it has closed (and, with ``trace``, a traced
epoch and the per-layer readers have run), the program's state is freed,
the reference follows the first three steps from the same rows and
start, and each window epoch's digest is compared with the same digest of
the rows it should have carried.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from perfbench.gen import criteo
from perfbench.lib import devtime, stats
from perfbench.lib.stepclock import StepClock
from perfbench.reference import compare
from perfbench.reference import fm as reference

FIRST_STEPS = 3
#: batches the job keeps as the feed delivered them: the first steps'
#: (compared in bits) and the roofline readers' inputs
KEPT_BATCHES = 8
#: entry e of a batch weighs (e mod DIGEST_SPAN) + 1 in the digest
DIGEST_SPAN = 8192
DIGEST_NAMES = ("label_bits", "weight_bits", "offsets", "ids",
                "ids_by_entry", "ids_by_batch", "value_bits")


def make_rows(config: dict, seed: int):
    """The configuration's seeded rows (``perfbench/gen/criteo.py``)."""
    return criteo.criteo_rows(config["rows"], seed, config["field_values"],
                              config["num_ids"], config["published_rows"],
                              config["rare_below"],
                              config["positive_share"])


def start_params(config: dict, seed: int, device) -> dict:
    """The initial parameters, drawn on the device from the seed: w and b
    zero, v init_scale * N(0, 1) [num_features, K]; as float32 numpy."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    nf, k = config["num_ids"] + 1, config["num_factors"]
    v = config["init_scale"] * torch.randn((nf, k), generator=gen,
                                           device=device)
    return {"w": np.zeros(nf, np.float32), "b": np.zeros((), np.float32),
            "v": v.cpu().numpy()}


def write_data(config: dict, traffic: dict, rows, data_dir: str,
               device) -> tuple:
    """(uri, format) of the cell's input, written under ``data_dir``."""
    from dmlc_tpu_torch.data import convert_to_recordio

    if traffic["format"] == "libfm":
        text = os.path.join(data_dir, "criteo.libfm")
        criteo.write_text(text, rows)
        return text, "libfm"
    # row-group records carry no fields: convert from the libsvm text
    text = os.path.join(data_dir, "criteo.libsvm")
    criteo.write_text(text, rows, fields_in_text=False)
    rec = os.path.join(data_dir, "criteo.rec")
    convert_to_recordio(text, rec, data_format="libsvm",
                        rows_per_group=traffic["rows_per_group"],
                        device=device)
    os.remove(text)
    return rec, "recordio"


def host_batch(batch: dict) -> dict:
    n, nnz = int(batch["num_rows"]), int(batch["num_nonzero"])
    return {"label": batch["label"][:n].cpu().numpy(),
            "weight": batch["weight"][:n].cpu().numpy(),
            "offsets": batch["offsets"][:n + 1].cpu().numpy(),
            "indices": batch["indices"][:nnz].cpu().numpy(),
            "values": batch["values"][:nnz].cpu().numpy()}


def rows_mismatch(got: list, rows, batch: int) -> int:
    """Values of the first batches, as the feed delivered them, that
    differ from the generator's rows (labels, weights, row lengths, ids
    and values, in bits); a batch of the wrong size counts all its
    rows."""
    bad = 0
    fields = rows.ids.shape[1]
    for i, b in enumerate(got):
        lo, hi = i * batch, (i + 1) * batch
        if len(b["label"]) != hi - lo or \
                len(b["indices"]) != (hi - lo) * fields:
            bad += hi - lo
            continue
        bad += int(np.sum(b["label"] != rows.labels[lo:hi]))
        bad += int(np.sum(b["weight"] != 1.0))
        bad += int(np.sum(np.diff(b["offsets"]) != fields))
        bad += int(np.sum(b["indices"] != rows.ids[lo:hi].ravel()))
        bad += int(np.sum(b["values"].view(np.uint32)
                          != rows.values[lo:hi].ravel().view(np.uint32)))
    return bad


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int32).long()


def batch_digest(batch: dict, position: int) -> torch.Tensor:
    """int64 [7] on the batch's device, with no synchronize (the sums of
    :data:`DIGEST_NAMES`): the bits of the labels, of the weights and of
    the values, the offsets from the batch's first, the ids, the ids with
    entry e weighed (e mod DIGEST_SPAN) + 1, and the ids weighed by the
    batch's place in its epoch (``position`` + 1). Each stays far below
    2**63 over an epoch of the configuration's rows."""
    n, nnz = int(batch["num_rows"]), int(batch["num_nonzero"])
    ids = batch["indices"][:nnz].long()
    offsets = batch["offsets"][:n + 1].long()
    spot = torch.arange(nnz, device=ids.device) % DIGEST_SPAN + 1
    id_sum = ids.sum()
    return torch.stack([
        _bits(batch["label"][:n]).sum(), _bits(batch["weight"][:n]).sum(),
        (offsets - offsets[0]).sum(), id_sum, (ids * spot).sum(),
        id_sum * (position + 1), _bits(batch["values"][:nnz]).sum()])


def rows_digests(rows, batch: int) -> np.ndarray:
    """[batches, 7] int64: :func:`batch_digest` of each batch of the
    generator's rows, in order, as a sound feed delivers them."""
    fields = rows.ids.shape[1]
    one = int(np.float32(1.0).view(np.int32))
    out = []
    for p, lo in enumerate(range(0, rows.num_rows, batch)):
        hi = min(rows.num_rows, lo + batch)
        n = hi - lo
        ids = rows.ids[lo:hi].ravel().astype(np.int64)
        spot = np.arange(ids.size, dtype=np.int64) % DIGEST_SPAN + 1
        out.append([
            rows.labels[lo:hi].view(np.int32).astype(np.int64).sum(),
            n * one, fields * n * (n + 1) // 2, ids.sum(),
            (ids * spot).sum(), ids.sum() * (p + 1),
            rows.values[lo:hi].view(np.int32).astype(np.int64).sum()])
    return np.asarray(out, dtype=np.int64)


def epoch_mismatch(epochs: list, want: np.ndarray) -> int:
    """Window epochs that fail: one before the last that handed out other
    than every batch, or any whose digest differs from that of as many
    batches of the rows, from the first. ``epochs``: (batches, digest
    as int64 numpy or None) each."""
    bad = 0
    for i, (m, got) in enumerate(epochs):
        if m > len(want) or (i < len(epochs) - 1 and m != len(want)):
            bad += 1
            continue
        got = np.zeros(want.shape[1], np.int64) if got is None else got
        bad += int(not np.array_equal(got, want[:m].sum(axis=0)))
    return bad


def run(ctx) -> dict:
    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import FMLearner, fm_params_to_numpy

    cfg, traffic, dev = ctx.config, ctx.cell["traffic"], ctx.device
    batch = cfg["batch_size"]
    nf = cfg["num_ids"] + 1
    rows = make_rows(cfg, ctx.seed)
    uri, fmt = write_data(cfg, traffic, rows, ctx.data_dir, dev)
    start = start_params(cfg, ctx.seed, dev)
    learner = FMLearner(device=dev, objective=cfg["objective"],
                        num_features=nf, num_factors=cfg["num_factors"],
                        learning_rate=cfg["learning_rate"], l2=cfg["l2"],
                        init_scale=cfg["init_scale"])
    learner.restore_snapshot_model({"params": start})
    parser = create_parser(uri, data_format=fmt,
                           nthread=traffic["parse_threads"], device=dev)
    feed = DeviceFeed(parser, BatchSpec(batch_size=batch, layout="csr",
                                        num_features=nf), device=dev)
    clock = StepClock(feed, digest=batch_digest)
    clock.keep = KEPT_BATCHES
    # the first steps, one pass of one batch each, through the window's
    # own call and feed
    got_loss, got_params = [], [start]
    clock.budget = 1
    for _ in range(FIRST_STEPS):
        got_loss.append(learner.fit_feed(clock, epochs=1)[0])
        got_params.append(fm_params_to_numpy(learner.params))
    first_batches = [host_batch(b) for b in clock.batches[:FIRST_STEPS]]
    clock.budget = None
    clock.close_epoch()
    devtime.sync(dev)

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    clock.deadline = t0 + ctx.seconds
    clock.start()
    while True:
        learner.fit_feed(clock, epochs=1)
        if clock.cut:
            break
        clock.close_epoch()
    clock.stop()
    devtime.sync(dev)
    window_s = time.perf_counter() - t0
    step_ms = clock.step_ms()
    window_rows = clock.rows
    window_stats = list(clock.epoch_stats)
    epochs = [(m, None if d is None else d.cpu().numpy())
              for m, d in clock.epoch_digests]
    peak = devtime.peak_bytes(dev)

    layer, trace = {}, None
    if ctx.trace:
        clock.deadline = None
        clock.close_epoch()
        steps_before = clock.position
        trace = devtime.traced(lambda: learner.fit_feed(clock, epochs=1),
                               dev)
        trace["steps"] = clock.position - steps_before
        per_batch = criteo.batch_stats(rows, batch)
        layer = ctx.read_layer({
            "device": dev, "window_s": window_s, "trace": trace,
            "epoch_stats": window_stats,
            "parse_threads": traffic["parse_threads"],
            "batches": clock.batches, "num_features": nf,
            "num_factors": cfg["num_factors"], "seed": ctx.seed,
            "window_batches": [
                (min(batch, cfg["rows"] - p * batch),
                 int(per_batch[p, 0]), int(per_batch[p, 1]))
                for p in clock.window_positions]})
    feed.close()
    del learner, feed, parser, clock
    gc.collect()
    devtime.release(dev)

    ref = reference.sgd_steps(rows.labels, rows.ids, rows.values, start,
                              batch, FIRST_STEPS, cfg["learning_rate"],
                              cfg["l2"], dev)
    checks = compare.sgd_checks(got_loss, got_params, ref,
                                cfg["learning_rate"])
    checks["rows_mismatch"] = rows_mismatch(first_batches, rows, batch)
    checks["epoch_mismatch"] = epoch_mismatch(epochs,
                                              rows_digests(rows, batch))
    return {
        "end_to_end": {"rows_per_s": stats.rate(window_rows, window_s),
                       "step_ms_p95": stats.p95(step_ms),
                       "setup_s": setup_s},
        "per_layer": layer, "trace": trace, "checks": checks,
        "attempted": len(step_ms), "failed": 0,
        "memory_peak_bytes": peak,
    }


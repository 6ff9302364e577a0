"""coo_segment_sum_fm_roofline: ``coo_segment_sum`` (the row sums of
FM's packed [values*w | x*v | (x*v)^2] entries, [E, 2K + 1]) on the
cell's batches, timed alone with CUDA events and a cold L2, against its
least time (:func:`work`), in %."""

from __future__ import annotations

import torch

from perfbench.lib import devtime, peaks


def work(entries: int, columns: int, rows: int) -> tuple:
    """(flops, bytes): one add an entry and column; each entry's columns
    and its row id read once, the [rows, columns] float32 sums written
    once."""
    return entries * columns, 4 * (entries * columns + entries
                                   + rows * columns)


def row_ids(offsets: torch.Tensor, bucket: int) -> torch.Tensor:
    """[bucket] int32 row ids from CSR offsets, the padded tail on the
    last row."""
    rows = offsets.shape[0] - 1
    counts = (offsets[1:] - offsets[:-1]).long()
    ids = torch.repeat_interleave(
        torch.arange(rows, device=offsets.device), counts)
    out = torch.full((bucket,), rows - 1, dtype=torch.int32,
                     device=offsets.device)
    out[:ids.shape[0]] = ids.to(torch.int32)
    return out


def read(r: dict):
    try:
        from dmlc_tpu_torch.ops.kernels import coo_segment_sum
    except ImportError:
        return None
    batches, dev = r.get("batches") or [], r["device"]
    if not batches:
        return None
    cols = 2 * r["num_factors"] + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(r["seed"]) % (1 << 63))
    args = []
    for b in batches:
        bucket = b["indices"].shape[0]
        args.append((torch.randn((bucket, cols), generator=gen, device=dev),
                     row_ids(b["offsets"], bucket),
                     b["offsets"].shape[0] - 1))
    ms = devtime.time_alone(coo_segment_sum, args, dev, iters=3 * len(args))
    works = [work(int(b["num_nonzero"]), cols, b["offsets"].shape[0] - 1)
             for b in batches]
    flops = sum(w[0] for w in works) / len(works)
    nbytes = sum(w[1] for w in works) / len(works)
    return peaks.share(flops, nbytes, ms * 1e-3)

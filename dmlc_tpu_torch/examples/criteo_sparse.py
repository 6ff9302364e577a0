"""Criteo-class sparse training end to end, the counterpart of
``examples/criteo_sparse.py``: hashed ids in a 2^20 space, ~39 entries a
row, through the csr device path::

    python -m dmlc_tpu_torch.examples.criteo_sparse data.svm \\
        --num-features 1048577 [--device cpu]
    python -m dmlc_tpu_torch.examples.criteo_sparse --synthetic
    python -m dmlc_tpu_torch.examples.criteo_sparse data.rec --format recordio

1. parse: LibSVM text, its tokens found by the ``tokenize_boundaries``
   kernel on ``--device`` (the card unless ``--device cpu``), or
   row-group RecordIO (``python -m dmlc_tpu_torch.tools rowrec``);
2. ``DeviceFeed`` with a csr ``BatchSpec``: entries padded to
   ``--nnz-bucket``, rows shipped as CSR offsets, the host stage on the
   feed's producer thread;
3. ``make_linear_train_step(layout="csr")``: the SpMV's row sums in the
   ``coo_segment_sum`` kernel, the gradient scattered back per feature.

Each epoch prints its mean loss, steps, seconds and MB/s as the JAX
package's example does.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch


def _synthesize(path: str, rows: int = 20_000, dim: int = 1 << 20,
                nnz: int = 39) -> None:
    """The reference's seeded file, byte for byte (written to a temp name
    and renamed, so a cut run leaves no short file behind)."""
    rng = np.random.RandomState(7)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        for start in range(0, rows, 5000):
            n = min(5000, rows - start)
            labels = rng.randint(0, 2, size=n)
            ids = rng.randint(0, dim, size=(n, nnz))
            ids.sort(axis=1)
            vals = rng.rand(n, nnz)
            fh.write("\n".join(
                str(labels[i]) + " " + " ".join(
                    f"{ids[i, j]}:{vals[i, j]:.4f}" for j in range(nnz))
                for i in range(n)) + "\n")
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("uri", nargs="?", default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="generate a small criteo-shaped file and train on it")
    ap.add_argument("--format", default="auto",
                    choices=["auto", "libsvm", "recordio"])
    ap.add_argument("--num-features", type=int, default=(1 << 20) + 1)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--nnz-bucket", type=int, default=1 << 19)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.uri is None and not args.synthetic:
        ap.error("give a data URI or --synthetic")

    from dmlc_tpu_torch.data import create_parser
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models.linear import (EpochMetrics,
                                              init_linear_params,
                                              make_linear_train_step,
                                              step_batch)
    from dmlc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    uri = args.uri
    if args.synthetic:
        uri = os.path.join(tempfile.gettempdir(), "criteo_sparse_demo.svm")
        if not os.path.exists(uri):
            _synthesize(uri)
        print(f"synthetic criteo-shaped data at {uri}")

    spec = BatchSpec(batch_size=args.batch_size, layout="csr",
                     num_features=args.num_features,
                     nnz_bucket=args.nnz_bucket)
    step = make_linear_train_step(
        None, learning_rate=args.lr, layout="csr",
        num_features=args.num_features, donate_batch=True)
    params = init_linear_params(args.num_features, device=dev)
    velocity = {k: torch.zeros_like(v) for k, v in params.items()}

    size_mb = None
    if "://" not in (uri or "") and os.path.exists(uri):
        size_mb = os.path.getsize(uri) / (1 << 20)
    for epoch in range(args.epochs):
        feed = DeviceFeed(
            create_parser(uri, 0, 1, data_format=args.format, device=dev),
            spec, device=dev)
        acc = EpochMetrics()
        t0 = time.time()
        nstep = 0
        try:
            for batch in feed:
                params, velocity, metrics = step(
                    params, velocity, step_batch(batch, "csr"))
                acc.add(metrics)
                nstep += 1
            loss = acc.mean_loss()  # waits for the last step
        finally:
            feed.close()
        dt = time.time() - t0
        rate = f", {size_mb / dt:.0f} MB/s" if size_mb else ""
        print(f"epoch {epoch}: loss {loss:.6f} "
              f"({nstep} steps, {dt:.2f}s{rate})")
    nnz_w = int((params["w"] != 0).sum())
    print(f"done: {nnz_w} touched weights of {args.num_features}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

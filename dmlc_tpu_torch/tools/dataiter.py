"""RowBlockIter epoch-loop harness, the port of
``dmlc_tpu/tools/dataiter.py`` (``test/dataiter_test.cc``): iterate a
dataset for several epochs through a RowBlockIter (a ``#cachefile``
suffix takes the external-memory cache) and report each epoch's rows,
nnz and rows/s. The blocks go through the device feed: a csr
``DeviceFeed`` of ``--batch-size`` rows over the iterator, its producer
thread at the default depth, every batch copied to ``--device`` (the
card unless ``--device cpu``), where the Python stack's text is
tokenized too (a local source takes the native route).

Usage::

    python -m dmlc_tpu_torch.tools dataiter <uri> [part] [nparts] \\
        [--format auto|libsvm|libfm|csv] [--epochs N] [--batch-size B]
        [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from dmlc_tpu_torch.data import create_row_block_iter
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.utils.timer import get_time


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="dataiter", description=__doc__)
    ap.add_argument("uri")
    ap.add_argument("part", type=int, nargs="?", default=0)
    ap.add_argument("nparts", type=int, nargs="?", default=1)
    ap.add_argument("--format", default="auto",
                    choices=["auto", "libsvm", "libfm", "csv"])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="tokenizer and batch device (default: the card)")
    args = ap.parse_args(argv)

    it = create_row_block_iter(args.uri, args.part, args.nparts,
                               args.format, device=args.device)
    feed = DeviceFeed(it, BatchSpec(batch_size=args.batch_size,
                                    layout="csr"), device=args.device)
    base = None
    try:
        for epoch in range(max(1, args.epochs)):
            if epoch > 0:
                feed.before_first()
            rows = nnz = 0
            t0 = get_time()
            for batch in feed:
                rows += int(batch["num_rows"])
                nnz += int(batch["num_nonzero"])
            dt = max(get_time() - t0, 1e-9)
            print(f"epoch {epoch}: {rows} rows, {nnz} nnz, "
                  f"{rows / dt:.0f} rows/sec, num_col={it.num_col()}")
            if base is None:
                base = (rows, nnz)
            elif (rows, nnz) != base:
                print(f"ERROR: epoch {epoch} saw {(rows, nnz)}, "
                      f"epoch 0 saw {base}", file=sys.stderr)
                return 1
    finally:
        feed.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

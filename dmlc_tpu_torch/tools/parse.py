"""Parser throughput harness (libsvm / libfm / csv / recordio), the port
of ``dmlc_tpu/tools/parse.py`` (``test/libsvm_parser_test.cc``: bytes
parsed, examples, MB/s) through ``create_parser``'s route: the native
pipeline for a local or single-remote source, else the Python stack, whose
text is tokenized on ``--device`` (the card unless ``--device cpu``: each
non-empty chunk part launches ``tokenize_boundaries`` once). ``--procs N``
parses on the Python stack in a pool of N processes (``create_parser``'s
``procs``).

Usage::

    python -m dmlc_tpu_torch.tools parse <uri> [part] [nparts] \\
        [--format auto|libsvm|libfm|csv|recordio] [--nthread N]
        [--device cpu|cuda] [--procs N]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.utils.timer import get_time


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="parse", description=__doc__)
    ap.add_argument("uri")
    ap.add_argument("part", type=int, nargs="?", default=0)
    ap.add_argument("nparts", type=int, nargs="?", default=1)
    ap.add_argument("--format", default="auto",
                    choices=["auto", "libsvm", "libfm", "csv", "recordio"])
    ap.add_argument("--nthread", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="where the Python stack's text is tokenized "
                    "(default: the card)")
    ap.add_argument("--procs", type=int, default=0,
                    help="parse processes of the Python stack's pool "
                    "(0: none)")
    args = ap.parse_args(argv)

    parser = create_parser(args.uri, args.part, args.nparts, args.format,
                           nthread=args.nthread, device=args.device,
                           procs=args.procs)
    rows = nnz = 0
    t0 = get_time()
    try:
        for block in parser:
            rows += len(block)
            nnz += block.num_nonzero
        dt = max(get_time() - t0, 1e-9)
        nbytes = parser.bytes_read
        print(f"{nbytes} bytes parsed, {rows} examples, {nnz} nnz")
        print(f"{nbytes / (1 << 20) / dt:.2f} MB/sec, "
              f"{rows / dt:.0f} examples/sec")
    finally:
        parser.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

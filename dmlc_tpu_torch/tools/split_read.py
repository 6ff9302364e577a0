"""InputSplit record-read throughput harness, the port of
``dmlc_tpu/tools/split_read.py`` (``test/split_read_test.cc``: MB/s every
10 MB; ``split_repeat_read_test.cc``: ``--repeat`` re-reads the part and
checks a stable record count; ``split_test.cc``: ``--count-only``). It
reads bytes only, on the host.

Usage::

    python -m dmlc_tpu_torch.tools split_read <uri> <part> <nparts> \\
        [--type text|recordio|indexed_recordio] [--index-uri URI]
        [--repeat N] [--count-only]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from dmlc_tpu_torch.io import create_input_split
from dmlc_tpu_torch.utils.timer import get_time

_REPORT_EVERY = 10 << 20  # a line every 10 MB, as the reference prints


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="split_read", description=__doc__)
    ap.add_argument("uri")
    ap.add_argument("part", type=int)
    ap.add_argument("nparts", type=int)
    ap.add_argument("--type", default="text",
                    choices=["text", "recordio", "indexed_recordio"])
    ap.add_argument("--index-uri", default="")
    ap.add_argument("--repeat", type=int, default=1,
                    help="epochs (split_repeat_read_test)")
    ap.add_argument("--count-only", action="store_true")
    args = ap.parse_args(argv)

    split = create_input_split(args.uri, args.part, args.nparts, args.type,
                               index_uri=args.index_uri)
    base_count = None
    try:
        for epoch in range(max(1, args.repeat)):
            if epoch > 0:
                split.before_first()
            nrec = nbytes = 0
            next_report = _REPORT_EVERY
            t0 = get_time()
            while True:
                rec = split.next_record()
                if rec is None:
                    break
                nrec += 1
                nbytes += len(rec)
                if not args.count_only and nbytes >= next_report:
                    dt = max(get_time() - t0, 1e-9)
                    print(f"{nbytes / (1 << 20):.0f} MB read, "
                          f"{nbytes / (1 << 20) / dt:.2f} MB/sec")
                    next_report += _REPORT_EVERY
            dt = max(get_time() - t0, 1e-9)
            print(f"epoch {epoch}: {nrec} records, {nbytes} bytes, "
                  f"{nbytes / (1 << 20) / dt:.2f} MB/sec")
            if base_count is None:
                base_count = nrec
            elif nrec != base_count:
                print(f"ERROR: epoch {epoch} read {nrec} records, "
                      f"epoch 0 read {base_count}", file=sys.stderr)
                return 1
    finally:
        split.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

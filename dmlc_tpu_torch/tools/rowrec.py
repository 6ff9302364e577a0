"""Row-group conversion harness, the port of ``dmlc_tpu/tools/rowrec.py``:
convert any parseable local dataset into row-group RecordIO
(``data/rowrec.py``) and report the conversion's rows/s. The text is
parsed on ``--device`` (the card unless ``--device cpu``).

Usage::

    python -m dmlc_tpu_torch.tools rowrec convert <src> <dst> \\
        [--format auto|libsvm|libfm|csv|recordio] [--rows-per-group N]
        [--device cpu|cuda]

Read it back with ``create_parser(dst + "?format=recordio")``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from dmlc_tpu_torch.data.rowrec import convert_to_recordio
from dmlc_tpu_torch.utils.timer import get_time


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="rowrec", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    cv = sub.add_parser("convert", help="dataset -> row-group recordio")
    cv.add_argument("src")
    cv.add_argument("dst")
    cv.add_argument("--format", default="auto",
                    choices=["auto", "libsvm", "libfm", "csv", "recordio"])
    cv.add_argument("--rows-per-group", type=int, default=1024)
    cv.add_argument("--device", default=None,
                    help="where the text is tokenized (default: the card)")
    args = ap.parse_args(argv)

    t0 = get_time()
    rows = convert_to_recordio(args.src, args.dst, data_format=args.format,
                               rows_per_group=args.rows_per_group,
                               device=args.device)
    dt = max(get_time() - t0, 1e-9)
    print(f"converted {rows} rows in {dt:.2f}s "
          f"({rows / dt:.0f} rows/s) -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

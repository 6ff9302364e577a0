"""Stream read / write throughput harness, the port of
``dmlc_tpu/tools/stream_read.py`` (``test/stream_read_test.cc``: MB/s of
sequential reads; ``iostream_test.cc``: ``--rw`` writes seeded bytes
first and checks their sum read back). Any registered uri scheme; host
only.

Usage::

    python -m dmlc_tpu_torch.tools stream_read <uri> [--rw] [--size-mb N]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from dmlc_tpu_torch.io import create_stream, create_stream_for_read
from dmlc_tpu_torch.utils.timer import get_time

_CHUNK = 4 << 20


def _byte_sum(data: bytes, acc: int) -> int:
    """``acc`` plus the bytes' sum, mod 2^32 (the reference's checksum)."""
    total = int(np.frombuffer(data, dtype=np.uint8).sum(dtype=np.uint64))
    return (acc + total) & 0xFFFFFFFF


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="stream_read", description=__doc__)
    ap.add_argument("uri")
    ap.add_argument("--rw", action="store_true",
                    help="write --size-mb of data first, then verify it back")
    ap.add_argument("--size-mb", type=int, default=64)
    args = ap.parse_args(argv)

    checksum = None
    if args.rw:
        rng = np.random.RandomState(7)
        t0 = get_time()
        written = checksum = 0
        with create_stream(args.uri, "w") as stream:
            while written < args.size_mb << 20:
                data = rng.bytes(_CHUNK)
                stream.write(data)
                checksum = _byte_sum(data, checksum)
                written += len(data)
        dt = max(get_time() - t0, 1e-9)
        print(f"wrote {written} bytes, {written / (1 << 20) / dt:.2f} MB/sec")

    t0 = get_time()
    nbytes = read_sum = 0
    with create_stream_for_read(args.uri) as stream:
        while True:
            data = stream.read(_CHUNK)
            if not data:
                break
            nbytes += len(data)
            if checksum is not None:
                read_sum = _byte_sum(data, read_sum)
    dt = max(get_time() - t0, 1e-9)
    print(f"read {nbytes} bytes, {nbytes / (1 << 20) / dt:.2f} MB/sec")
    if checksum is not None and read_sum != checksum:
        print(f"ERROR: checksum mismatch {read_sum:#x} != {checksum:#x}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

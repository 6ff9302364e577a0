"""RecordIO round-trip harness, the port of ``dmlc_tpu/tools/recordio.py``
(test/recordio_test.cc:17-47): write seeded random records, the magic
word spliced into every third, read them back with ``RecordIOReader``
and with ``RecordIOChunkReader`` over ``--nsplit`` parts, and compare
byte for byte; with ``--write-index`` also build the IndexedRecordIO
index and read the records back through it.

Usage::

    python -m dmlc_tpu_torch.tools recordio <path> [--n N] [--nsplit K]
        [--seed S] [--write-index INDEX_PATH]
"""

from __future__ import annotations

import argparse
import struct
import sys
from typing import List, Optional

import numpy as np

from dmlc_tpu_torch.io import (
    RECORDIO_MAGIC,
    RecordIOChunkReader,
    RecordIOReader,
    RecordIOWriter,
    create_stream,
)

_MAGIC_BYTES = struct.pack("<I", RECORDIO_MAGIC)


def gen_records(n: int, seed: int) -> List[bytes]:
    """``n`` seeded payloads of 0-1499 bytes, the magic word spliced into
    every third (the JAX package's records for the same seed)."""
    rng = np.random.RandomState(seed)
    records = []
    for i in range(n):
        size = int(rng.randint(0, 1500))
        payload = rng.bytes(size)
        if i % 3 == 0 and size >= 4:
            pos = int(rng.randint(0, size - 3))
            payload = payload[:pos] + _MAGIC_BYTES + payload[pos + 4:]
        records.append(payload)
    return records


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="recordio", description=__doc__)
    ap.add_argument("uri", help="file to write the test records to")
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--nsplit", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--write-index", metavar="INDEX_URI", default="",
                    help="also build an IndexedRecordIO index file and "
                         "verify a record-count-partitioned read through it")
    args = ap.parse_args(argv)

    records = gen_records(args.n, args.seed)
    with create_stream(args.uri, "w") as stream:
        writer = RecordIOWriter(stream)
        writer.write_records(records)
        print(f"wrote {args.n} records, "
              f"{writer.except_counter} embedded-magic splits")

    with create_stream(args.uri, "r") as stream:
        got = list(RecordIOReader(stream))
    if got != records:
        print("ERROR: sequential read mismatch", file=sys.stderr)
        return 1
    print("sequential read ok")

    with create_stream(args.uri, "r") as stream:
        data = stream.read_all()
    got = []
    for part in range(args.nsplit):
        got.extend(bytes(r) for r in
                   RecordIOChunkReader(data, part, args.nsplit))
    if got != records:
        print(f"ERROR: chunk reader mismatch "
              f"({len(got)} vs {len(records)} records)", file=sys.stderr)
        return 1
    print(f"chunk read ok across {args.nsplit} parts")

    if args.write_index:
        from dmlc_tpu_torch.io import build_index, create_input_split

        n = build_index(args.uri, args.write_index)
        if n != len(records):
            print(f"ERROR: index has {n} records, wrote {len(records)}",
                  file=sys.stderr)
            return 1
        got = []
        for part in range(args.nsplit):
            split = create_input_split(args.uri, part, args.nsplit,
                                       "indexed_recordio",
                                       index_uri=args.write_index)
            got.extend(bytes(r) for r in split.records())
            split.close()
        if got != records:
            print("ERROR: indexed read mismatch", file=sys.stderr)
            return 1
        print(f"indexed read ok: {n} records via {args.write_index}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

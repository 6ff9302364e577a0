"""Block-service CLI, the port of ``dmlc_tpu/tools/serve.py``: run a
disaggregated parse host from the shell.

One process parses a dataset (any uri and format the parsers take) on its
device and serves the RowBlocks over TCP, dynamically sharded; consumers
attach with ``RemoteBlockParser(addr)`` (or a DeviceFeed over one).

Usage::

    python -m dmlc_tpu_torch.tools serve <uri> [--host H] [--port P]
        [--part K --nparts N] [--format auto|libsvm|libfm|csv|recordio]
        [--nthread N] [--grace SECS] [--linger] [--device DEV]
    python -m dmlc_tpu_torch.tools serve --dispatcher HOST:PORT [--host H]
        [--port P] [--nthread N] [--grace SECS] [--device DEV]

``--part/--nparts`` serve one InputSplit part (one serve host a part;
within a part consumers still shard dynamically). ``--dispatcher`` joins
a fault-tolerant fleet instead: the worker registers with a running
``dispatch`` process (data/dispatcher.py), heartbeats it and parses the
chunks it leases; killing it mid-epoch is safe (its leases requeue).
``--device`` is where the chunks are parsed: the card (the default; every
non-empty chunk part launches ``tokenize_boundaries`` there) or ``cpu``.

Prints ``serving HOST PORT`` once listening. Exits when the stream is
exhausted and delivery after the drain goes silent for ``--grace``
seconds (default 60; see ``BlockService.wait``), or keeps serving
end-of-stream to late consumers with ``--linger``. At exit it prints
``served N blocks`` and one JSON line ``{"worker": {...}}``: the chunks
this worker parsed (source-cache hits excluded) and its kernel launches.
The exit code is 0, 1 when a parse failed (a kernel that did not build or
launch among the causes), or :data:`EXIT_WORKER_CRASHED` after an
injected ``service.worker_crash``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from dmlc_tpu_torch.data import BlockService, create_parser
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check

# the exit code of a worker ended by an injected service.worker_crash
EXIT_WORKER_CRASHED = 43


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="serve", description=__doc__)
    ap.add_argument("uri", nargs="?", default=None)
    ap.add_argument("--dispatcher", default=None, metavar="HOST:PORT",
                    help="join a data-dispatcher fleet as a worker "
                         "instead of serving one URI")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--part", type=int, default=0)
    ap.add_argument("--nparts", type=int, default=1)
    ap.add_argument("--format", default="auto",
                    choices=["auto", "libsvm", "libfm", "csv", "recordio"])
    ap.add_argument("--nthread", type=int, default=2)
    ap.add_argument("--grace", type=float, default=60.0,
                    help="post-drain grace window seconds for slow "
                         "consumers (forwarded to BlockService.wait); "
                         "size it well above one consumer train step")
    ap.add_argument("--linger", action="store_true",
                    help="keep serving end-of-stream to late consumers")
    ap.add_argument("--device", default=None,
                    help="where chunks are parsed (default: cuda)")
    args = ap.parse_args(argv)
    check((args.uri is None) != (args.dispatcher is None),
          "serve takes exactly one of <uri> or --dispatcher")
    check(0 <= args.part < args.nparts, "bad part %d/%d (parts are "
          "0-based)", args.part, args.nparts)
    device = resolve_device(args.device)

    if args.dispatcher is not None:
        svc = BlockService(dispatcher=args.dispatcher, host=args.host,
                           port=args.port, nthread=args.nthread,
                           device=device)
    else:
        parser = create_parser(args.uri, args.part, args.nparts,
                               data_format=args.format,
                               nthread=args.nthread, device=device)
        svc = BlockService(parser, host=args.host, port=args.port,
                           device=device)
    host, port = svc.address
    print(f"serving {host} {port}", flush=True)
    try:
        svc.wait(timeout=args.grace)
        if args.linger:
            while True:
                time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        svc.close()
    from dmlc_tpu_torch.ops.kernels import KERNELS

    print(f"served {svc.blocks_served} blocks", flush=True)
    print(json.dumps({"worker": {
        "chunks_parsed": svc.chunks_parsed, "crashed": svc.crashed,
        "parse_error": svc.parse_error,
        "launches": {name: k.launches for name, k in KERNELS.items()}}}),
        flush=True)
    if svc.crashed:
        return EXIT_WORKER_CRASHED
    return 1 if svc.parse_error else 0


if __name__ == "__main__":
    sys.exit(main())

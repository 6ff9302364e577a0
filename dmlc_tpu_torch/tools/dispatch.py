"""Data-dispatcher CLI, the port of ``dmlc_tpu/tools/dispatch.py``: run the
fault-tolerant data service's control plane from the shell.

This process owns the chunk lease tables (data/dispatcher.py); ``serve
--dispatcher HOST:PORT`` workers register with it and parse the chunks
they lease, and ``RemoteBlockParser(addr, dispatcher=True)`` consumers
find the workers through it. Killing a worker mid-epoch is safe: its
leases requeue.

Usage::

    python -m dmlc_tpu_torch.tools dispatch <uri> [--nchunks N] [--host H]
        [--port P] [--format auto|libsvm|libfm|csv|recordio]
        [--lease-s SECS] [--dead-after-s SECS] [--status-port P]
        [--job NAME=URI ...]

Prints ``dispatching HOST PORT`` once listening, then blocks until every
chunk is acked and prints a summary with the requeue count, and one
``job NAME: ...`` line a named job. Repeat ``--job NAME=URI`` to register
more jobs over the same workers (the positional ``uri`` is the
``default`` job; ``-`` runs named jobs only); a consumer picks its ledger
with ``RemoteBlockParser(addr, dispatcher=True, job=NAME)``.

``--status-port`` also serves the live ``/data`` lease view (and the
status plane's other endpoints) over HTTP (obs/plane.py; 0 = any free
port, printed as ``status HOST PORT``).

The dispatcher parses nothing and holds no tensor, so it takes no
device and runs on any host, as the JAX package's does; each ``serve``
worker takes its own ``--device``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from dmlc_tpu_torch.data import DataDispatcher


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="dispatch", description=__doc__)
    ap.add_argument("uri",
                    help="dataset for the implicit 'default' job, or '-' "
                         "to start with --job registrations only")
    ap.add_argument("--nchunks", type=int, default=None,
                    help="chunks to split the dataset into (default: "
                         "DMLC_TPU_DATA_CHUNKS, 16)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--format", default="auto",
                    choices=["auto", "libsvm", "libfm", "csv", "recordio"])
    ap.add_argument("--lease-s", type=float, default=None,
                    help="chunk lease seconds (default: "
                         "DMLC_TPU_DATA_LEASE_S, 30)")
    ap.add_argument("--dead-after-s", type=float, default=None,
                    help="worker heartbeat-silence death threshold "
                         "(default: DMLC_TPU_DATA_DEAD_S, 10)")
    ap.add_argument("--status-port", type=int, default=None,
                    help="serve the /data lease view over HTTP on this "
                         "port (0 = any free port; default: no server)")
    ap.add_argument("--job", action="append", default=[],
                    metavar="NAME=URI",
                    help="register another job over the same workers "
                         "(repeatable); same --nchunks / --format as the "
                         "default job")
    args = ap.parse_args(argv)

    jobs = []
    for spec in args.job:
        name, sep, uri = spec.partition("=")
        if not sep or not name or not uri:
            ap.error(f"--job wants NAME=URI, got {spec!r}")
        jobs.append((name, uri))
    root_uri = None if args.uri == "-" else args.uri
    if root_uri is None and not jobs:
        ap.error("uri '-' needs at least one --job NAME=URI")
    disp = DataDispatcher(
        root_uri, nchunks=args.nchunks, host=args.host, port=args.port,
        lease_s=args.lease_s, dead_after_s=args.dead_after_s,
        data_format=args.format)
    for name, uri in jobs:
        disp.add_job(name, uri, nchunks=args.nchunks,
                     data_format=args.format)
    status = None
    if args.status_port is not None:
        from dmlc_tpu_torch.obs.plane import StatusPlane, StatusServer

        plane = StatusPlane()
        disp.attach_plane(plane)
        status = StatusServer(plane, port=args.status_port)
        status.start()
        print(f"status {args.host} {status.port}", flush=True)
    host, port = disp.address
    print(f"dispatching {host} {port}", flush=True)
    try:
        disp.join()
    except KeyboardInterrupt:
        pass
    finally:
        snap = disp.snapshot()
        if status is not None:
            status.close()
        disp.close()
    chunks = snap["chunks"]
    print(
        "dispatched %d chunks (%d acked, %d requeued, %d duplicate "
        "deliveries rejected)" % (chunks["total"], chunks["acked"],
                                  snap["requeued"], snap["rejects"]),
        flush=True)
    for name, _ in jobs:
        job = snap["jobs"].get(name)
        if job is None:
            continue
        print("job %s: %d/%d acked, %d requeued" % (
            name, job["chunks"]["acked"], job["chunks"]["total"],
            job["requeued"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

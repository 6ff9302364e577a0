"""Lease-based chunk dispatch, the fault-tolerant half of the data service
(the port of ``dmlc_tpu/data/dispatcher.py``; the wire and the snapshot are
the JAX package's, so a worker or consumer of either package talks to a
dispatcher of the other).

``data/service.py`` serves parsed RowBlocks; this module decides *who
parses what* when a fleet of data workers serves one dataset (the tf.data
service paper, arXiv:2210.14826, PAPERS.md: a visitation guarantee under
worker failure is what multi-epoch training needs):

- A job is split into ``nchunks`` chunk descriptors ``(seq, uri, part,
  nparts)``: InputSplit parts, so any worker can parse a reassigned chunk.
  ``seq`` is the id the exactly-once accounting keys on.
- :class:`~dmlc_tpu_torch.data.service.BlockService` workers register and
  heartbeat; each ``lease`` hands one worker the lowest queued seq with a
  deadline. A worker silent for ``DMLC_TPU_DATA_DEAD_S`` or past its lease
  (``DMLC_TPU_DATA_LEASE_S``) has its chunks requeued for whichever worker
  leases next.
- Consumers report receipt (``recv``) when a chunk's frame lands and
  ``ack`` once it is consumed. A chunk goes ``queued → leased → delivered
  → acked``; the dispatcher alone settles a requeue racing a late
  delivery, so each chunk is consumed once an epoch (a duplicate delivery
  is rejected and its consumer drops it).
- Each chunk gets one obs flow id at its first lease, kept through every
  reassignment.

**Jobs** (docs/distributed.md, "Multi-tenant fleet"): one dispatcher
carries several named chunk ledgers over one worker pool, each with its
own epoch counter and exactly-once state. :meth:`DataDispatcher.add_job`
is idempotent by name (a client that registers again resumes the ledger's
ack frontier); :meth:`remove_job` releases one ledger's leases and nothing
else. A lease that names a job is scoped to it (a full in-flight quota
answers ``busy``); one that does not is granted by weighted fair share
(lowest ``granted / weight`` among jobs with queued work). Admission past
``DMLC_TPU_DATA_MAX_JOBS`` raises :class:`DataBusyError`, an ``OSError``,
so the client's ``RetryPolicy`` backs off. Grants prefer a worker whose
source cache (:mod:`~dmlc_tpu_torch.data.source_cache`) already holds the
chunk's part. :meth:`drain_worker` retires a worker for scale-down
(data/autoscale.py): it gets no new lease, and its next idle poll is
answered ``retire``.

A lease deadline trades wasted work for liveness: a worker slow past its
lease loses the chunk, and its late delivery is rejected. A DELIVERED
chunk is different: its consumer holds the rows, so it requeues only once
that consumer's dispatcher connection is gone (a crashed consumer drops
its session; a slow one, held up by a long step, keeps it), and the
consumer also drops any seq it has already received.

The wire is a u32 little-endian length and then one JSON object a
message, over one persistent TCP connection a peer; :class:`DispatcherClient`
is the RPC shim workers and consumers share, re-dialing under the
resilience ``RetryPolicy``. The default chunk count comes from
``DMLC_TPU_DATA_CHUNKS``.

The worker, lease and requeue view is :meth:`DataDispatcher.snapshot`
(the status plane's ``/data`` body through :meth:`attach_plane`; per-job
ledgers under ``jobs``, the top-level keys the aggregates over jobs) and
the ``dmlc_dispatch_*`` metrics (per-job counters labelled ``job=``);
requeues, worker deaths, job registrations and scale-downs are also
flight-recorder events (``service.requeue``, ``service.worker_dead``,
``dispatch.job_register``, ``scale.down``). The dispatcher parses nothing
and holds no tensor: it needs no device.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.obs.flight import record_event
from dmlc_tpu_torch.params.env import get_env
from dmlc_tpu_torch.utils.logging import DMLCError, check, log_warning

# one framed message: u32 little-endian byte length + a JSON object.
# Length cap so a stray connection speaking another protocol cannot make
# the dispatcher allocate gigabytes off four garbage bytes.
_MAX_MSG = 1 << 20

_QUEUED = "queued"
_LEASED = "leased"
_DELIVERED = "delivered"
_ACKED = "acked"

# rows the lease table ships to /data (full accounting stays in the
# counters; the table is a human debugging view)
_SNAPSHOT_ROWS = 512

# the implicit job every single-tenant dispatcher carries (jid 0): the
# pre-multi-tenant RPC surface maps onto it, so legacy workers/clients
# keep working byte-for-byte
DEFAULT_JOB = "default"


def data_chunks(explicit: Optional[int] = None) -> int:
    """Chunks a job is split into: ``explicit``, else
    ``DMLC_TPU_DATA_CHUNKS``, else 16 (floor 1). More chunks lose less
    work to a worker death, at more lease calls an epoch."""
    if explicit is not None:
        return max(1, int(explicit))
    return max(1, get_env("DMLC_TPU_DATA_CHUNKS", 16))


def data_lease_s(explicit: Optional[float] = None) -> float:
    """Lease seconds: ``explicit``, else ``DMLC_TPU_DATA_LEASE_S``, else 30
    (floor 0.1). Keep it well above one chunk's parse, serve and
    consume: a lease that runs out requeues a chunk that was only slow."""
    if explicit is not None:
        return max(0.1, float(explicit))
    return max(0.1, float(get_env("DMLC_TPU_DATA_LEASE_S", 30.0)))


def data_dead_after_s(explicit: Optional[float] = None) -> float:
    """Seconds of heartbeat silence after which a worker is dead:
    ``explicit``, else ``DMLC_TPU_DATA_DEAD_S``, else 10 (floor 0.1).
    Workers beat at a third of it."""
    if explicit is not None:
        return max(0.1, float(explicit))
    return max(0.1, float(get_env("DMLC_TPU_DATA_DEAD_S", 10.0)))


def data_max_jobs(explicit: Optional[int] = None) -> int:
    """Jobs one dispatcher admits: ``explicit``, else
    ``DMLC_TPU_DATA_MAX_JOBS``, else 8 (floor 1)."""
    if explicit is not None:
        return max(1, int(explicit))
    return max(1, get_env("DMLC_TPU_DATA_MAX_JOBS", 8))


def data_job_inflight() -> int:
    """A job's default cap on leased + delivered chunks
    (``DMLC_TPU_DATA_JOB_INFLIGHT``; 0, the default, is no cap)."""
    return max(0, get_env("DMLC_TPU_DATA_JOB_INFLIGHT", 0))


class DataBusyError(OSError):
    """Admission refused under load (job cap reached).

    An ``OSError`` on purpose: the resilience layer's
    ``classify_transient`` already marks OSErrors retryable, so a caller
    registering a job under the shared ``RetryPolicy`` backs off and
    retries without any new classification plumbing — backpressure,
    not failure."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise OSError("dispatcher connection closed mid-frame")
        got += r
    return bytes(buf)


def _send_msg(sock: socket.socket, obj: Dict) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_msg(sock: socket.socket) -> Dict:
    (nbytes,) = struct.unpack("<I", _recv_exact(sock, 4))
    if nbytes > _MAX_MSG:
        raise ValueError("dispatcher frame too large: %d bytes" % nbytes)
    obj = json.loads(_recv_exact(sock, nbytes).decode())
    if not isinstance(obj, dict):
        raise ValueError("dispatcher frame is not an object")
    return obj


class DispatcherClient:
    """Framed-JSON RPC shim onto a :class:`DataDispatcher`.

    One persistent connection, one in-flight request at a time (the
    internal lock serializes callers — a feed's producer thread and its
    consumer's ack path share one client safely). A dead connection is
    re-dialed transparently under the shared ``RetryPolicy``; the caller
    sees either a reply dict or a ``DMLCError`` give-up."""

    def __init__(self, address: Tuple[str, int], timeout: float = 30.0):
        self.address = (str(address[0]), int(address[1]))
        self._timeout = float(timeout)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    def _ensure_locked(self) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection(
                self.address, timeout=self._timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
        return self._sock

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def call(self, obj: Dict, site: str = "service.dispatch") -> Dict:
        from dmlc_tpu_torch.resilience import RetryPolicy

        def attempt() -> Dict:
            with self._lock:
                try:
                    sock = self._ensure_locked()
                    _send_msg(sock, obj)
                    return _recv_msg(sock)
                except ValueError as err:
                    # garbled frame: reconnect and retry like a dead socket
                    self._drop_locked()
                    raise OSError(str(err)) from err
                except OSError:
                    self._drop_locked()
                    raise

        return RetryPolicy(max_attempts=5, base_s=0.05, cap_s=0.5).call(
            attempt, site,
            display="data dispatcher %s:%d" % self.address)

    def close(self) -> None:
        with self._lock:
            self._drop_locked()


def register_job(
    client: DispatcherClient,
    name: str,
    uri: str,
    nchunks: Optional[int] = None,
    data_format: str = "auto",
    weight: float = 1.0,
    max_inflight: Optional[int] = None,
) -> Dict:
    """Register (or resume) job ``name`` over the RPC surface.

    Idempotent: an existing ledger under the same name is resumed — the
    reply's ``created`` is False and ``acked`` lists the seqs already
    past the ack frontier, so a crashed client picks up where it left
    off instead of re-reading the epoch. Raises :class:`DataBusyError`
    when the dispatcher is at its ``DMLC_TPU_DATA_MAX_JOBS`` cap (the
    caller's RetryPolicy classifies it transient) and ``DMLCError`` on
    any other refusal."""
    req = {"op": "job", "name": str(name), "uri": str(uri),
           "data_format": str(data_format), "weight": float(weight)}
    if nchunks is not None:
        req["nchunks"] = int(nchunks)
    if max_inflight is not None:
        req["max_inflight"] = int(max_inflight)
    reply = client.call(req)
    if reply.get("busy"):
        raise DataBusyError(
            "dispatcher refused job %r: at its job cap "
            "(DMLC_TPU_DATA_MAX_JOBS)" % name)
    if not reply.get("ok"):
        raise DMLCError(
            "job registration %r failed: %s" % (name, reply.get("error")))
    return reply


def job_frontier(client: DispatcherClient, name: str) -> Dict:
    """Fetch job ``name``'s ledger frontier (epoch + acked seqs) over
    RPC — what a job snapshot persists so a relaunched run never
    re-leases settled chunks."""
    reply = client.call({"op": "job", "name": str(name),
                         "export_frontier": True})
    if not reply.get("ok"):
        raise DMLCError(
            "frontier export for job %r failed: %s"
            % (name, reply.get("error")))
    return {"epoch": reply["epoch"], "acked": reply["acked"]}


def restore_job_frontier(client: DispatcherClient, name: str,
                         frontier: Dict) -> int:
    """Re-seed job ``name``'s ledger from a snapshotted frontier over
    RPC; returns the number of seqs settled as acked."""
    reply = client.call({"op": "job", "name": str(name),
                         "restore_frontier": dict(frontier)})
    if not reply.get("ok"):
        raise DMLCError(
            "frontier restore for job %r failed: %s"
            % (name, reply.get("error")))
    return int(reply.get("acked", 0))


class DataDispatcher:
    """Registry of data workers + per-job lease tables over one fleet.

    ``uri`` is the single-tenant convenience: when given, it becomes the
    ``default`` job (jid 0) split into ``nchunks`` InputSplit parts —
    the exact pre-multi-tenant surface. ``uri=None`` starts an empty
    fleet manager; jobs arrive via :meth:`add_job` or the ``job`` RPC.
    ``lease_s``/``dead_after_s`` default through the
    ``DMLC_TPU_DATA_LEASE_S``/``DMLC_TPU_DATA_DEAD_S`` knobs. Expiry is
    scanned on every RPC (workers poll ``lease`` while idle, so a
    dispatcher with any live worker needs no timer thread).

    A job's ledger is ONE epoch's pass; :meth:`reset_job` starts the
    next epoch over the same ledger (all chunks requeued, epoch counter
    bumped) once the previous one is fully acked."""

    def __init__(
        self,
        uri: Optional[str] = None,
        nchunks: Optional[int] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        lease_s: Optional[float] = None,
        dead_after_s: Optional[float] = None,
        data_format: str = "auto",
        plane=None,
        max_jobs: Optional[int] = None,
    ):
        self.uri = str(uri) if uri is not None else None
        self.lease_s = data_lease_s(lease_s)
        self.dead_after_s = data_dead_after_s(dead_after_s)
        self.max_jobs = data_max_jobs(max_jobs)
        self._lock = threading.Lock()
        self._jobs: Dict[int, Dict] = {}
        self._job_names: Dict[str, int] = {}
        self._next_jid = 0
        self._workers: Dict[int, Dict] = {}
        self._next_worker = 0
        self._next_client = 0
        # chunk-source key -> worker ids that parsed it (their shared
        # source-cache tier holds it hot); lease grants prefer a hot
        # worker's chunks so a second job re-reading a source lands on
        # the worker that can serve it without re-parsing
        self._hot: Dict[Tuple, set] = {}
        # client id -> ids of live dispatcher connections that spoke for
        # it. A DELIVERED chunk requeues only when its holder has NO live
        # connection: consumer death is a dropped session, consumer
        # slowness is not — redelivering rows a live consumer already
        # holds would break exactly-once.
        self._client_conns: Dict[int, set] = {}
        # plain-int accounting (truthful under DMLC_TPU_METRICS=0; the
        # registry carries the telemetry mirror)
        self._requeued = 0
        self._acked = 0
        self._rejects = 0
        self._dup_acks = 0
        self._all_acked = threading.Event()
        reg = obs.registry()
        self._m_chunks = reg.counter(
            "dmlc_dispatch_chunks_total",
            "chunks registered for lease-based dispatch")
        self._m_requeued = reg.counter(
            "dmlc_dispatch_requeued_total",
            "chunk leases requeued after expiry or worker death")
        self._m_acked = reg.counter(
            "dmlc_dispatch_acked_total",
            "chunks acked by consumers (the exactly-once frontier)")
        self._m_rejects = reg.counter(
            "dmlc_dispatch_rejects_total",
            "duplicate chunk deliveries refused by the lease table")
        self._g_workers = reg.gauge(
            "dmlc_dispatch_workers_count", "live registered data workers")
        self._g_workers.set(0)
        self._g_jobs = reg.gauge(
            "dmlc_dispatch_jobs_count", "registered tenant jobs")
        self._g_jobs.set(0)
        if uri is not None:
            self.add_job(DEFAULT_JOB, uri, nchunks=nchunks,
                         data_format=data_format)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="data-dispatcher")
        self._accept_thread.start()
        if plane is not None:
            self.attach_plane(plane)

    # ---- job ledgers -----------------------------------------------------

    def add_job(
        self,
        name: str,
        uri: str,
        nchunks: Optional[int] = None,
        data_format: str = "auto",
        weight: float = 1.0,
        max_inflight: Optional[int] = None,
    ) -> Dict:
        """Register job ``name`` (idempotent) and return its ledger info.

        A name already registered resumes the EXISTING ledger — chunk
        states, epoch counter and ack frontier intact — so a client that
        crashed and re-registered continues the epoch instead of
        corrupting it with a fresh one (``created`` False, ``acked``
        lists the settled seqs). A genuinely new job above the
        ``DMLC_TPU_DATA_MAX_JOBS`` cap raises :class:`DataBusyError`.
        ``weight`` biases the fair-share lease scheduler;
        ``max_inflight`` caps the job's leased+delivered chunks (default
        via ``DMLC_TPU_DATA_JOB_INFLIGHT``; 0 = uncapped)."""
        name = str(name)
        with self._lock:
            jid = self._job_names.get(name)
            if jid is not None:
                job = self._jobs[jid]
                return {
                    "jid": jid, "epoch": job["epoch"], "created": False,
                    "acked": [c["seq"] for c in job["chunks"]
                              if c["state"] == _ACKED],
                }
            if len(self._jobs) >= self.max_jobs:
                raise DataBusyError(
                    "job cap reached (%d; DMLC_TPU_DATA_MAX_JOBS): "
                    "cannot admit %r" % (self.max_jobs, name))
            n = data_chunks(nchunks)
            check(n >= 1, "nchunks must be >= 1, got %d", n)
            jid = self._next_jid
            self._next_jid += 1
            reg = obs.registry()
            job = {
                "jid": jid,
                "name": name,
                "uri": str(uri),
                "format": str(data_format),
                "weight": max(0.001, float(weight)),
                "max_inflight": (data_job_inflight()
                                 if max_inflight is None
                                 else max(0, int(max_inflight))),
                "epoch": 1,
                "granted": 0,
                "requeued": 0,
                "rejects": 0,
                "dup_acks": 0,
                "busy": 0,
                "all_acked": threading.Event(),
                "chunks": [
                    {
                        "seq": k,
                        "job": jid,
                        "uri": str(uri),
                        "part": k,
                        "nparts": n,
                        "format": str(data_format),
                        "state": _QUEUED,
                        "worker": -1,
                        "client": -1,
                        "deadline": 0.0,
                        "requeues": 0,
                        "flow": 0,
                    }
                    for k in range(n)
                ],
                "m_acked": reg.counter(
                    "dmlc_dispatch_job_acked_total",
                    "chunks acked per tenant job", job=name),
                "m_requeued": reg.counter(
                    "dmlc_dispatch_job_requeued_total",
                    "chunk leases requeued per tenant job", job=name),
                "m_busy": reg.counter(
                    "dmlc_dispatch_job_busy_total",
                    "lease requests deferred by the job's in-flight quota",
                    job=name),
            }
            reg.counter(
                "dmlc_dispatch_job_chunks_total",
                "chunks registered per tenant job", job=name).inc(n)
            self._jobs[jid] = job
            self._job_names[name] = jid
            self._m_chunks.inc(n)
            self._g_jobs.set(len(self._jobs))
            self._all_acked.clear()
        record_event("dispatch.job_register", job=name, jid=jid, chunks=n)
        return {"jid": jid, "epoch": 1, "created": True, "acked": []}

    def remove_job(self, name: str) -> bool:
        """Tear down job ``name``: drop its ledger and release its leases
        without touching any other job's accounting. False when the name
        is unknown (teardown is idempotent too)."""
        with self._lock:
            jid = self._job_names.pop(str(name), None)
            if jid is None:
                return False
            del self._jobs[jid]
            self._g_jobs.set(len(self._jobs))
            self._update_all_acked_locked()
        return True

    def reset_job(self, name: str) -> int:
        """Start job ``name``'s next epoch: requeue every chunk of a
        FULLY-ACKED ledger and bump the epoch counter (fresh flows, fresh
        requeue counts). Returns the new epoch number; raises when the
        current epoch has unsettled chunks — an epoch boundary is an ack
        frontier, not a reset button."""
        with self._lock:
            jid = self._job_names.get(str(name))
            check(jid is not None, "unknown job %r", name)
            job = self._jobs[jid]
            check(all(c["state"] == _ACKED for c in job["chunks"]),
                  "job %r has unacked chunks; an epoch resets only at a "
                  "full ack frontier", name)
            for c in job["chunks"]:
                c["state"] = _QUEUED
                c["worker"] = -1
                c["client"] = -1
                c["deadline"] = 0.0
                c["requeues"] = 0
                c["flow"] = 0
            job["epoch"] += 1
            job["granted"] = 0
            job["all_acked"].clear()
            self._all_acked.clear()
            return job["epoch"]

    def export_frontier(self, name: str) -> Dict:
        """Job ``name``'s resumable ledger frontier for a job snapshot:
        the epoch counter and the seqs settled (acked) so far. Leased or
        delivered-but-unacked chunks are deliberately NOT exported — a
        restart replays them (at-least-once lease, exactly-once ack)."""
        with self._lock:
            jid = self._job_names.get(str(name))
            check(jid is not None, "unknown job %r", name)
            job = self._jobs[jid]
            return {
                "epoch": job["epoch"],
                "acked": [c["seq"] for c in job["chunks"]
                          if c["state"] == _ACKED],
            }

    def restore_frontier(self, name: str, frontier: Dict) -> int:
        """Re-seed job ``name``'s ledger from a snapshot frontier: the
        epoch counter is restored and every snapshotted acked seq is
        settled — those chunks are never leased again (exactly-once).
        Everything else returns to queued, dropping the dead attempt's
        leases. Returns the count of seqs marked acked."""
        epoch = max(1, int(frontier.get("epoch", 1)))
        acked = {int(s) for s in frontier.get("acked", ())}
        with self._lock:
            jid = self._job_names.get(str(name))
            check(jid is not None, "unknown job %r", name)
            job = self._jobs[jid]
            bad = acked - {c["seq"] for c in job["chunks"]}
            check(not bad,
                  "frontier for job %r names unknown seqs %s", name,
                  sorted(bad)[:8])
            for c in job["chunks"]:
                c["state"] = _ACKED if c["seq"] in acked else _QUEUED
                c["worker"] = -1
                c["client"] = -1
                c["deadline"] = 0.0
                c["flow"] = 0
            job["epoch"] = epoch
            job["granted"] = 0
            if all(c["state"] == _ACKED for c in job["chunks"]):
                job["all_acked"].set()
            else:
                job["all_acked"].clear()
                self._all_acked.clear()
            self._update_all_acked_locked()
        record_event("dispatch.frontier_restore", job=str(name),
                     epoch=epoch, acked=len(acked))
        return len(acked)

    def drain_worker(self, wid: int) -> None:
        """Mark worker ``wid`` draining for scale-down: it gets no new
        leases, and once its in-flight leases settle, its next idle
        lease poll is answered ``retire`` (the worker ends its stream
        and the dispatcher delists it). The autoscaler calls this before
        retiring a worker so no leased chunk is lost to the retirement."""
        from dmlc_tpu_torch.resilience import faultpoint

        faultpoint("scale.drain")
        with self._lock:
            w = self._workers.get(int(wid))
            check(w is not None, "unknown worker %d", wid)
            if not w["dead"]:
                w["draining"] = True

    # ---- transport ------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            # prune finished handler threads: a fault storm reconnects
            # DispatcherClients many times per epoch, and the list must
            # not grow one dead entry per reconnect
            self._threads = [
                th for th in self._threads if th.is_alive()] + [t]

    def _serve_conn(self, conn: socket.socket) -> None:
        from dmlc_tpu_torch.resilience import InjectedFault

        self._conns.append(conn)
        bound: set = set()  # client ids this connection spoke for
        try:
            while True:
                try:
                    obj = _recv_msg(conn)
                except (OSError, ValueError):
                    return  # peer gone / garbled — drop the connection
                try:
                    reply = self._handle(obj)
                except InjectedFault:
                    # injected lease-path fault: kill the connection,
                    # exactly like a dispatcher transport failure — the
                    # peer's DispatcherClient reconnects and retries
                    return
                except Exception as err:  # noqa: BLE001 — relay, don't die
                    reply = {"ok": False,
                             "error": "%s: %s" % (type(err).__name__, err)}
                # liveness binding: any op that names a client id ties
                # that client to this connection for delivered-chunk
                # requeue gating (see _expire_locked)
                try:
                    cid = int(reply.get("client_id", obj.get("client", -1)))
                except (TypeError, ValueError):
                    cid = -1
                if cid >= 0 and cid not in bound:
                    bound.add(cid)
                    with self._lock:
                        self._client_conns.setdefault(cid, set()).add(
                            id(conn))
                try:
                    _send_msg(conn, reply)
                except OSError:
                    return
        finally:
            with self._lock:
                for cid in bound:
                    conns = self._client_conns.get(cid)
                    if conns is not None:
                        conns.discard(id(conn))
                        if not conns:
                            del self._client_conns[cid]
            try:
                self._conns.remove(conn)
            except ValueError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    # ---- the chunk state machine ---------------------------------------

    def _handle(self, obj: Dict) -> Dict:
        op = obj.get("op")
        if op == "register":
            return self._op_register(obj)
        if op == "client":
            return self._op_client(obj)
        if op == "job":
            return self._op_job(obj)
        if op == "heartbeat":
            with self._lock:
                w = self._workers.get(int(obj.get("worker", -1)))
                if w is not None and not w["dead"]:
                    w["last_seen"] = time.monotonic()
                self._expire_locked()
            return {"ok": True}
        if op == "lease":
            return self._op_lease(obj)
        if op == "recv":
            return self._op_recv(obj)
        if op == "ack":
            return self._op_ack(obj)
        if op == "workers":
            with self._lock:
                self._expire_locked()
                live = [
                    [w["addr"][0], w["addr"][1], wid]
                    for wid, w in sorted(self._workers.items())
                    if not w["dead"]
                ]
            return {"ok": True, "workers": live}
        if op == "stats":
            return dict(self.snapshot(), ok=True)
        return {"ok": False, "error": "unknown op %r" % (op,)}

    def _op_job(self, obj: Dict) -> Dict:
        name = str(obj.get("name") or "")
        if not name:
            return {"ok": False, "error": "job op needs a name"}
        if obj.get("remove"):
            return {"ok": True, "removed": self.remove_job(name)}
        if obj.get("reset"):
            return {"ok": True, "epoch": self.reset_job(name)}
        if obj.get("export_frontier"):
            return dict(self.export_frontier(name), ok=True)
        frontier = obj.get("restore_frontier")
        if frontier is not None:
            return {"ok": True,
                    "acked": self.restore_frontier(name, frontier)}
        uri = obj.get("uri")
        if uri is None:
            return {"ok": False, "error": "job registration needs a uri"}
        try:
            info = self.add_job(
                name, str(uri),
                nchunks=obj.get("nchunks"),
                data_format=str(obj.get("data_format", "auto")),
                weight=float(obj.get("weight", 1.0)),
                max_inflight=obj.get("max_inflight"),
            )
        except DataBusyError:
            # typed backpressure on the wire: the registering client's
            # register_job() raises DataBusyError (an OSError) locally,
            # which its RetryPolicy already classifies transient
            return {"ok": False, "busy": True}
        return dict(info, ok=True)

    def _op_client(self, obj: Dict) -> Dict:
        name = obj.get("job")
        with self._lock:
            jid = 0
            epoch = 1
            acked: List[int] = []
            if name is not None:
                jid = self._job_names.get(str(name), -1)
                if jid < 0:
                    return {"ok": False,
                            "error": "unknown job %r" % (name,)}
            job = self._jobs.get(jid)
            if job is not None:
                epoch = job["epoch"]
                # the resumed ack frontier: a client re-registering after
                # a crash seeds its seen-set from this instead of
                # re-reading settled chunks
                acked = [c["seq"] for c in job["chunks"]
                         if c["state"] == _ACKED]
            cid = self._next_client
            self._next_client += 1
        return {"ok": True, "client_id": cid, "jid": jid, "epoch": epoch,
                "acked": acked}

    def _op_register(self, obj: Dict) -> Dict:
        raw = obj.get("addr") or ("", 0)
        addr = (str(raw[0]), int(raw[1]))
        with self._lock:
            # idempotent by serving address: register rides the retrying
            # DispatcherClient, so a lost reply re-sends it — minting a
            # fresh id each time would leave an orphan that never
            # heartbeats, later firing a spurious worker_dead and
            # skewing the workers gauge. Only one live worker can hold a
            # host:port, so the live match IS the earlier registration.
            wid = next(
                (known for known, w in self._workers.items()
                 if w["addr"] == addr and not w["dead"] and addr[1]),
                None)
            if wid is not None:
                self._workers[wid]["last_seen"] = time.monotonic()
            else:
                wid = self._next_worker
                self._next_worker += 1
                self._workers[wid] = {
                    "addr": addr,
                    "last_seen": time.monotonic(),
                    "dead": False,
                    "draining": False,
                }
            self._expire_locked()
        return {
            "ok": True,
            "worker_id": wid,
            # workers heartbeat a few times per death threshold so one
            # lost beat never reads as a crash
            "heartbeat_s": max(0.05, self.dead_after_s / 3.0),
        }

    def _all_chunks_locked(self) -> Iterable[Dict]:
        for jid in sorted(self._jobs):
            for c in self._jobs[jid]["chunks"]:
                yield c

    @staticmethod
    def _chunk_key(c: Dict) -> Tuple:
        return (c["uri"], c["part"], c["nparts"], c["format"])

    def _unhot_worker_locked(self, wid: int) -> None:
        for wids in self._hot.values():
            wids.discard(wid)

    def _drained_locked(self) -> bool:
        """Every job's every chunk is delivered-or-acked (EOF for an
        unrestricted lease; True for an empty dispatcher too)."""
        return all(c["state"] in (_ACKED, _DELIVERED)
                   for c in self._all_chunks_locked())

    def _pick_job_locked(self) -> Optional[Dict]:
        """Weighted fair-share: among jobs with queued work and headroom
        under their in-flight cap, the fewest granted-leases-per-weight
        wins (ties to the lowest jid — deterministic)."""
        best = None
        best_key = None
        for jid in sorted(self._jobs):
            job = self._jobs[jid]
            if not any(c["state"] == _QUEUED for c in job["chunks"]):
                continue
            cap = job["max_inflight"]
            if cap > 0:
                inflight = sum(1 for c in job["chunks"]
                               if c["state"] in (_LEASED, _DELIVERED))
                if inflight >= cap:
                    continue
            key = job["granted"] / job["weight"]
            if best is None or key < best_key:
                best, best_key = job, key
        return best

    def _op_lease(self, obj: Dict) -> Dict:
        from dmlc_tpu_torch.resilience import faultpoint

        faultpoint("service.lease")
        jid = int(obj.get("job", -1))
        if jid >= 0:
            # the job-scoped admission path has its own chaos site: a
            # fault here kills one tenant's lease RPC without touching
            # the shared service.lease plumbing
            faultpoint("dispatch.lease_job")
        wid = int(obj.get("worker", -1))
        with self._lock:
            now = time.monotonic()
            w = self._workers.get(wid)
            if w is not None:
                if w["dead"]:
                    # declared dead: its registration is gone; a zombie
                    # must not take leases the table thinks are safe
                    return {"ok": False, "dead": True}
                w["last_seen"] = now
            self._expire_locked()
            if w is not None and w.get("draining"):
                if any(c["state"] == _LEASED and c["worker"] == wid
                       for c in self._all_chunks_locked()):
                    # in-flight leases settle (deliver or expire) first;
                    # the worker keeps polling, which keeps it live
                    return {"ok": True, "wait": True}
                w["draining"] = False
                w["dead"] = True
                self._unhot_worker_locked(wid)
                record_event("scale.down", worker=wid,
                             addr="%s:%d" % w["addr"])
                self._g_workers.set(len(
                    [x for x in self._workers.values() if not x["dead"]]))
                return {"ok": True, "retire": True}
            if jid >= 0:
                job = self._jobs.get(jid)
                if job is None:
                    return {"ok": False, "error": "unknown job id %d" % jid}
                queued = [c for c in job["chunks"] if c["state"] == _QUEUED]
                if not queued:
                    # EOF once every chunk is delivered-or-acked: an
                    # explicit-ack consumer (DeviceFeed) may hold
                    # received rows across many batches before acking,
                    # and gating EOF on acks would deadlock it against
                    # its own worker. join() still waits for the full
                    # ack frontier. "all" tells the worker whether the
                    # WHOLE fleet is drained (it may serve other jobs).
                    if all(c["state"] in (_ACKED, _DELIVERED)
                           for c in job["chunks"]):
                        return {"ok": True, "eof": True,
                                "all": self._drained_locked()}
                    return {"ok": True, "wait": True}
                cap = job["max_inflight"]
                if cap > 0:
                    inflight = sum(1 for c in job["chunks"]
                                   if c["state"] in (_LEASED, _DELIVERED))
                    if inflight >= cap:
                        # quota backpressure, not an error: the worker
                        # polls again, the consumer just waits
                        job["busy"] += 1
                        job["m_busy"].inc()
                        return {"ok": True, "busy": True}
            else:
                job = self._pick_job_locked()
                if job is None:
                    if self._drained_locked():
                        return {"ok": True, "eof": True, "all": True}
                    # leased chunks may still requeue; the worker polls
                    # (each poll doubles as a heartbeat + expiry scan)
                    return {"ok": True, "wait": True}
                queued = [c for c in job["chunks"] if c["state"] == _QUEUED]
            # cache-aware routing: this worker's hot chunks first (its
            # source-cache tier already holds the parsed part), lowest
            # seq otherwise — which keeps a cold fleet's assignment
            # order deterministic
            chunk = next(
                (c for c in queued
                 if wid in self._hot.get(self._chunk_key(c), ())),
                queued[0])
            if not chunk["flow"]:
                # one flow per chunk, minted at FIRST lease and carried
                # through every reassignment — the merged trace's arrow
                # chain then shows every worker that touched the chunk
                chunk["flow"] = obs.new_flow()
                obs.flow_start(chunk["flow"], "chunk")
            chunk["state"] = _LEASED
            chunk["worker"] = wid
            chunk["client"] = -1
            chunk["deadline"] = now + self.lease_s
            job["granted"] += 1
            self._hot.setdefault(
                self._chunk_key(chunk), set()).add(wid)
            return {
                "ok": True,
                "chunk": {
                    "seq": chunk["seq"],
                    "job": job["jid"],
                    "uri": chunk["uri"],
                    "part": chunk["part"],
                    "nparts": chunk["nparts"],
                    "format": chunk["format"],
                    "flow": chunk["flow"],
                },
            }

    def _chunk_locked(self, jid: int, seq: int) -> Optional[Dict]:
        job = self._jobs.get(jid)
        if job is not None and 0 <= seq < len(job["chunks"]):
            return job["chunks"][seq]
        return None

    def _op_recv(self, obj: Dict) -> Dict:
        cid = int(obj.get("client", -1))
        jid = int(obj.get("job", 0))
        seq = int(obj.get("seq", -1))
        with self._lock:
            self._expire_locked()
            c = self._chunk_locked(jid, seq)
            if c is None:
                return {"ok": False, "reject": True,
                        "error": "unknown seq %d" % seq}
            if c["state"] in (_LEASED, _QUEUED):
                # a requeued-but-not-releases chunk whose original send
                # did land is reclaimed here: the bytes arrived, so this
                # delivery wins and the requeue is undone
                c["state"] = _DELIVERED
                c["client"] = cid
                c["deadline"] = time.monotonic() + self.lease_s
                return {"ok": True}
            if c["state"] == _DELIVERED and c["client"] == cid:
                return {"ok": True}  # same consumer re-reporting (hedge)
            # delivered to someone else or already acked: the reporter
            # must DROP this copy — that is the exactly-once guarantee
            self._rejects += 1
            self._jobs[jid]["rejects"] += 1
            self._m_rejects.inc()
            return {"ok": True, "reject": True}

    def _op_ack(self, obj: Dict) -> Dict:
        jid = int(obj.get("job", 0))
        seq = int(obj.get("seq", -1))
        with self._lock:
            self._expire_locked()
            c = self._chunk_locked(jid, seq)
            if c is None:
                return {"ok": False, "error": "unknown seq %d" % seq}
            job = self._jobs[jid]
            if c["state"] == _ACKED:
                self._dup_acks += 1
                job["dup_acks"] += 1
                return {"ok": True, "dup": True}
            # an ack is authoritative from ANY state: the consumer holds
            # the rows, so even a chunk the expiry scan already requeued
            # is done — acking it here is what stops a second serve
            c["state"] = _ACKED
            c["worker"] = -1
            c["deadline"] = 0.0
            self._acked += 1
            self._m_acked.inc()
            job["m_acked"].inc()
            if c["flow"]:
                obs.flow_step(c["flow"], "chunk")
            if all(ch["state"] == _ACKED for ch in job["chunks"]):
                job["all_acked"].set()
            self._update_all_acked_locked()
            return {"ok": True}

    def _update_all_acked_locked(self) -> None:
        if self._jobs and all(c["state"] == _ACKED
                              for c in self._all_chunks_locked()):
            self._all_acked.set()

    def _expire_locked(self) -> None:
        now = time.monotonic()
        for wid, w in self._workers.items():
            if not w["dead"] and now - w["last_seen"] > self.dead_after_s:
                w["dead"] = True
                w["draining"] = False
                self._unhot_worker_locked(wid)
                record_event("service.worker_dead", worker=wid,
                             addr="%s:%d" % w["addr"])
                log_warning(
                    "data worker %d (%s:%d) declared dead (%.1fs silent)",
                    wid, w["addr"][0], w["addr"][1], now - w["last_seen"])
        for jid in sorted(self._jobs):
            job = self._jobs[jid]
            for c in job["chunks"]:
                if c["state"] == _LEASED:
                    w = self._workers.get(c["worker"])
                    expired = (now > c["deadline"]
                               or w is None or w["dead"])
                elif c["state"] == _DELIVERED:
                    # the holder already HAS the rows — requeueing while
                    # it is alive would serve them twice. Its dispatcher
                    # session is the liveness signal: a crashed consumer
                    # drops the TCP connection; a slow one (long steps
                    # take minutes) keeps it open and keeps the chunk,
                    # however long past the deadline. The deadline still
                    # applies once the holder is gone.
                    expired = (now > c["deadline"]
                               and c["client"] not in self._client_conns)
                else:
                    continue
                if not expired:
                    continue
                record_event("service.requeue", seq=c["seq"],
                             job=job["name"], state=c["state"],
                             worker=c["worker"], client=c["client"],
                             requeues=c["requeues"] + 1)
                c["state"] = _QUEUED
                c["worker"] = -1
                c["client"] = -1
                c["deadline"] = 0.0
                c["requeues"] += 1
                self._requeued += 1
                job["requeued"] += 1
                self._m_requeued.inc()
                job["m_requeued"].inc()
        self._g_workers.set(
            len([w for w in self._workers.values() if not w["dead"]]))

    # ---- read side ------------------------------------------------------

    @staticmethod
    def _counts(chunks: List[Dict]) -> Dict[str, int]:
        counts = {_QUEUED: 0, _LEASED: 0, _DELIVERED: 0, _ACKED: 0}
        for c in chunks:
            counts[c["state"]] += 1
        return {
            "total": len(chunks),
            "queued": counts[_QUEUED],
            "leased": counts[_LEASED],
            "delivered": counts[_DELIVERED],
            "acked": counts[_ACKED],
        }

    @staticmethod
    def _table(chunks: List[Dict], cap: int = _SNAPSHOT_ROWS) -> List[Dict]:
        return [
            {
                "seq": c["seq"],
                "state": c["state"],
                "worker": c["worker"],
                "client": c["client"],
                "requeues": c["requeues"],
            }
            for c in chunks[:cap]
        ]

    def snapshot(self) -> Dict:
        """The live worker/lease/requeue view (the ``/data`` endpoint
        body). Top-level keys are the pre-multi-tenant surface —
        aggregates across every job, byte-stable for existing consumers;
        per-job ledgers live under ``jobs``. Exactly-once invariant at
        end of epoch: ``chunks.acked == chunks.total`` with ``queued ==
        leased == delivered == 0`` and every requeue drained."""
        with self._lock:
            self._expire_locked()
            now = time.monotonic()
            all_chunks = list(self._all_chunks_locked())
            jobs = {}
            for jid in sorted(self._jobs):
                job = self._jobs[jid]
                jobs[job["name"]] = {
                    "jid": jid,
                    "uri": job["uri"],
                    "epoch": job["epoch"],
                    "weight": job["weight"],
                    "max_inflight": job["max_inflight"],
                    "granted": job["granted"],
                    "busy": job["busy"],
                    "requeued": job["requeued"],
                    "rejects": job["rejects"],
                    "duplicate_acks": job["dup_acks"],
                    "chunks": self._counts(job["chunks"]),
                    "lease_table": self._table(job["chunks"]),
                }
            workers = {
                str(wid): {
                    "addr": "%s:%d" % w["addr"],
                    "live": not w["dead"],
                    "draining": bool(w.get("draining")),
                    "lag_s": round(now - w["last_seen"], 3),
                    "leased": len([
                        c for c in all_chunks
                        if c["state"] == _LEASED and c["worker"] == wid
                    ]),
                }
                for wid, w in sorted(self._workers.items())
            }
        return {
            "chunks": self._counts(all_chunks),
            "requeued": self._requeued,
            "rejects": self._rejects,
            "duplicate_acks": self._dup_acks,
            "workers": workers,
            "jobs": jobs,
            "lease_table": self._table(all_chunks),
        }

    def attach_plane(self, plane) -> None:
        """Expose :meth:`snapshot` as the status plane's ``/data``
        endpoint (``StatusPlane.set_data_provider``)."""
        plane.set_data_provider(self.snapshot)

    def join(self, timeout: Optional[float] = None,
             job: Optional[str] = None) -> bool:
        """Block until every chunk is acked — of job ``job`` when named,
        of EVERY registered job otherwise (the epoch is complete); True
        on completion, False on timeout."""
        if job is not None:
            with self._lock:
                jid = self._job_names.get(str(job))
                check(jid is not None, "unknown job %r", job)
                event = self._jobs[jid]["all_acked"]
            return event.wait(timeout)
        return self._all_acked.wait(timeout)

    def close(self) -> None:
        """Stop serving. Each socket is shut down before it is closed: a
        close alone wakes neither the accept loop nor a thread blocked in
        recv, so the dispatcher would go on accepting and answering, and
        its workers would never see it gone."""
        for sock in [self._sock] + list(self._conns):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def dispatcher_address(spec: Union[str, Tuple[str, int]]) -> Tuple[str, int]:
    """Normalize a ``host:port`` string or ``(host, port)`` pair — the
    accepted ``dispatcher=`` argument shapes of BlockService and
    RemoteBlockParser."""
    if isinstance(spec, str):
        host, _, port = spec.rpartition(":")
        check(bool(host) and port.isdigit(),
              "bad dispatcher address %r (want host:port)", spec)
        return host, int(port)
    return str(spec[0]), int(spec[1])

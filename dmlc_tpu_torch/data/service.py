"""Disaggregated ingest: parsed RowBlocks served over TCP (the tf.data
service shape, arXiv:2210.14826, PAPERS.md; the port of
``dmlc_tpu/data/service.py``, byte-compatible with it on the wire).

A training host that parses its own input spends its cores on the parse;
disaggregation moves the parse to data workers and sends the consumers
finished blocks:

- :class:`BlockService` serves the RowBlocks of one parser (a uri or a
  Parser) to any number of consumers, **dynamically sharded**: blocks go
  out in arrival order, so a faster consumer takes more.
- :class:`RemoteBlockParser` is Parser-shaped: ``next_block()`` pulls one
  RowBlock, so ``DeviceFeed(RemoteBlockParser(addr), spec)`` and every
  learner compose unchanged.

Both ends also speak **dispatcher mode** (data/dispatcher.py), the
fault-tolerant fleet: ``BlockService(dispatcher=addr)`` is a registered
data *worker* that leases chunk descriptors from a
:class:`~dmlc_tpu_torch.data.dispatcher.DataDispatcher`, heartbeats it and
parses each leased chunk with ``create_parser(..., device=)`` on its own
device (the native route for a local or single-remote source; on the
Python stack every non-empty chunk part launches ``tokenize_boundaries``
on the card), and ``RemoteBlockParser(addr, dispatcher=True)``
is a failover consumer: it finds live workers through the dispatcher,
re-dials the next one when a worker dies mid-stream, reports the receipt
and consumption of each chunk (the exactly-once protocol) and may hedge a
slow fetch against a second worker (``DMLC_TPU_DATA_HEDGE_S``). A
worker's stash of undelivered blocks is capped by
``DMLC_TPU_DATA_PENDING_CAP`` and counted as
``dmlc_service_requeued_total``, apart from drops.

Jobs (docs/distributed.md, "Multi-tenant fleet"): a worker serves every
job's chunks from one process through the shared
:mod:`~dmlc_tpu_torch.data.source_cache`, so N jobs over one dataset parse
it once, and ``RemoteBlockParser(addr, dispatcher=True, job="name")``
reads its job's ledger only. A worker retired for scale-down
(data/autoscale.py) ends with a dropped connection, never a clean end of
stream, so its consumers fail over as if it had died.

Wire format (little-endian, a response): u32 field count (0 = end of
stream), then for each field a u8 name length and the name, a u8 dtype
string length and the dtype string, a u64 byte length and the array's
bytes; every RowBlock field is 1-D. A request is one u32: 1 = NEXT,
2 = CLOSE, 3 = NEXT_JOB followed by a u32 job id. Fields are addressed by
name, so the dispatcher-mode extras (``seq``, ``flow``, ``job``) are
invisible to a consumer that does not ask for them.

Like the parsers it serves, a service is one streaming pass (data.h:298):
an epoch re-creates the service and its consumers, or a fleet registers a
job an epoch with its dispatcher. A service parses on ``device`` (None
means cuda; a host without a card raises unless ``device="cpu"``).
:func:`reshard_split` recomputes an InputSplit's partition after a
membership change.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.data.dispatcher import DispatcherClient, dispatcher_address
from dmlc_tpu_torch.obs import audit
from dmlc_tpu_torch.data.parsers import Parser, create_parser
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.data.source_cache import source_cache
from dmlc_tpu_torch.params.env import get_env
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import DMLCError, check, log_warning

_REQ_NEXT = 1
_REQ_CLOSE = 2
# NEXT scoped to one tenant job: the u32 request code is followed by a
# u32 job id. A source-mode service treats it as plain NEXT (it has no
# job ledgers), so one client codepath speaks to both service shapes.
_REQ_NEXT_JOB = 3

# Response sentinel in the u32 field-count slot: server-side parse failure.
# Followed by u32 message length + utf-8 message; consumers raise DMLCError.
_RESP_ERROR = 0xFFFFFFFF

_BLOCK_FIELDS = ("offset", "label", "index", "value", "weight", "qid",
                 "field")

# how long a full pending stash waits for a consumer to drain it before
# the block is dropped (module constant so tests can shrink it)
_PENDING_WAIT_S = 1.0


def data_pending_cap() -> int:
    """Cap on a service's stash of undelivered blocks
    (``DMLC_TPU_DATA_PENDING_CAP``, default 64; 0 or less is no cap). A
    full stash holds the stashing thread briefly, then drops the block,
    counted as a drop."""
    return get_env("DMLC_TPU_DATA_PENDING_CAP", 64)


def data_hedge_s() -> float:
    """Seconds a dispatcher-mode fetch waits before racing a second worker
    (``DMLC_TPU_DATA_HEDGE_S``; 0, the default, is no hedge)."""
    return max(0.0, float(get_env("DMLC_TPU_DATA_HEDGE_S", 0.0)))


class TruncatedFrame(OSError):
    """A peer hung up mid-frame.

    An OSError (not DMLCError) on purpose: mid-frame closes are TRANSPORT
    failures — the failover client re-dials and retries them, while
    DMLCError stays reserved for fatal in-protocol errors (the server's
    explicit error frame)."""


def _pack_arrays(arrays: Dict[str, np.ndarray]) -> bytes:
    parts = [struct.pack("<I", len(arrays))]
    for name, arr in arrays.items():
        data = np.ascontiguousarray(arr).tobytes()
        dt = arr.dtype.str
        parts.append(struct.pack("<B", len(name)) + name.encode())
        parts.append(struct.pack("<B", len(dt)) + dt.encode())
        parts.append(struct.pack("<Q", len(data)))
        parts.append(data)
    return b"".join(parts)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise TruncatedFrame(
                "block service connection closed mid-frame")
        got += r
    return bytes(buf)


def _send_error(sock: socket.socket, msg: str) -> None:
    data = msg.encode()
    sock.sendall(struct.pack("<II", _RESP_ERROR, len(data)) + data)


def _recv_arrays(sock: socket.socket) -> Optional[Dict[str, np.ndarray]]:
    (nfields,) = struct.unpack("<I", _recv_exact(sock, 4))
    if nfields == _RESP_ERROR:
        (mlen,) = struct.unpack("<I", _recv_exact(sock, 4))
        raise DMLCError(
            "block service parse failed: " + _recv_exact(sock, mlen).decode()
        )
    if nfields == 0:
        return None
    out: Dict[str, np.ndarray] = {}
    for _ in range(nfields):
        (nlen,) = struct.unpack("<B", _recv_exact(sock, 1))
        name = _recv_exact(sock, nlen).decode()
        (dlen,) = struct.unpack("<B", _recv_exact(sock, 1))
        dtype = np.dtype(_recv_exact(sock, dlen).decode())
        (nbytes,) = struct.unpack("<Q", _recv_exact(sock, 8))
        out[name] = np.frombuffer(_recv_exact(sock, nbytes), dtype=dtype)
    return out


class BlockService:
    """Serve RowBlocks to N consumers, dynamically sharded.

    Two sources:

    - ``source=`` (URI or Parser instance): the standalone shape — this
      service owns one whole stream. ``parser_kwargs`` pass through to
      :func:`create_parser` — notably ``nthread`` (parse fan-out;
      default ``parsers.DEFAULT_NTHREAD``).
    - ``dispatcher=`` (host:port or (host, port)): the fleet shape —
      this service is a data *worker* registered with a
      :class:`~dmlc_tpu_torch.data.dispatcher.DataDispatcher`. It heartbeats,
      leases chunk descriptors one at a time, parses each leased chunk
      with :func:`create_parser` (any worker can parse any chunk), and
      serves it as one frame tagged with the chunk's ``seq``. A worker
      that dies simply stops heartbeating — its leases expire and the
      dispatcher reassigns them to surviving workers.

    Either way the parse runs on ``device`` (None means cuda and raises
    on a host without a card; ``device="cpu"`` asks for the host): a
    uri's parser and every leased chunk's parser are built there."""

    def __init__(
        self,
        source: Union[str, Parser, None] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        dispatcher: Union[str, Tuple[str, int], None] = None,
        device=None,
        **parser_kwargs,
    ):
        check(
            (source is None) != (dispatcher is None),
            "BlockService takes exactly one of source= or dispatcher=",
        )
        self.device = resolve_device(device)
        if dispatcher is not None:
            self._parser: Optional[Parser] = None
            self._parser_kwargs = dict(parser_kwargs, device=self.device)
        else:
            self._parser = (
                create_parser(source, 0, 1, device=self.device,
                              **parser_kwargs)
                if isinstance(source, str)
                else source
            )
            self._parser_kwargs = {}
        self._lock = threading.Lock()  # serializes parser pulls (the shard
        # point: one block goes to exactly one consumer)
        self._cond = threading.Condition(self._lock)  # signaled when the
        # pending stash drains (backpressure for _stash_undelivered)
        self._pending_cap = data_pending_cap()
        self._done = False
        self._crashed = False  # injected worker_crash fired: the worker is
        # simulating sudden death (sockets closed, heartbeats stopped)
        self._drained = threading.Event()  # set when the stream is exhausted
        self._pending: Dict[int, list] = {}  # job id (-1 = legacy/source
        # mode) -> blocks pulled but undelivered (their consumer died
        # mid-send); redelivered before the next parser pull so those rows
        # stay in the epoch — and only to a consumer of the SAME job
        self._done_jids: set = set()  # jobs whose ledger this worker saw
        # EOF for while the fleet as a whole still has work (per-job EOS
        # without ending the worker's stream)
        self._chunks_parsed = 0  # chunks actually parsed by THIS worker
        # (source-cache hits excluded) — the cross-job cache proof reads
        # this: a second job over a cached source must not move it
        self._error: Optional[DMLCError] = None  # parser failure, relayed to
        # every consumer instead of an opaque mid-frame close
        self._error_msg: Optional[str] = None  # plain one-line form of the
        # same failure for the wire (DMLCError's str embeds a server-side
        # stack trace consumers don't need)
        self._responses_done = 0  # monotonic completed-response counter —
        # wait()'s forward-progress signal (a gauge alone cannot tell
        # "steadily delivering" from "wedged"). Control-flow state, so it
        # stays a plain int (must keep working under DMLC_TPU_METRICS=0);
        # the obs registry carries the telemetry mirror.
        self._bytes_sent = 0  # monotonic payload bytes pushed to sockets —
        # makes an in-flight send to a slow consumer visible as progress
        # (responses_done only ticks at completion). Plain int, same
        # reason as _responses_done.
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        # obs metrics, labeled by bound port (one label set per service)
        svc = str(self.address[1])
        reg = obs.registry()
        self._m_served = reg.counter(
            "dmlc_service_blocks_served_total",
            "blocks handed to a consumer", svc=svc)
        self._m_dropped = reg.counter(
            "dmlc_service_blocks_dropped_total",
            "undelivered blocks at close (rows lost to the epoch)", svc=svc)
        self._m_requeued = reg.counter(
            "dmlc_service_requeued_total",
            "undelivered blocks stashed for redelivery (rows kept in the "
            "epoch)", svc=svc)
        self._m_responses = reg.counter(
            "dmlc_service_responses_total",
            "responses completed (telemetry mirror of the wait() signal)",
            svc=svc)
        self._m_unconfirmed = reg.counter(
            "dmlc_service_unconfirmed_total",
            "legacy-mode responses fully sent to a consumer that vanished "
            "before its next request (rows possibly lost: TCP cannot "
            "confirm delivery, and without the dispatcher's ack ledger "
            "redelivery could duplicate)", svc=svc)
        self._m_sent = reg.counter(
            "dmlc_service_sent_bytes_total",
            "payload bytes pushed to consumer sockets", svc=svc)
        self._threads: list = []
        self._conns: list = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="block-service"
        )
        self._accept_thread.start()
        self._dispatch: Optional[DispatcherClient] = None
        self._worker_id = -1
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if dispatcher is not None:
            self._dispatch = DispatcherClient(dispatcher_address(dispatcher))
            reply = self._dispatch.call(
                {"op": "register", "addr": list(self.address)})
            self._worker_id = int(reply.get("worker_id", -1))
            self._hb_s = float(reply.get("heartbeat_s", 1.0))
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="block-service-hb")
            self._hb_thread.start()

    # ---- server side ---------------------------------------------------

    @property
    def blocks_served(self) -> int:
        return int(self._m_served.value)

    @property
    def blocks_dropped(self) -> int:
        """Undelivered blocks still pending at close() — rows that never
        reached any consumer."""
        return int(self._m_dropped.value)

    @property
    def blocks_requeued(self) -> int:
        """Undelivered blocks stashed for redelivery after their consumer
        died mid-send — distinct from drops (those rows stayed in)."""
        return int(self._m_requeued.value)

    @property
    def blocks_unconfirmed(self) -> int:
        """Legacy-mode responses fully sent to a consumer that vanished
        before issuing another request — delivery unknowable (possible
        row loss); dispatcher mode closes this window with recv/ack."""
        return int(self._m_unconfirmed.value)

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self._hb_s):
            if self._crashed:
                return  # a crashed worker goes silent — that IS the signal
            try:
                self._dispatch.call(
                    {"op": "heartbeat", "worker": self._worker_id})
            except DMLCError:
                # the dispatcher is gone past retries: no lease can be
                # granted any more, so the stream is over, as on the lease
                # path. This also ends a worker no consumer ever dialed
                # (it would otherwise wait for a lease reply for ever).
                with self._lock:
                    self._done = True
                    self._drained.set()
                return

    def _simulate_crash(self) -> None:
        """Injected ``service.worker_crash``: die the way a real worker
        does — stop heartbeating and close every socket abruptly, so
        consumers see mid-frame cuts and the dispatcher sees silence."""
        self._crashed = True
        self._hb_stop.set()
        with self._lock:
            self._done = True
            self._drained.set()
        log_warning(
            "block service %s:%d simulating worker crash (injected fault)",
            self.address[0], self.address[1])
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass

    @property
    def chunks_parsed(self) -> int:
        """Chunks this worker parsed for real (cache hits excluded)."""
        return self._chunks_parsed

    @property
    def crashed(self) -> bool:
        """Whether an injected ``service.worker_crash`` ended this worker."""
        return self._crashed

    @property
    def parse_error(self) -> Optional[str]:
        """The one-line parse failure that ended the stream, or None."""
        return self._error_msg

    def _parse_chunk_fields(self, chunk: Dict) -> Dict[str, np.ndarray]:
        """The actual parse: one chunk descriptor -> the frame's field
        arrays, WITHOUT the per-lease seq/job/flow tags (this is the
        source-cache entry shape — the tags differ per job and per
        lease, the parsed bytes do not)."""
        self._chunks_parsed += 1
        parser = create_parser(
            chunk["uri"], chunk["part"], chunk["nparts"],
            data_format=chunk.get("format", "auto"), **self._parser_kwargs)
        cont = RowBlockContainer()
        try:
            while True:
                block = parser.next_block()
                if block is None:
                    break
                cont.push_block(block)
        finally:
            parser.close()
        block = cont.to_block()
        out = {}
        for name in _BLOCK_FIELDS:
            arr = getattr(block, name)
            if arr is not None:
                out[name] = np.asarray(arr)
        return out

    def _parse_chunk(self, chunk: Dict) -> Dict[str, np.ndarray]:
        """Parse one leased chunk descriptor into a single response frame
        tagged with its ``seq``/``job`` (and the chunk's flow, so a
        reassigned chunk's trace chain spans every worker that touched
        it). Parses go through the job-shared source cache when it is
        enabled: N jobs leasing the same source part pay one parse, and
        an injected ``cache.populate`` fault degrades to a direct
        uncached parse — the tier costs performance, never rows."""
        from dmlc_tpu_torch.resilience import InjectedFault

        fields = None
        cache = source_cache()
        if cache.enabled:
            key = cache.chunk_key(
                chunk["uri"], chunk["part"], chunk["nparts"],
                chunk.get("format", "auto"), self._parser_kwargs)
            try:
                fields = cache.get_or_populate(
                    key, lambda: self._parse_chunk_fields(chunk))
            except InjectedFault:
                fields = None
        if fields is None:
            fields = self._parse_chunk_fields(chunk)
        out = dict(fields)  # the cached dict is shared across jobs —
        # tag a copy, never the entry itself
        out["seq"] = np.asarray([chunk["seq"]], dtype=np.int64)
        out["job"] = np.asarray(
            [int(chunk.get("job", 0))], dtype=np.int64)
        fid = int(chunk.get("flow") or 0)
        if fid:
            out["flow"] = np.asarray([fid], dtype=np.int64)
        return out

    def _pop_pending_locked(self, jid: int) -> Optional[Dict]:
        """Pop one stashed undelivered frame deliverable to a consumer of
        job ``jid`` (-1 = any job: the unscoped legacy pull). Lock held."""
        if jid >= 0:
            stash = self._pending.get(jid)
            if stash:
                return stash.pop(0)
            return None
        for key in sorted(self._pending):
            if self._pending[key]:
                return self._pending[key].pop(0)
        return None

    def _pending_total_locked(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def _next_chunk_arrays(self, jid: int = -1
                           ) -> Optional[Dict[str, np.ndarray]]:
        """Dispatcher-mode source: lease → parse → serve, one chunk per
        call, scoped to job ``jid`` when >= 0. The dispatcher is the
        shard point here (its lease table assigns each chunk exactly
        once), so the local lock is NOT held across the lease RPC or the
        parse — two consumer connections can parse two leased chunks
        concurrently."""
        from dmlc_tpu_torch.resilience import InjectedFault, faultpoint

        while True:
            with self._lock:
                stashed = self._pop_pending_locked(jid)
                if stashed is not None:
                    self._cond.notify()
                    return stashed
                if self._error is not None:
                    raise self._error
                if self._crashed:
                    raise OSError("block service worker crashed")
                if self._done:
                    return None
                if jid >= 0 and jid in self._done_jids:
                    return None  # this job's ledger already hit EOF
            req = {"op": "lease", "worker": self._worker_id}
            if jid >= 0:
                req["job"] = jid
            try:
                reply = self._dispatch.call(req)
            except DMLCError as err:
                # the dispatcher is unreachable past retries. Without the
                # control plane no further lease can be granted, so the
                # stream is over from this worker's view — end it cleanly
                # for consumers rather than relaying an opaque error (the
                # common benign case is the dispatcher exiting the moment
                # the last ack lands, one consumer pull before EOS).
                log_warning(
                    "block service %s:%d lost its dispatcher, ending "
                    "stream: %s", self.address[0], self.address[1],
                    str(err).split("\n\nStack trace:")[0])
                with self._lock:
                    self._done = True
                    self._drained.set()
                return None
            if reply.get("retire"):
                # scale-down: the dispatcher drained and delisted this
                # worker. End the worker's stream and CUT the consumer
                # off (transport error, not clean EOS) — the fleet still
                # has work, and the consumer must fail over to a
                # surviving worker to find it.
                log_warning(
                    "block service %s:%d retired by the dispatcher "
                    "(scale-down)", self.address[0], self.address[1])
                self._hb_stop.set()
                with self._lock:
                    self._done = True
                    self._drained.set()
                raise OSError("data worker retired (scale-down)")
            if reply.get("dead") or (
                    reply.get("eof") and (jid < 0 or reply.get("all"))):
                # eof with "all": EVERY job's chunks are delivered-or-
                # acked — the worker's stream is over. dead: the
                # dispatcher declared this worker dead while it was
                # merely slow — it must not serve leases the table
                # already reassigned.
                with self._lock:
                    self._done = True
                    self._drained.set()
                return None
            if reply.get("eof"):
                # only THIS job is done; the worker keeps serving the
                # rest of the fleet. EOS for this consumer alone.
                with self._lock:
                    self._done_jids.add(jid)
                return None
            if reply.get("wait") or reply.get("busy"):
                # wait: chunks exist but are leased/delivered elsewhere
                # and may yet requeue. busy: the job's in-flight quota is
                # full — backpressure, not failure. Poll either way
                # (each poll heartbeats too).
                time.sleep(0.05)
                continue
            chunk = reply.get("chunk")
            if chunk is None:
                raise DMLCError(
                    "bad dispatcher lease reply: %r"
                    % (reply.get("error") or reply,))
            try:
                faultpoint("service.worker_crash")
            except InjectedFault as err:
                self._simulate_crash()
                raise OSError(str(err))
            try:
                arrays = self._parse_chunk(chunk)
            except Exception as exc:
                with self._lock:
                    self._done = True
                    detail = str(exc).split("\n\nStack trace:")[0]
                    self._error_msg = "%s: %s" % (type(exc).__name__, detail)
                    self._error = DMLCError(self._error_msg)
                    self._drained.set()
                raise self._error
            self._m_served.inc()
            return arrays

    def _next_block_arrays(self, jid: int = -1
                           ) -> Optional[Dict[str, np.ndarray]]:
        if self._dispatch is not None:
            return self._next_chunk_arrays(jid)
        # source mode has no job ledgers: a job-scoped request behaves
        # exactly like NEXT (the jid was consumed off the wire already)
        with self._lock:
            stashed = self._pop_pending_locked(-1)
            if stashed is not None:
                self._cond.notify()
                return stashed
            if self._error is not None:
                raise self._error
            if self._done:
                return None
            try:
                block = self._parser.next_block()
            except Exception as exc:  # parser failure ends the stream for
                # everyone — record it so wait() returns and every consumer
                # sees the real error, not a mid-frame close
                self._done = True
                # first line only: a DMLCError's str already embeds the
                # server-side stack trace, which must not ship on the wire
                detail = str(exc).split("\n\nStack trace:")[0]
                self._error_msg = "%s: %s" % (type(exc).__name__, detail)
                self._error = DMLCError(self._error_msg)
                self._drained.set()
                raise self._error
            if block is None:
                self._done = True
                self._drained.set()
                return None
            self._m_served.inc()
        out = {}
        for name in _BLOCK_FIELDS:
            arr = getattr(block, name)
            if arr is not None:
                out[name] = np.asarray(arr)
        # flow context crosses the wire as one extra named field; clients
        # that predate it simply don't .get() it (the format is
        # name-addressed), so the frame stays wire-compatible
        fid = getattr(block, "flow_id", 0)
        if fid:
            out["flow"] = np.asarray([fid], dtype=np.int64)
        return out

    def _stash_undelivered(self, arrays: Dict[str, np.ndarray]) -> None:
        """Requeue a block whose consumer died mid-send.

        Bounded (``DMLC_TPU_DATA_PENDING_CAP``): a full stash
        backpressures the stashing connection thread for up to
        ``_PENDING_WAIT_S`` waiting for a surviving consumer to drain it,
        then drops the block (metered as a drop, not a requeue) — a crash
        storm must not buffer the whole dataset in one worker's memory.
        Stashed per job (the frame's ``job`` tag; -1 in source mode) so a
        redelivery can only reach a consumer of the same tenant — the cap
        is fleet-wide across jobs."""
        job = arrays.get("job")
        jid = int(job[0]) if job is not None and len(job) else -1
        with self._cond:
            if self._pending_cap > 0:
                deadline = time.monotonic() + _PENDING_WAIT_S
                while (self._pending_total_locked() >= self._pending_cap
                       and not self._done):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                if self._pending_total_locked() >= self._pending_cap:
                    self._m_dropped.inc()
                    log_warning(
                        "block service pending stash full (cap %d); "
                        "dropping an undelivered block (%d rows)",
                        self._pending_cap, len(arrays["offset"]) - 1)
                    return
            self._pending.setdefault(jid, []).append(arrays)
            self._m_requeued.inc()

    def _send_response(self, conn: socket.socket, data: bytes) -> None:
        """sendall in ≤1 MiB slices, ticking _bytes_sent — so wait() can
        tell a slow-but-live transfer from a wedged one."""
        from dmlc_tpu_torch.resilience import faultpoint

        view = memoryview(data)
        while view:
            # an injected service.send fault (or a real send error) cuts
            # the consumer off MID-frame — the client-side truncated-frame
            # handling is what makes this recoverable
            faultpoint("service.send")
            sent = conn.send(view[: 1 << 20])
            with self._lock:
                self._bytes_sent += sent
            self._m_sent.inc(sent)
            view = view[sent:]

    def _serve_conn(self, conn: socket.socket) -> None:
        self._conns.append(conn)
        undelivered: Optional[Dict[str, np.ndarray]] = None
        unconfirmed = False  # a block frame was FULLY sent and no further
        # request (or close) has arrived to prove the consumer read it
        try:
            while True:
                (req,) = struct.unpack("<I", _recv_exact(conn, 4))
                unconfirmed = False  # another request: the consumer read
                # the previous frame (it asked for more on the same pipe)
                jid = -1
                if req == _REQ_NEXT_JOB:
                    (jid,) = struct.unpack("<I", _recv_exact(conn, 4))
                try:
                    if req == _REQ_CLOSE:
                        return
                    check(
                        req in (_REQ_NEXT, _REQ_NEXT_JOB),
                        "bad block service request %d", req
                    )
                    try:
                        undelivered = self._next_block_arrays(jid)
                    except DMLCError:  # parser failure (stream is over)
                        try:
                            _send_error(conn, self._error_msg or "parse "
                                        "failed")
                        except OSError:
                            pass
                        return
                    flow = (undelivered or {}).get("flow")
                    fid = int(flow[0]) if flow is not None and len(flow) \
                        else 0
                    if fid:
                        # the send slice joins the chunk's arrow chain so a
                        # merged trace shows which rank served which chunk
                        with obs.span("service_send", flow=fid):
                            obs.flow_step(fid, "chunk")
                            self._send_response(
                                conn, _pack_arrays(undelivered))
                    else:
                        self._send_response(
                            conn, _pack_arrays(undelivered or {}))
                    if undelivered is None:
                        return
                    undelivered = None
                    unconfirmed = True
                finally:
                    with self._lock:
                        self._responses_done += 1
                    self._m_responses.inc()
        except (DMLCError, OSError):
            # consumer went away; requeue any block it never received so the
            # stream stays lossless for the remaining consumers
            if undelivered is not None:
                self._stash_undelivered(undelivered)
            elif unconfirmed and self._dispatch is None:
                # the kernel took the whole frame but the consumer
                # vanished before asking for more: TCP cannot say whether
                # those rows landed, and legacy mode has no ack ledger to
                # requeue them safely (redelivery could duplicate) — so
                # the frame is counted possibly-lost, loudly. Dispatcher
                # mode closes this window: its recv/ack accounting
                # requeues any chunk the consumer never reported.
                self._m_unconfirmed.inc()
                log_warning(
                    "block service %s:%d: consumer vanished after a fully "
                    "sent block and before its next request — delivery "
                    "unconfirmed, rows may be lost (dispatcher mode "
                    "tracks and requeues these)",
                    self.address[0], self.address[1])
            return
        finally:
            try:
                self._conns.remove(conn)
            except ValueError:
                pass
            conn.close()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            # prune finished handler threads (failover clients re-dial
            # many times under fault storms; dead entries must not pile
            # up for the life of the epoch). Rebind, don't mutate: wait()
            # and close() iterate snapshots of this list concurrently.
            self._threads = [
                th for th in self._threads if th.is_alive()] + [t]

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the stream is exhausted and every consumer connection
        has finished.

        The library default (``timeout=None``) is UNBOUNDED: a healthy
        consumer may legitimately go silent between its last block and its
        closing request for however long one train step takes (minutes,
        for a long one), and the library must never cut such a
        consumer off — ``RemoteBlockParser`` would see a reset instead of
        clean EOF and a previously-clean job would fail.

        With ``timeout`` set, post-drain delivery gets grace windows of
        ``timeout`` seconds — the serve CLI's bounded-exit mode
        (``--grace``): windows extend as long as there is measurable
        progress — a response completed or a connection finished during the
        window. One full window with NO progress ends the wait, cutting off
        consumers that connected but never issued their final request (they
        would otherwise hold a recv forever) — and, by the same clock, any
        consumer that goes silent for longer than ``timeout`` after the
        drain; size ``timeout`` well above plausible per-step consumer
        work. Any stashed undelivered blocks still unclaimed are counted
        and logged as lost by :meth:`close`."""
        self._drained.wait()
        if timeout is None:
            # Unbounded join; the thread list can grow while we drain
            # (late-connecting consumers), so loop until a full pass finds
            # every thread finished.
            while True:
                for t in list(self._threads):
                    t.join()
                if not any(t.is_alive() for t in list(self._threads)):
                    return
        with self._lock:
            last_done, last_sent = self._responses_done, self._bytes_sent
        last_alive = len([t for t in list(self._threads) if t.is_alive()])
        while True:
            deadline = time.monotonic() + timeout
            for t in list(self._threads):
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            alive = len([t for t in list(self._threads) if t.is_alive()])
            if alive == 0:
                return
            with self._lock:
                done, sent = self._responses_done, self._bytes_sent
            if done > last_done or sent > last_sent or alive < last_alive:
                last_done, last_sent, last_alive = done, sent, alive
                continue  # delivery progressed during the window
            return  # a silent window: only stuck/idle connections remain

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
        # a close alone does not wake the thread blocked in accept: the
        # accept thread would outlive the service (one a closed worker),
        # so the listening socket is shut down first
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5)
        # closing live connections wakes threads blocked in recv — exit is
        # prompt instead of a join-timeout per idle consumer
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)
        # loss accounting AFTER the joins: a send-wedged thread stashes its
        # block only when the conn close above errors its sendall out.
        # Bounded acquire — a thread wedged INSIDE a parser pull holds the
        # lock, and close() must still reach parser.close() (the one call
        # that can unblock such a reader)
        if self._lock.acquire(timeout=1.0):
            try:
                npending = self._pending_total_locked()
                if npending:  # redelivery never happened — those rows
                    # left the epoch; surface the loss, don't exit "clean"
                    self._m_dropped.inc(npending)
                    rows = sum(len(a["offset"]) - 1
                               for stash in self._pending.values()
                               for a in stash)
                    log_warning(
                        "block service closing with %d undelivered "
                        "block(s) (%d rows never reached a consumer)",
                        npending, rows,
                    )
                    self._pending.clear()
                self._cond.notify_all()  # release any backpressured stash
            finally:
                self._lock.release()
        if self._parser is not None:
            self._parser.close()
        if self._dispatch is not None:
            self._dispatch.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RemoteBlockParser:
    """Parser-shaped consumer of a :class:`BlockService`.

    Drop-in for create_parser output: next_block()/iteration/bytes_read/
    close. before_first raises — the service is a one-pass stream (re-create
    service + parser per epoch, exactly like a fresh create_parser).

    Legacy mode (``dispatcher=False``) speaks to one service address.
    Mid-stream transport failures (``OSError``, truncated frames) are
    classified transient and retried through the shared ``RetryPolicy``
    by re-dialing the same address — the service's redelivery stash keeps
    the rows in the epoch. The server's explicit error frame stays FATAL
    (``DMLCError``): a parse failure must surface, not retry.

    Dispatcher mode (``dispatcher=True``, ``address`` = the dispatcher):
    a failover client. ``job=`` names the tenant ledger this consumer
    reads (default: the dispatcher's ``default`` job); every fetch is
    scoped to it, so another tenant's chunks can never land here and
    another tenant's EOF never ends this stream. Registration resumes
    the job's ack frontier: seqs already acked by a previous incarnation
    of this client seed the seen-set, so a crash-restart drops their
    redeliveries instead of double-consuming. Live workers are
    discovered via the dispatcher; a worker death mid-fetch rotates to
    the next live worker. Every
    received chunk is receipt-reported (``recv``) — the dispatcher
    REJECTS duplicates of a chunk someone else already holds, and the
    client silently drops rejected copies (exactly-once). Consumed
    chunks are acked: implicitly (the previous chunk is acked right
    before each new fetch — the ack frontier) or explicitly via
    :meth:`ack` once a consumer (DeviceFeed) takes ownership. Slow
    fetches can be hedged against a second worker
    (``DMLC_TPU_DATA_HEDGE_S`` > 0); the loser's chunk is never
    receipt-reported, so its lease expires and requeues — still
    exactly-once, at the cost of one wasted parse."""

    def __init__(
        self,
        address: Tuple[str, int],
        timeout: float = 60.0,
        dispatcher: bool = False,
        job: Optional[str] = None,
        device=None,
    ):
        from dmlc_tpu_torch.resilience import RetryPolicy, faultpoint

        check(job is None or dispatcher,
              "job= names a dispatcher ledger; it needs dispatcher=True")
        # the blocks are host arrays; the device is the one their feed and
        # learner use, checked here so a consumer meant for the card fails
        # at once on a host without one
        self.device = resolve_device(device)

        self._timeout = float(timeout)
        self.bytes_read = 0  # Parser API surface; obs mirror below
        self._m_read = obs.registry().counter(
            "dmlc_io_read_bytes_total", "payload bytes ingested by source",
            source="service")
        self._closed = False
        self._ended = False
        self._inflight = False  # a _REQ_NEXT is on the wire (close() must
        # drain its response so the server's send completes cleanly)
        self._explicit_ack = False
        self._unacked: List[int] = []
        # determinism audit (obs/audit.py): remember each accepted
        # chunk's content digest so a requeued redelivery can be checked
        # byte-for-byte against the first delivery before it is dropped.
        # The map exists only when the auditor is live — the off path
        # stays allocation-free.
        self._audit = audit.auditor()
        self._audit_digests: Optional[Dict[int, str]] = (
            {} if self._audit.enabled else None)
        self._m_redelivery = (obs.registry().counter(
            "dmlc_audit_redelivery_checked_total",
            "redelivered chunks digest-checked against first delivery")
            if self._audit.enabled else None)
        self._seen: set = set()  # every seq this client ever accepted —
        # a redelivery of rows we already hold (a lease the dispatcher
        # requeued while our dispatcher session was briefly down) is
        # dropped HERE; the server cannot tell that duplicate apart from
        # an idempotent recv retry, but we can
        if dispatcher:
            self.address = dispatcher_address(address)
            self._dispatch: Optional[DispatcherClient] = DispatcherClient(
                self.address, timeout=timeout)
            req = {"op": "client"}
            if job is not None:
                req["job"] = str(job)
            reply = self._dispatch.call(req)
            if not reply.get("ok", True):
                raise DMLCError(
                    "dispatcher refused client registration: %s"
                    % reply.get("error"))
            self._client_id = int(reply.get("client_id", -1))
            self._jid = int(reply.get("jid", 0))
            # the resumed ack frontier: chunks a previous incarnation of
            # this job's client already settled — drop their redeliveries
            self._seen.update(int(s) for s in reply.get("acked", []))
            self._sock: Optional[socket.socket] = None
            self._worker_pos = 0
            self._hedge_s = data_hedge_s()
            return
        self._dispatch = None
        self._client_id = -1
        self._jid = 0
        self._worker_pos = 0
        self._hedge_s = 0.0
        self.address = (str(address[0]), int(address[1]))

        def dial():
            faultpoint("service.connect")
            return socket.create_connection(address, timeout=timeout)

        # the service may still be binding when a disaggregated client
        # starts (tools/serve host races the training job): retry the
        # dial under the shared policy instead of failing the first race
        self._sock = RetryPolicy(max_attempts=5, base_s=0.2, cap_s=2.0).call(
            dial, "service.connect", display=f"block service {address}"
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    # ---- connection management -----------------------------------------

    def _dial_once(self, addr: Tuple[str, int]) -> socket.socket:
        from dmlc_tpu_torch.resilience import faultpoint

        faultpoint("service.connect")
        sock = socket.create_connection(addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _live_workers(self) -> List[Tuple[str, int]]:
        reply = self._dispatch.call({"op": "workers"})
        return [(str(w[0]), int(w[1])) for w in reply.get("workers", [])]

    def _dial_worker(self) -> socket.socket:
        """Rotate over the dispatcher's live-worker list starting at the
        current position. A worker the dispatcher has not yet declared
        dead may still refuse the dial — skip it; the next heartbeat gap
        will get it delisted."""
        workers = self._live_workers()
        if not workers:
            raise OSError("no live data workers registered")
        for i in range(len(workers)):
            pos = (self._worker_pos + i) % len(workers)
            try:
                sock = self._dial_once(workers[pos])
            except OSError:
                continue
            self._worker_pos = pos
            return sock
        raise OSError(
            "no reachable data worker among %d listed" % len(workers))

    def _ensure_sock(self) -> socket.socket:
        if self._sock is None:
            if self._dispatch is None:
                self._sock = self._dial_once(self.address)
            else:
                self._sock = self._dial_worker()
        return self._sock

    def _drop_sock(self, advance: bool = False) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if advance:
            self._worker_pos += 1  # failover: next fetch tries the NEXT
            # live worker first instead of re-hitting the dead one

    # ---- ack protocol ---------------------------------------------------

    def set_explicit_ack(self) -> None:
        """Switch off implicit acking BEFORE the first fetch: the consumer
        (DeviceFeed) owns the ack frontier and will call :meth:`ack` per
        consumed chunk. Must be called at construction time so early
        prefetched chunks are never implicitly acked."""
        self._explicit_ack = True

    def ack(self, seq: int) -> None:
        """Report chunk ``seq`` consumed (explicit-ack mode)."""
        self._explicit_ack = True
        if self._dispatch is None:
            return
        try:
            self._unacked.remove(int(seq))
        except ValueError:
            pass
        self._dispatch.call(
            {"op": "ack", "client": self._client_id, "job": self._jid,
             "seq": int(seq)})

    def _flush_acks(self) -> None:
        """Implicit ack frontier: everything received before this fetch
        was consumed by the caller (Parser pull semantics — the caller
        asked for the next block, so it is done with the previous)."""
        if self._dispatch is None or self._explicit_ack:
            return
        while self._unacked:
            sid = self._unacked[0]
            self._dispatch.call(
                {"op": "ack", "client": self._client_id, "job": self._jid,
                 "seq": sid})
            self._unacked.pop(0)

    # ---- fetch path ------------------------------------------------------

    def _hedged_fetch(self, workers: List[Tuple[str, int]]) -> Optional[
            Dict[str, np.ndarray]]:
        """Race a second worker after ``DMLC_TPU_DATA_HEDGE_S`` of
        silence. Each attempt dials a FRESH connection to a distinct
        worker; the winner's socket becomes the session socket. The
        loser's chunk (if its fetch completes) is never receipt-reported,
        so its lease expires and the dispatcher requeues it — wasted
        work, never duplicated rows."""
        from dmlc_tpu_torch.resilience import hedged_call

        picks = itertools.count(self._worker_pos)
        socks: List[socket.socket] = []

        def fetch():
            sock = self._dial_once(workers[next(picks) % len(workers)])
            socks.append(sock)
            try:
                sock.sendall(
                    struct.pack("<II", _REQ_NEXT_JOB, self._jid))
                return sock, _recv_arrays(sock)
            except Exception:
                try:
                    sock.close()
                except OSError:
                    pass
                raise

        self._drop_sock()
        self._inflight = True
        try:
            winner, arrays = hedged_call(
                fetch, self._hedge_s, site="service.fetch")
        finally:
            self._inflight = False
        self._sock = winner
        for sock in socks:
            if sock is not winner:
                try:
                    sock.close()
                except OSError:
                    pass
        return arrays

    def _fetch_arrays(self) -> Optional[Dict[str, np.ndarray]]:
        """One framed fetch with transport-failure failover.

        Transient = OSError only (truncated frames, resets, injected
        faults). The server's error frame raises DMLCError and is NOT
        retried — RetryPolicy re-raises fatal errors untouched, so the
        existing error-frame semantics hold."""
        from dmlc_tpu_torch.resilience import RetryPolicy, faultpoint

        def attempt():
            faultpoint("service.next")
            # flush the ack frontier BEFORE requesting more: by the time
            # the stream can end, every prior chunk is acked — which is
            # exactly what lets the dispatcher answer this fetch with EOF
            self._flush_acks()
            if (self._dispatch is not None and self._hedge_s > 0):
                workers = self._live_workers()
                if len(workers) > 1:
                    return self._hedged_fetch(workers)
            sock = self._ensure_sock()
            self._inflight = True
            try:
                if self._dispatch is not None:
                    # job-scoped pull: the worker leases from THIS job's
                    # ledger only, so tenants never cross streams
                    sock.sendall(
                        struct.pack("<II", _REQ_NEXT_JOB, self._jid))
                else:
                    sock.sendall(struct.pack("<I", _REQ_NEXT))
                return _recv_arrays(sock)
            except OSError:
                self._drop_sock(advance=True)
                raise
            finally:
                self._inflight = False

        policy = RetryPolicy(
            max_attempts=5, base_s=0.2, cap_s=2.0,
            classify=lambda err: isinstance(err, OSError))
        try:
            return policy.call(
                attempt, "service.next", display="block service fetch")
        except DMLCError:
            # error frame or retry give-up: the stream is over — a retried
            # next_block() must not mask the original error with a
            # broken-pipe on the closed connection
            self._ended = True
            raise

    @staticmethod
    def _content_digest(arrays: Dict[str, np.ndarray]) -> str:
        """Digest of a delivery's content fields — ``flow`` is excluded
        (the server mints a fresh flow id per send, so it legitimately
        differs between a first delivery and its requeued duplicate)."""
        return audit.digest_arrays(
            {k: v for k, v in arrays.items() if k != "flow"})

    def next_block(self) -> Optional[RowBlock]:
        if self._ended:
            return None
        while True:
            arrays = self._fetch_arrays()
            if arrays is None:
                self._ended = True
                try:
                    self._flush_acks()  # defensive: EOF implies all acked
                except (DMLCError, OSError):
                    pass
                return None
            seq = arrays.pop("seq", None)
            arrays.pop("job", None)  # per-job framing tag; this client
            # only ever pulls its own job, so the value is redundant here
            sid = int(seq[0]) if seq is not None and len(seq) else None
            if self._dispatch is not None and sid is not None:
                reply = self._dispatch.call(
                    {"op": "recv", "client": self._client_id,
                     "job": self._jid, "seq": sid})
                if reply.get("reject") or sid in self._seen:
                    # reject: another client already owns this chunk —
                    # the dispatcher's lease table is the exactly-once
                    # arbiter. seen: WE already hold (or consumed) these
                    # rows from an earlier delivery whose lease was
                    # requeued — the recv above re-marks the table
                    # delivered-to-us (stopping further reserves), and
                    # this duplicate copy is dropped; the original's ack
                    # settles the chunk.
                    if (self._audit_digests is not None
                            and sid in self._audit_digests):
                        # audit: the dropped duplicate must carry the
                        # same rows the first delivery did — a fork here
                        # means the requeue path rewrote content
                        self._m_redelivery.inc()
                        self._audit.check_redelivery(
                            sid, self._audit_digests[sid],
                            self._content_digest(arrays))
                    continue
                self._seen.add(sid)
                self._unacked.append(sid)
                if self._audit_digests is not None:
                    self._audit_digests[sid] = self._content_digest(arrays)
            nbytes = sum(a.nbytes for a in arrays.values())
            self.bytes_read += nbytes
            self._m_read.inc(nbytes)
            flow = arrays.pop("flow", None)
            fid = int(flow[0]) if flow is not None and len(flow) else 0
            block = RowBlock(
                offset=arrays["offset"],
                label=arrays["label"],
                index=arrays["index"],
                value=arrays.get("value"),
                weight=arrays.get("weight"),
                qid=arrays.get("qid"),
                field=arrays.get("field"),
            )
            if sid is not None:
                block.seq_id = sid
            if fid:
                # continue the server's flow on this rank: after the plane
                # merges traces, the arrow crosses from the serving rank's
                # service_send slice into this receive
                block.flow_id = fid
                with obs.span("service_recv", nbytes=nbytes, flow=fid):
                    obs.flow_step(fid, "chunk")
            return block

    def __iter__(self):
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block

    def before_first(self) -> None:
        raise DMLCError(
            "RemoteBlockParser is a one-pass stream; re-create the service "
            "and parser per epoch (Parser streaming semantics, data.h:298)"
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        sock = self._sock
        if sock is not None and self._inflight:
            # graceful close handshake: a _REQ_NEXT is on the wire — drain
            # its response so the server's send completes cleanly (no
            # OSError on its side, no spurious requeue of a block this
            # client never wanted). Dispatcher mode: the drained chunk is
            # never receipt-reported, so it requeues by lease expiry.
            try:
                sock.settimeout(min(5.0, self._timeout))
                _recv_arrays(sock)
            except (DMLCError, OSError):
                pass
            self._inflight = False
        try:
            if sock is not None and not self._ended:
                sock.sendall(struct.pack("<I", _REQ_CLOSE))
        except OSError:
            pass
        try:
            self._flush_acks()
        except (DMLCError, OSError):
            pass
        if self._dispatch is not None:
            self._dispatch.close()
        if sock is not None:
            sock.close()


def _reshards_counter():
    return obs.registry().counter(
        "dmlc_data_reshards_total",
        "input partitions recomputed after a membership change")


def reshard_split(split, rank: Optional[int] = None,
                  world: Optional[int] = None):
    """Recompute an ``InputSplit``'s partition for a new membership
    generation: after ``collective.reenter_elastic`` gives this worker a
    new rank and world, it calls this at its next epoch boundary so the
    parts tile the new world exactly once. ``reset_partition`` depends
    only on ``(rank, world)``: the same boundaries a static launch at that
    world reads, which keeps a shrink-then-regrow run bit-identical to a
    static one. ``rank``/``world`` default to the live collective's.
    Returns the split; each call counts in ``dmlc_data_reshards_total``."""
    if rank is None or world is None:
        from dmlc_tpu_torch import collective

        rank = collective.rank() if rank is None else rank
        world = collective.world_size() if world is None else world
    split.reset_partition(rank, world)
    _reshards_counter().inc()
    return split


def reshard_count() -> int:
    """Partitions recomputed by :func:`reshard_split` in this process:
    the value of ``dmlc_data_reshards_total`` (0 under
    ``DMLC_TPU_METRICS=0``)."""
    return int(_reshards_counter().value)

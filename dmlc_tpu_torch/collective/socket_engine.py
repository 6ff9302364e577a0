"""Socket collective engine: the worker side of the rabit protocol, the port
of ``dmlc_tpu/collective/socket_engine.py``. Wire-compatible with the
port's tracker (``dmlc_tpu_torch.tracker.rendezvous``), the JAX package's
and the reference's tracker.py, and with the JAX package's engine on the
peer links:

- handshake: connect to DMLC_TRACKER_URI:PORT, send magic/rank/world/
  jobid/cmd; receive rank, parent, world, tree neighbors, ring prev/next
  (tracker.py:58-104);
- peer-link brokering: listen on an ephemeral port, run the goodset/badset
  loop, dial the peers the tracker names, accept the rest
  (tracker.py:105-135);
- allreduce with rabit's topology split: the tree (reduce up in sorted
  child order, then broadcast down) below ``ring_threshold_bytes``, the
  ring (reduce-scatter + allgather) at or above it; both give bits that
  are identical on every rank and on every repeat;
- broadcast (an or-style allreduce), allgather (one broadcast a rank),
  barrier, tracker_print, abort, shutdown, and cmd='recover' re-entry
  with the old rank;
- cmd='elastic' re-entry into the tracker's next membership generation:
  the tracker sends the generation being joined before the standard
  frame (-1: refused, an evicted rank or a banned jobid), rank and world
  size come from the tracker, and :attr:`SocketEngine.generation` keeps
  the generation (1 for a static world) for heartbeat acks to be held
  against.

Host numpy arrays in, host numpy arrays out.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from dmlc_tpu_torch.resilience.faults import faultpoint
from dmlc_tpu_torch.resilience.retry import RetryPolicy
from dmlc_tpu_torch.tracker.rendezvous import MAGIC, FramedSocket
from dmlc_tpu_torch.utils.logging import DMLCError, check

# peer handshake tag (worker-to-worker links are the JAX package's protocol)
_PEER_MAGIC = 0xDC99

# broadcast metadata frame size in int64 slots: 1 (ndim) + up to 23 dims + 8
# (dtype code). A protocol constant: every rank sizes the frame identically.
_META_SLOTS = 32

_REDUCERS: Dict[str, Callable[[np.ndarray, np.ndarray], np.ndarray]] = {
    "sum": lambda a, b: a + b,
    "max": np.maximum,
    "min": np.minimum,
    "prod": lambda a, b: a * b,
    "bitor": np.bitwise_or,
}


class SocketEngine:
    """One worker's connection set + tree/ring collectives."""

    #: messages at or above this many bytes take the ring, shorter ones
    #: the tree: the split rabit makes, and the reason the tracker builds
    #: both topologies (tracker.py:193-225). The JAX package measured the
    #: crossover near 2 MB on loopback at world 4 (BASELINE.md). Set it on
    #: an instance to force a route.
    ring_threshold_bytes: int = 2 << 20

    def __init__(self, tracker_uri: Optional[str] = None,
                 tracker_port: Optional[int] = None, rank: int = -1,
                 world_size: int = -1, jobid: Optional[str] = None,
                 cmd: str = "start", connect_retry: int = 5):
        self.tracker_uri = tracker_uri or os.environ.get("DMLC_TRACKER_URI")
        self.tracker_port = int(
            tracker_port or os.environ.get("DMLC_TRACKER_PORT", 0))
        check(self.tracker_uri, "no tracker address (DMLC_TRACKER_URI unset)")
        check(cmd in ("start", "recover", "elastic"),
              "cmd must be start, recover or elastic, got %r", cmd)
        self.jobid = jobid or os.environ.get("DMLC_TASK_ID", "NULL")
        self.connect_retry = connect_retry
        self.rank = rank
        self.world_size = world_size
        self._aborted = False
        # the membership generation this engine entered: 1 for a static
        # world; cmd='elastic' takes the tracker's committed world_version
        self.generation = 1
        self.parent_rank = -1
        self.ring_prev = -1
        self.ring_next = -1
        self.tree_links: List[int] = []
        self.links: Dict[int, FramedSocket] = {}
        self._listener: Optional[socket.socket] = None
        self._connect(cmd, connect_retry)

    # ---- rendezvous ----------------------------------------------------
    def _dial_tracker(self, cmd: str) -> FramedSocket:
        sock = socket.create_connection(
            (self.tracker_uri, self.tracker_port), timeout=60)
        conn = FramedSocket(sock)
        conn.send_int(MAGIC)
        got = conn.recv_int()
        if got != MAGIC:
            conn.close()
            raise DMLCError(f"tracker handshake failed: magic {got:#x}")
        conn.send_int(self.rank)
        conn.send_int(self.world_size)
        conn.send_str(self.jobid)
        conn.send_str(cmd)
        return conn

    def _connect(self, cmd: str, retries: int) -> None:
        def dial():
            faultpoint("collective.connect")
            return self._dial_tracker(cmd)

        # connection errors only: a DMLCError here is a bad-magic handshake
        # (the wrong service), which dialing the same port cannot fix
        conn = RetryPolicy(
            max_attempts=max(1, retries), base_s=0.2, cap_s=2.0,
            classify=lambda err: isinstance(err, (ConnectionError, OSError)),
        ).call(dial, "collective.connect",
               display=f"tracker {self.tracker_uri}:{self.tracker_port}")
        try:
            if cmd == "elastic":
                # the admission ack before the standard frame: the
                # generation this entrant joins, or -1 for a refusal
                generation = conn.recv_int()
                if generation < 0:
                    raise DMLCError("tracker refused elastic re-entry "
                                    "(evicted or banned)")
                self.generation = generation
            self.rank = conn.recv_int()
            self.parent_rank = conn.recv_int()
            self.world_size = conn.recv_int()
            num_neighbors = conn.recv_int()
            self.tree_links = [conn.recv_int() for _ in range(num_neighbors)]
            self.ring_prev = conn.recv_int()
            self.ring_next = conn.recv_int()
            expected = set(self.tree_links)
            for r in (self.ring_prev, self.ring_next):
                if r not in (-1, self.rank):
                    expected.add(r)

            # listen for the peers that will dial us
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.bind(("", 0))
            self._listener.listen(16)
            my_port = self._listener.getsockname()[1]

            # goodset/badset loop (the worker half of tracker.py:105-135)
            conn.send_int(len(self.links))
            for r in self.links:
                conn.send_int(r)
            num_conn = conn.recv_int()
            num_accept = conn.recv_int()
            errors = 0
            for _ in range(num_conn):
                peer_host = conn.recv_str()
                peer_port = conn.recv_int()
                peer_rank = conn.recv_int()
                try:
                    self._dial_peer(peer_host, peer_port, peer_rank)
                except OSError:
                    errors += 1
            conn.send_int(errors)
            # the tracker would loop on a failed dial; stay strict
            check(not errors, "peer connect failed")
            conn.send_int(my_port)
            for _ in range(num_accept):
                fd, _addr = self._listener.accept()
                peer = FramedSocket(fd)
                got = peer.recv_int()
                check(got == _PEER_MAGIC, "bad peer magic")
                peer_rank = peer.recv_int()
                peer.send_int(_PEER_MAGIC)
                peer.send_int(self.rank)
                self.links[peer_rank] = peer
        finally:
            conn.close()
        missing = expected - set(self.links)
        check(not missing, "missing peer links: %s", missing)

    def _dial_peer(self, host: str, port: int, peer_rank: int) -> None:
        sock = socket.create_connection((host, port), timeout=60)
        peer = FramedSocket(sock)
        peer.send_int(_PEER_MAGIC)
        peer.send_int(self.rank)
        got = peer.recv_int()
        check(got == _PEER_MAGIC, "bad peer magic")
        got_rank = peer.recv_int()
        check(got_rank == peer_rank, "peer rank mismatch")
        self.links[peer_rank] = peer

    # ---- framed array transport ---------------------------------------
    @staticmethod
    def _send_array(conn: FramedSocket, arr: np.ndarray) -> None:
        faultpoint("collective.send")
        payload = arr.tobytes()
        conn.send_str(f"{arr.dtype.str}|{','.join(map(str, arr.shape))}")
        conn.send_int(len(payload))
        conn.sock.sendall(payload)

    @staticmethod
    def _recv_array(conn: FramedSocket) -> np.ndarray:
        faultpoint("collective.recv")
        header = conn.recv_str()
        # dtype.str may itself start with '|' (e.g. "|u1"), so split from
        # the right where the shape field is
        dtype_str, shape_str = header.rsplit("|", 1)
        shape = tuple(int(x) for x in shape_str.split(",") if x)
        data = conn.recv_all(conn.recv_int())
        return np.frombuffer(data, dtype=np.dtype(dtype_str)).reshape(
            shape).copy()

    # ---- collectives ----------------------------------------------------
    def _tree_children(self) -> List[int]:
        return sorted(r for r in self.tree_links if r != self.parent_rank)

    def allreduce(self, array: np.ndarray, op: str = "sum") -> np.ndarray:
        """Allreduce: the tree (reduce up in sorted child order, so the
        bits repeat) for short messages, the ring (reduce-scatter +
        allgather around the tracker's ring) for long ones. Every rank
        gets the same bits."""
        check(op in _REDUCERS, "unknown reduce op %s", op)
        check(not self._aborted,
              "engine aborted (pending recover); reinit before collectives")
        arr = np.asarray(array)
        if (arr.nbytes >= self.ring_threshold_bytes and self.world_size > 1
                and self.ring_prev not in (-1, self.rank)
                and self.ring_next not in (-1, self.rank)):
            return self._ring_allreduce(arr, op)
        return self._tree_allreduce(arr, op)

    def _tree_allreduce(self, array: np.ndarray, op: str) -> np.ndarray:
        reduce_fn = _REDUCERS[op]
        acc = np.asarray(array).copy()
        for child in self._tree_children():
            acc = reduce_fn(acc, self._recv_array(self.links[child]))
        if self.parent_rank != -1:
            self._send_array(self.links[self.parent_rank], acc)
            acc = self._recv_array(self.links[self.parent_rank])
        for child in self._tree_children():
            self._send_array(self.links[child], acc)
        return acc

    def _ring_step(self, send_id: int, send_chunk: np.ndarray):
        """One ring exchange: send (id, chunk) to ring_next while receiving
        (id, chunk) from ring_prev. The send runs on a helper thread, so
        two neighbors pushing large chunks at each other cannot deadlock
        on full TCP buffers (at world 2, prev and next are one socket:
        one concurrent send and one recv is safe)."""
        nxt = self.links[self.ring_next]
        prv = self.links[self.ring_prev]
        send_err: List[BaseException] = []

        def _send():
            try:
                nxt.send_int(send_id)
                self._send_array(nxt, send_chunk)
            except BaseException as err:  # re-raised on the caller thread
                send_err.append(err)

        sender = threading.Thread(target=_send)
        sender.start()
        try:
            recv_id = prv.recv_int()
            recv_chunk = self._recv_array(prv)
        finally:
            sender.join()
            if send_err:
                raise DMLCError(
                    f"ring send to rank {self.ring_next} failed: "
                    f"{send_err[0]}") from send_err[0]
        return recv_id, recv_chunk

    def _ring_allreduce(self, array: np.ndarray, op: str) -> np.ndarray:
        """Reduce-scatter + allgather around the tracker's ring. Chunk ids
        travel with the data: chunk r starts at rank r and gathers one
        addend a hop in the fixed ring order for n-1 hops, then the whole
        chunks circulate for n-1 more."""
        reduce_fn = _REDUCERS[op]
        n = self.world_size
        flat = array.reshape(-1)
        chunks = {i: c.copy() for i, c in enumerate(np.array_split(flat, n))}
        send_id = self.rank
        for _ in range(n - 1):
            recv_id, recv_chunk = self._ring_step(send_id, chunks[send_id])
            chunks[recv_id] = reduce_fn(chunks[recv_id], recv_chunk)
            send_id = recv_id
        # send_id now names this rank's fully reduced chunk
        for _ in range(n - 1):
            recv_id, recv_chunk = self._ring_step(send_id, chunks[send_id])
            chunks[recv_id] = recv_chunk
            send_id = recv_id
        out = np.concatenate([chunks[i] for i in range(n)])
        return out.reshape(array.shape).astype(array.dtype, copy=False)

    def broadcast(self, array: Optional[np.ndarray],
                  root: int = 0) -> np.ndarray:
        """Broadcast from any root, as an or-style allreduce of (mine if
        root, else zeros): the shape and dtype first, in a fixed-size
        metadata frame, then the payload's bytes."""
        if self.world_size == 1:
            check(array is not None, "broadcast root must supply data")
            return np.asarray(array)
        is_root = self.rank == root
        max_ndim = _META_SLOTS - 9
        meta_padded = np.zeros(_META_SLOTS, dtype=np.int64)
        if is_root:
            check(array is not None, "broadcast root must supply data")
            arr = np.asarray(array)
            check(arr.ndim <= max_ndim,
                  "broadcast supports at most %d dims, got %d", max_ndim,
                  arr.ndim)
            dtype_code = np.frombuffer(
                arr.dtype.str.ljust(8, " ").encode(),
                dtype=np.uint8).astype(np.int64)
            meta = np.concatenate([np.asarray([arr.ndim], dtype=np.int64),
                                   np.asarray(arr.shape, dtype=np.int64),
                                   dtype_code])
            meta_padded[:len(meta)] = meta
        meta_out = self.allreduce(meta_padded, op="sum")
        ndim = int(meta_out[0])
        shape = tuple(int(x) for x in meta_out[1:1 + ndim])
        dtype = np.dtype(bytes(meta_out[1 + ndim:1 + ndim + 8].astype(
            np.uint8)).decode().strip())
        if is_root:
            payload = np.asarray(array).astype(dtype).reshape(shape)
        else:
            payload = np.zeros(shape, dtype=dtype)
        out = self.allreduce(payload.reshape(-1).view(np.uint8), op="bitor")
        return out.view(dtype).reshape(shape)

    def allgather(self, array: np.ndarray) -> List[np.ndarray]:
        """Every rank's array, in rank order (rabit Allgather): one
        broadcast round a rank."""
        return [self.broadcast(array if r == self.rank else None, root=r)
                for r in range(self.world_size)]

    def barrier(self) -> None:
        self.allreduce(np.zeros(1, dtype=np.int32), op="sum")

    # ---- control messages ----------------------------------------------
    def tracker_print(self, msg: str) -> None:
        """Relay a message through the tracker's log (tracker.py:269-272)."""
        conn = self._dial_tracker("print")
        try:
            conn.send_str(msg)
        finally:
            conn.close()

    def abort(self) -> None:
        """Drop every peer link and the listener WITHOUT telling the
        tracker: the worker comes back with cmd='recover'. Peers blocked
        in a collective on this worker get a socket error and abort too,
        so the whole world re-enters rendezvous together."""
        self._aborted = True
        for peer in self.links.values():
            peer.close()
        self.links.clear()
        if self._listener is not None:
            self._listener.close()
            self._listener = None

    def shutdown(self) -> None:
        """Close the links and tell the tracker this rank is done."""
        self.abort()
        try:
            self._dial_tracker("shutdown").close()
        except (DMLCError, OSError):
            pass

"""Rabit-compatible rendezvous tracker for a fixed world, the port of the
fixed-world half of ``dmlc_tpu/tracker/rendezvous.py``
(tracker/dmlc_tracker/tracker.py).

The wire protocol is the reference's, so the port's workers can
rendezvous with the JAX package's tracker and its workers with this one:

- framed int/str TCP protocol with the 0xff99 magic handshake (ExSocket /
  SlaveEntry, tracker.py:24-78);
- a worker's handshake carries (rank, world_size, jobid, cmd); this
  tracker serves cmd ∈ {start, recover, print, shutdown} (tracker.py:66-69);
- rank assignment: a batch sorted by host once every expected worker is
  pending; a jobid→rank map keeps ranks stable across restarts, and
  'recover' re-enters with the old rank (tracker.py:254-320);
- link maps: a binary-heap tree and a ring that shares the tree's edges,
  relabeled so that ring order is 0, 1, 2, ... (tracker.py:165-252);
- peer-link brokering: the goodset/badset loop that tells each worker
  which listening peers to dial (assign_rank, tracker.py:80-135);
- the world size may be decided by the first worker (tracker.py:281-287).

Heartbeats, warm spares and ``join``, elastic generations, the PS
scheduler and the data dispatcher are not ported: a connection with any
other command is logged and closed.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from dmlc_tpu_torch.utils.logging import DMLCError

MAGIC = 0xFF99

logger = logging.getLogger("dmlc_tpu_torch.tracker")


class FramedSocket:
    """int/str framing over a TCP socket (ExSocket, tracker.py:24-47).

    Ints are native-endian i32 ('@i') to stay wire-compatible.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        # collectives exchange many small frames: without TCP_NODELAY,
        # Nagle coalescing and the peer's delayed ACK stall each ~40 ms
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # non-TCP transports (socketpairs)

    def recv_all(self, nbytes: int) -> bytes:
        parts = []
        nread = 0
        while nread < nbytes:
            chunk = self.sock.recv(min(nbytes - nread, 65536))
            if not chunk:
                raise ConnectionError("peer closed during recv")
            parts.append(chunk)
            nread += len(chunk)
        return b"".join(parts)

    def recv_int(self) -> int:
        return struct.unpack("@i", self.recv_all(4))[0]

    def send_int(self, value: int) -> None:
        self.sock.sendall(struct.pack("@i", value))

    def send_str(self, value: str) -> None:
        data = value.encode()
        self.send_int(len(data))
        self.sock.sendall(data)

    def recv_str(self) -> str:
        return self.recv_all(self.recv_int()).decode()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _resolve_ip(host: str) -> str:
    return socket.getaddrinfo(host, None)[0][4][0]


def get_host_ip(host_ip: Optional[str] = None) -> str:
    """Best-effort routable IP (tracker.py:389-407): an explicit address
    is returned as given; "auto"/"ip"/None resolve this host's name and,
    for a loopback answer, read the source address of a UDP socket
    connected towards a private address (no packet is sent); "dns" is the
    fully qualified name."""
    if host_ip in (None, "auto", "ip"):
        try:
            ip = socket.gethostbyname(socket.getfqdn())
        except socket.gaierror:
            ip = socket.gethostbyname(socket.gethostname())
        if ip.startswith("127."):
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                probe.connect(("10.255.255.255", 1))
                ip = probe.getsockname()[0]
            except OSError:
                ip = "127.0.0.1"
            finally:
                probe.close()
        return ip
    if host_ip == "dns":
        return socket.getfqdn()
    return host_ip


# ---------------------------------------------------------------------------
# Topology: tree + ring link maps
# ---------------------------------------------------------------------------


def tree_neighbors(rank: int, world: int) -> List[int]:
    """Binary-heap neighbors of ``rank`` (tracker.py:165-175)."""
    r1 = rank + 1
    out = []
    if r1 > 1:
        out.append(r1 // 2 - 1)
    if r1 * 2 - 1 < world:
        out.append(r1 * 2 - 1)
    if r1 * 2 < world:
        out.append(r1 * 2)
    return out


def build_tree(world: int) -> Tuple[Dict[int, List[int]], Dict[int, int]]:
    tree = {r: tree_neighbors(r, world) for r in range(world)}
    parent = {r: (r + 1) // 2 - 1 for r in range(world)}
    return tree, parent


def _dfs_share_ring(tree: Dict[int, List[int]], parent: Dict[int, int],
                    root: int) -> List[int]:
    """DFS order that shares edges with the tree (tracker.py:193-210)."""
    children = [v for v in tree[root] if v != parent[root]]
    order = [root]
    for i, child in enumerate(children):
        sub = _dfs_share_ring(tree, parent, child)
        if i == len(children) - 1:
            sub.reverse()
        order.extend(sub)
    return order


def build_ring(tree: Dict[int, List[int]],
               parent: Dict[int, int]) -> Dict[int, Tuple[int, int]]:
    order = _dfs_share_ring(tree, parent, 0)
    world = len(tree)
    return {order[pos]: (order[(pos - 1) % world], order[(pos + 1) % world])
            for pos in range(world)}


def build_link_maps(world: int):
    """Tree + ring, relabeled so ring order is 0,1,2,... (tracker.py:
    227-252). Returns (tree, parent, ring) keyed by the new ranks."""
    tree, parent = build_tree(world)
    ring = build_ring(tree, parent)
    relabel = {0: 0}
    cur = 0
    for i in range(world - 1):
        cur = ring[cur][1]
        relabel[cur] = i + 1
    tree2 = {relabel[k]: [relabel[x] for x in v] for k, v in tree.items()}
    parent2 = {relabel[k]: (relabel[v] if k != 0 else -1)
               for k, v in parent.items()}
    ring2 = {relabel[k]: (relabel[a], relabel[b])
             for k, (a, b) in ring.items()}
    return tree2, parent2, ring2


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------


class _Worker:
    """Tracker-side view of one connected worker (SlaveEntry)."""

    def __init__(self, sock: socket.socket, addr):
        self.conn = FramedSocket(sock)
        self.host = _resolve_ip(addr[0])
        magic = self.conn.recv_int()
        if magic != MAGIC:
            raise ConnectionError(f"invalid magic {magic:#x} from {self.host}")
        self.conn.send_int(MAGIC)
        self.rank = self.conn.recv_int()
        self.world_size = self.conn.recv_int()
        self.jobid = self.conn.recv_str()
        self.cmd = self.conn.recv_str()
        self.wait_accept = 0
        self.port: Optional[int] = None

    def decide_rank(self, job_map: Dict[str, int]) -> int:
        if self.rank >= 0:
            return self.rank
        if self.jobid != "NULL" and self.jobid in job_map:
            return job_map[self.jobid]
        return -1

    def assign_rank(self, rank: int, wait_conn: Dict[int, "_Worker"],
                    tree: Dict[int, List[int]], parent: Dict[int, int],
                    ring: Dict[int, Tuple[int, int]]) -> List[int]:
        """Send topology + broker peer connections (tracker.py:80-135)."""
        self.rank = rank
        neighbors: Set[int] = set(tree[rank])
        rprev, rnext = ring[rank]
        conn = self.conn
        conn.send_int(rank)
        conn.send_int(parent[rank])
        conn.send_int(len(tree))
        conn.send_int(len(neighbors))
        for r in neighbors:
            conn.send_int(r)
        for r in (rprev, rnext):
            if r not in (-1, rank):
                neighbors.add(r)
                conn.send_int(r)
            else:
                conn.send_int(-1)
        while True:
            ngood = conn.recv_int()
            goodset = {conn.recv_int() for _ in range(ngood)}
            if not goodset <= neighbors:
                raise ConnectionError(
                    f"rank {rank} reports links {sorted(goodset)} outside "
                    f"its neighbors {sorted(neighbors)}")
            badset = neighbors - goodset
            to_connect = [r for r in badset if r in wait_conn]
            conn.send_int(len(to_connect))
            conn.send_int(len(badset) - len(to_connect))
            for r in to_connect:
                conn.send_str(wait_conn[r].host)
                conn.send_int(wait_conn[r].port)
                conn.send_int(r)
            nerr = conn.recv_int()
            if nerr != 0:
                continue
            self.port = conn.recv_int()
            done = []
            for r in to_connect:
                wait_conn[r].wait_accept -= 1
                if wait_conn[r].wait_accept == 0:
                    done.append(r)
            for r in done:
                wait_conn.pop(r, None)
            self.wait_accept = len(badset) - len(to_connect)
            return done


class RabitTracker:
    """The rendezvous tracker of a fixed world (tracker.py:137-334): binds
    the first free port in [port, port_end) on ``host_ip``; ``start``
    serves rendezvous on a thread until every rank has sent 'shutdown'."""

    def __init__(self, host_ip: str, num_workers: int, port: int = 9091,
                 port_end: int = 9999):
        family = socket.getaddrinfo(host_ip, None)[0][0]
        sock = socket.socket(family, socket.SOCK_STREAM)
        bound = False
        for p in range(port, port_end):
            try:
                sock.bind((host_ip, p))
                self.port = p
                bound = True
                break
            except OSError as err:
                if err.errno in (48, 98):  # EADDRINUSE
                    continue
                sock.close()
                raise
        if not bound:
            sock.close()
            raise OSError(f"no free tracker port in [{port},{port_end})")
        sock.listen(256)
        self.sock = sock
        self.host_ip = host_ip
        self.num_workers = num_workers
        self.thread: Optional[threading.Thread] = None
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        logger.info("tracker listening on %s:%d", host_ip, self.port)

    def worker_envs(self) -> Dict[str, object]:
        """The env contract handed to workers (tracker.py:177-183)."""
        return {"DMLC_TRACKER_URI": self.host_ip,
                "DMLC_TRACKER_PORT": self.port}

    def _accept_loop(self, num_workers: int) -> None:
        shutdown: Dict[int, _Worker] = {}
        wait_conn: Dict[int, _Worker] = {}
        job_map: Dict[str, int] = {}
        pending: List[_Worker] = []
        todo: List[int] = []
        tree = parent = ring = None
        # accept with a timeout, so that close() ends the loop: a blocked
        # accept() does not return when another thread closes the socket
        self.sock.settimeout(0.25)
        while len(shutdown) < num_workers:
            try:
                fd, addr = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # close() pulled the listening socket: a stop
            fd.settimeout(None)  # protocol recvs block
            try:
                worker = _Worker(fd, addr)
            except (ConnectionError, OSError) as err:
                logger.warning("rejected connection: %s", err)
                fd.close()
                continue
            if worker.cmd == "print":
                try:
                    logger.info(worker.conn.recv_str().strip())
                except (ConnectionError, OSError) as err:
                    logger.warning("print from %s failed: %s", worker.host,
                                   err)
                worker.conn.close()
                continue
            if worker.cmd == "shutdown":
                if worker.rank < 0 or worker.rank in shutdown:
                    logger.warning("ignored shutdown from rank %d",
                                   worker.rank)
                    worker.conn.close()
                else:
                    shutdown[worker.rank] = worker
                    logger.debug("shutdown from rank %d", worker.rank)
                continue
            if worker.cmd not in ("start", "recover") or (
                    worker.cmd == "recover" and worker.rank < 0) or (
                    tree is None and worker.cmd != "start") or (
                    tree is not None
                    and worker.world_size not in (-1, num_workers)):
                logger.warning(
                    "rejected %r from %s (rank %d, world %d): this tracker "
                    "serves start, recover, print and shutdown of a world "
                    "of %s", worker.cmd, worker.host, worker.rank,
                    worker.world_size,
                    num_workers if tree is not None else "any size")
                worker.conn.close()
                continue
            if tree is None:
                if worker.world_size > 0:
                    num_workers = worker.world_size
                    self.num_workers = num_workers
                tree, parent, ring = build_link_maps(num_workers)
                todo = list(range(num_workers))
            try:
                rank = worker.decide_rank(job_map)
                if rank == -1:
                    if not todo:
                        raise ConnectionError("no unassigned ranks left")
                    pending.append(worker)
                    if len(pending) == len(todo):
                        pending.sort(key=lambda w: w.host)
                        for w in pending:
                            r = todo.pop(0)
                            if w.jobid != "NULL":
                                job_map[w.jobid] = r
                            w.assign_rank(r, wait_conn, tree, parent, ring)
                            if w.wait_accept > 0:
                                wait_conn[r] = w
                            logger.debug("assigned rank %d to %s", r, w.host)
                        pending = []
                else:
                    # a rank named by the worker is taken out of the batch
                    if rank in todo:
                        todo.remove(rank)
                    worker.assign_rank(rank, wait_conn, tree, parent, ring)
                    if worker.wait_accept > 0:
                        wait_conn[rank] = worker
                    logger.debug("%s from rank %d", worker.cmd, rank)
                if not todo and self.start_time is None:
                    logger.info("@tracker all %d workers started",
                                num_workers)
                    self.start_time = time.time()
            except (ConnectionError, OSError) as err:
                logger.warning("rendezvous with %s failed: %s", worker.host,
                               err)
                worker.conn.close()
        for worker in shutdown.values():
            worker.conn.close()
        self.end_time = time.time()
        if self.start_time is not None:
            logger.info("@tracker %.3f secs between node start and job "
                        "finish", self.end_time - self.start_time)

    def start(self, num_workers: Optional[int] = None) -> None:
        n = num_workers if num_workers is not None else self.num_workers
        self.thread = threading.Thread(
            target=self._accept_loop, args=(n,), daemon=True,
            name="rabit-tracker")
        self.thread.start()

    def join(self, tasks_alive: Optional[Callable[[], bool]] = None,
             grace_s: float = 5.0) -> None:
        """Wait for the job to finish. ``tasks_alive`` (from a launcher)
        says whether any worker process still runs: once none does while
        the tracker still waits for rendezvous, the job can never start,
        and this raises instead of hanging (the reference's join waits
        forever, tracker.py:329-331)."""
        deadline = None
        warned = False
        while self.thread is not None and self.thread.is_alive():
            self.thread.join(0.1)
            if tasks_alive is None or tasks_alive():
                deadline = None
                continue
            now = time.time()
            if deadline is None:
                deadline = now + grace_s  # let in-flight shutdowns drain
            elif now > deadline:
                if self.start_time is None:
                    raise DMLCError(
                        "all worker processes exited but the tracker is "
                        "still waiting for rendezvous: workers likely "
                        "crashed before connecting (check their logs)")
                if not warned:
                    logger.warning(
                        "launcher tasks exited but the job started and has "
                        "not sent all shutdowns; assuming detached workers "
                        "and waiting")
                    warned = True

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def close(self) -> None:
        """Close the listening socket; a running accept loop ends within
        its 0.25 s accept timeout."""
        self.sock.close()

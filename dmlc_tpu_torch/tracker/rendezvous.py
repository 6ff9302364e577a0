"""Rabit-compatible rendezvous tracker, the port of
``dmlc_tpu/tracker/rendezvous.py`` (tracker/dmlc_tracker/tracker.py).

The wire protocol is the reference's, so the port's workers can
rendezvous with the JAX package's tracker and its workers with this one:

- framed int/str TCP protocol with the 0xff99 magic handshake (ExSocket /
  SlaveEntry, tracker.py:24-78);
- a worker's handshake carries (rank, world_size, jobid, cmd); this
  tracker serves cmd ∈ {start, recover, print, shutdown} (tracker.py:
  66-69) and the JAX package's heartbeat, join and elastic;
- rank assignment: a batch sorted by host once every expected worker is
  pending; a jobid→rank map keeps ranks stable across restarts, and
  'recover' re-enters with the old rank (tracker.py:254-320);
- link maps: a binary-heap tree and a ring that shares the tree's edges,
  relabeled so that ring order is 0, 1, 2, ... (tracker.py:165-252);
- peer-link brokering: the goodset/badset loop that tells each worker
  which listening peers to dial (assign_rank, tracker.py:80-135);
- the world size may be decided by the first worker (tracker.py:281-287).

Heartbeats (``cmd='heartbeat'``, :func:`send_heartbeat`): a running
worker reports liveness and a one-line payload; the tracker records the
last time it heard each rank (:meth:`RabitTracker.heartbeats`) and warns
once a lapse about any rank silent for longer than
``DMLC_TPU_HEARTBEAT_GAP`` seconds (default 60). The ack is the target
``world_version``.

Elastic membership: the tracker owns ``world_version``, the generation of
the assigned world (1 after the first rendezvous). ``join``
(:func:`request_join`) parks a warm spare (world_size -1) or a grow
request (world_size 0) until a transition activates it; ``elastic``
re-enters the job into the next generation: the tracker acks the target
version (-1 = refused: an evicted rank or a banned jobid), batches
entrants over a quiescence window (``DMLC_TPU_ELASTIC_WINDOW_S``, default
3 s), calls parked spares up to backfill missing ranks, then rebuilds the
link maps for the new world and assigns fresh ranks. Running workers learn
that a transition is pending from the heartbeat ack. With
``DMLC_TPU_EVICT_AFTER_S`` > 0 a rank silent that long is evicted: its
re-entry is refused and the survivors drain into a smaller world.
Transitions are kept as membership events (``join``, ``evict``,
``rebuild``; :meth:`RabitTracker.membership`) and logged at the job's end.

The status plane of the JAX package (HTTP /workers, obs payloads, the
profile word) and the PS scheduler are not ported: a heartbeat's second
ack frame is always 0, "no profile request".
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from dmlc_tpu_torch.obs import flight
from dmlc_tpu_torch.resilience.faults import InjectedFault, faultpoint
from dmlc_tpu_torch.resilience.retry import RetryPolicy
from dmlc_tpu_torch.utils.logging import DMLCError

MAGIC = 0xFF99

logger = logging.getLogger("dmlc_tpu_torch.tracker")


class SpareUnused(DMLCError):
    """The job finished without this warm spare being activated: the
    clean "never needed" outcome, not a failure."""


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


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


class RabitTracker:
    """The rendezvous tracker (tracker.py:137-334): binds the first free
    port in [port, port_end) on ``host_ip``; ``start`` serves rendezvous,
    heartbeats and membership transitions on a thread until every rank
    of the current world has sent 'shutdown'."""

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
        # heartbeats: rank → last seen / last payload line; flagged ranks
        # were warned about in their current lapse
        self.heartbeat_gap = _env_float("DMLC_TPU_HEARTBEAT_GAP", 60.0)
        self._hb_lock = threading.Lock()
        self._last_seen: Dict[int, float] = {}
        self._hb_info: Dict[int, str] = {}
        self._hb_flagged: Set[int] = set()
        # elastic membership: world_version is the generation of the
        # assigned world; the target version (what heartbeat acks carry)
        # runs one ahead while a transition is pending. Evicted ranks and
        # their jobids (which survive the rank reshuffle at a commit) are
        # refused re-entry.
        self.world_version = 0
        self._target_version = 0
        self.elastic_window = max(
            0.1, _env_float("DMLC_TPU_ELASTIC_WINDOW_S", 3.0))
        self.evict_after = max(0.0, _env_float("DMLC_TPU_EVICT_AFTER_S", 0.0))
        self._evicted_ranks: Set[int] = set()
        self._evicted_jobids: Set[str] = set()
        self._rank_jobids: Dict[int, str] = {}
        self._events: List[Dict[str, object]] = []
        logger.info("tracker listening on %s:%d", host_ip, self.port)

    def worker_envs(self) -> Dict[str, object]:
        """The env contract handed to workers (tracker.py:177-183)."""
        return {"DMLC_TRACKER_URI": self.host_ip,
                "DMLC_TRACKER_PORT": self.port}

    # ---- heartbeats ------------------------------------------------------
    def _note_heartbeat(self, rank: int, payload: str) -> None:
        """Record a worker's liveness report and flag stragglers: any other
        rank whose last report is older than ``heartbeat_gap`` seconds is
        warned about once a lapse; a flagged rank that reports again is
        logged as recovered and re-armed."""
        now = time.time()
        with self._hb_lock:
            recovered = rank in self._hb_flagged
            self._last_seen[rank] = now
            self._hb_info[rank] = payload
            self._hb_flagged.discard(rank)
            stale = [(r, now - seen) for r, seen in self._last_seen.items()
                     if r != rank and now - seen > self.heartbeat_gap
                     and r not in self._hb_flagged]
            self._hb_flagged.update(r for r, _ in stale)
        if recovered:
            logger.info("straggler recovered: rank %d is heartbeating "
                        "again", rank)
        logger.debug("heartbeat from rank %d: %s", rank, payload)
        for r, gap in stale:
            logger.warning("straggler: rank %d last heartbeat %.1fs ago "
                           "(threshold %.1fs); last report: %s", r, gap,
                           self.heartbeat_gap, self._hb_info.get(r, ""))

    def heartbeats(self) -> Dict[int, Tuple[float, str]]:
        """rank → (last seen, unix seconds; last payload line)."""
        with self._hb_lock:
            return {r: (seen, self._hb_info.get(r, ""))
                    for r, seen in self._last_seen.items()}

    # ---- elastic membership ----------------------------------------------
    def _note_membership(self, kind: str, **fields) -> None:
        with self._hb_lock:
            self._events.append(dict(fields, kind=kind, at=time.time()))

    def membership(self) -> List[Dict[str, object]]:
        """The membership events so far, oldest first: dicts with ``kind``
        (``join``, ``evict``, ``rebuild``), ``at`` (unix seconds) and the
        kind's fields (``jobid``/``spare``, ``rank``,
        ``world_version``/``world``)."""
        with self._hb_lock:
            return [dict(e) for e in self._events]

    def _evict_scan(self, now: float) -> List[int]:
        """Eviction (``DMLC_TPU_EVICT_AFTER_S`` > 0): a rank whose last
        heartbeat is older than the threshold is marked evicted, its jobid
        banned from re-entry, and the target version bumped so survivors
        drain into a new generation. Returns the ranks evicted by this
        scan. A fired ``tracker.evict`` faultpoint defers that rank to the
        next scan."""
        if self.evict_after <= 0:
            return []
        with self._hb_lock:
            stale = [r for r, seen in self._last_seen.items()
                     if now - seen > self.evict_after
                     and r not in self._evicted_ranks]
        evicted = []
        for rank in sorted(stale):
            try:
                faultpoint("tracker.evict")
            except InjectedFault as err:
                logger.warning("eviction of rank %d deferred by injected "
                               "fault: %s", rank, err)
                continue
            self._evicted_ranks.add(rank)
            jobid = self._rank_jobids.get(rank)
            if jobid and jobid != "NULL":
                self._evicted_jobids.add(jobid)
            evicted.append(rank)
            logger.warning("evicting rank %d: no heartbeat for more than "
                           "%.1fs", rank, self.evict_after)
            self._note_membership("evict", rank=rank)
            flight.record_event("member.evict", rank=rank,
                                after_s=self.evict_after)
        if evicted and self._target_version == self.world_version:
            self._target_version = self.world_version + 1
        return evicted

    @staticmethod
    def _release_joiners(joiners: List[Tuple["_Worker", bool]]) -> None:
        """Close parked joiners' connections: a closed activation socket
        tells them the job finished without needing them (request_join
        raises SpareUnused)."""
        for w, _is_spare in joiners:
            w.conn.close()
        joiners.clear()

    def _accept_loop(self, num_workers: int) -> None:
        shutdown: Dict[int, _Worker] = {}
        wait_conn: Dict[int, _Worker] = {}
        job_map: Dict[str, int] = {}
        pending: List[_Worker] = []
        todo: List[int] = []
        tree = parent = ring = None
        # the open transition: parked joiners (spares and grow requests),
        # entrants into the next generation, the quiescence deadline, the
        # joiners woken into it, and whether the spare backfill ran
        joiners: List[Tuple[_Worker, bool]] = []
        entrants: List[_Worker] = []
        deadline: Optional[float] = None
        activated = 0
        backfilled = False

        def activate(w: _Worker) -> bool:
            """Wake a parked joiner into the pending generation."""
            try:
                w.conn.send_int(self._target_version)
                return True
            except OSError:
                w.conn.close()
                return False

        def call_up(want_spares: int) -> int:
            """Activate every parked grow joiner and up to ``want_spares``
            warm spares; dead connections are dropped."""
            nonlocal joiners
            woken = 0
            keep: List[Tuple[_Worker, bool]] = []
            for w, is_spare in joiners:
                if is_spare and want_spares <= 0:
                    keep.append((w, is_spare))
                    continue
                if activate(w):
                    woken += 1
                    if is_spare:
                        want_spares -= 1
            joiners = keep
            return woken

        def commit_generation() -> None:
            """Rebuild the world from the entrants: new link maps, a fresh
            batch rank assignment, the next world_version."""
            nonlocal tree, parent, ring, todo, wait_conn, job_map
            nonlocal entrants, deadline, activated, backfilled, num_workers
            new_world = len(entrants)
            self.world_version += 1
            self._target_version = self.world_version
            num_workers = self.num_workers = new_world
            tree, parent, ring = build_link_maps(new_world)
            todo = list(range(new_world))
            wait_conn = {}
            job_map = {}
            batch = sorted(entrants, key=lambda w: w.host)
            entrants = []
            deadline = None
            activated = 0
            backfilled = False
            self._rank_jobids = {}
            for w in batch:
                r = todo.pop(0)
                if w.jobid != "NULL":
                    job_map[w.jobid] = r
                self._rank_jobids[r] = w.jobid
                try:
                    w.assign_rank(r, wait_conn, tree, parent, ring)
                except (ConnectionError, OSError) as err:
                    logger.warning("elastic rendezvous with %s failed: %s",
                                   w.host, err)
                    w.conn.close()
                    continue
                if w.wait_accept > 0:
                    wait_conn[r] = w
            with self._hb_lock:
                # the ranks were reassigned: old last-seen entries would
                # flag phantom stragglers in the new generation
                self._last_seen.clear()
                self._hb_info.clear()
                self._hb_flagged.clear()
            self._evicted_ranks.clear()
            self._note_membership("rebuild", world_version=self.world_version,
                                  world=new_world)
            flight.record_event("member.rebuild",
                                world_version=self.world_version,
                                world=new_world)
            logger.info("@tracker generation %d committed: world=%d",
                        self.world_version, new_world)

        # the accept timeout is the tracker's clock: transition deadlines
        # and eviction scans run when no connection arrives, and close()
        # ends the loop (a blocked accept() does not return when another
        # thread closes the socket)
        self.sock.settimeout(0.25)
        while len(shutdown) < num_workers:
            try:
                fd, addr = self.sock.accept()
            except socket.timeout:
                fd = None
            except OSError:
                self._release_joiners(joiners)
                return  # close() pulled the listening socket: a stop
            worker = None
            if fd is not None:
                fd.settimeout(None)  # protocol recvs block
                try:
                    worker = _Worker(fd, addr)
                except (ConnectionError, OSError) as err:
                    logger.warning("rejected connection: %s", err)
                    fd.close()
            now = time.time()
            if worker is not None and worker.cmd == "print":
                try:
                    logger.info(worker.conn.recv_str().strip())
                except (ConnectionError, OSError) as err:
                    logger.warning("print from %s failed: %s", worker.host,
                                   err)
                worker.conn.close()
                worker = None
            elif worker is not None and worker.cmd == "heartbeat":
                try:
                    payload = worker.conn.recv_str()
                    # ack first: the target generation, then the JAX
                    # package's profile-request word (0: none), which a
                    # worker that does not ask for it never reads
                    worker.conn.send_int(self._target_version)
                    worker.conn.send_int(0)
                    self._note_heartbeat(worker.rank, payload)
                except (ConnectionError, OSError) as err:
                    logger.warning("heartbeat from %s failed: %s",
                                   worker.host, err)
                finally:
                    worker.conn.close()
                worker = None
            elif worker is not None and worker.cmd == "shutdown":
                if worker.rank < 0 or worker.rank in shutdown:
                    logger.warning("ignored shutdown from rank %d",
                                   worker.rank)
                    worker.conn.close()
                else:
                    shutdown[worker.rank] = worker
                    logger.debug("shutdown from rank %d", worker.rank)
                worker = None
            elif worker is not None and worker.cmd == "join":
                # a warm spare (world_size -1) or a grow request: ack with
                # the current generation and park until activated
                is_spare = worker.world_size < 0
                try:
                    worker.conn.send_int(self.world_version)
                except OSError:
                    worker.conn.close()
                else:
                    joiners.append((worker, is_spare))
                    if (not is_spare and tree is not None
                            and self._target_version == self.world_version):
                        # a grow request opens a transition; running
                        # workers learn of it from the heartbeat ack
                        self._target_version = self.world_version + 1
                    self._note_membership("join", jobid=worker.jobid,
                                          spare=is_spare)
                    flight.record_event("member.join", jobid=worker.jobid,
                                        spare=is_spare)
                    logger.info("parked %s joiner %s",
                                "spare" if is_spare else "grow",
                                worker.jobid)
                worker = None
            elif worker is not None and worker.cmd == "elastic":
                if (tree is None
                        or (worker.jobid != "NULL"
                            and worker.jobid in self._evicted_jobids)
                        or (worker.rank >= 0
                            and worker.rank in self._evicted_ranks)):
                    logger.info("refused elastic re-entry from %s (rank %d)",
                                worker.jobid, worker.rank)
                    try:
                        worker.conn.send_int(-1)
                    except OSError:
                        pass
                    worker.conn.close()
                else:
                    if self._target_version == self.world_version:
                        self._target_version = self.world_version + 1
                    if deadline is None:
                        backfilled = False
                        activated = call_up(0)  # grow joiners ride along
                    try:
                        worker.conn.send_int(self._target_version)
                    except OSError:
                        worker.conn.close()
                    else:
                        entrants.append(worker)
                        deadline = now + self.elastic_window
                worker = None
            elif worker is not None and (
                    worker.cmd not in ("start", "recover")
                    or (worker.cmd == "recover" and worker.rank < 0)
                    or (tree is None and worker.cmd != "start")
                    or (tree is not None
                        and worker.world_size not in (-1, num_workers))):
                logger.warning(
                    "rejected %r from %s (rank %d, world %d): this tracker "
                    "serves start, recover, print, shutdown, heartbeat, "
                    "join and elastic of a world of %s", worker.cmd,
                    worker.host, worker.rank, worker.world_size,
                    num_workers if tree is not None else "any size")
                worker.conn.close()
                worker = None
            if worker is not None:
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
                                self._rank_jobids[r] = w.jobid
                                w.assign_rank(r, wait_conn, tree, parent,
                                              ring)
                                if w.wait_accept > 0:
                                    wait_conn[r] = w
                                logger.debug("assigned rank %d to %s", r,
                                             w.host)
                            pending = []
                            if not todo:
                                self._first_generation(num_workers, joiners)
                    else:
                        # a rank named by the worker is taken out of the
                        # batch
                        if rank in todo:
                            todo.remove(rank)
                        worker.assign_rank(rank, wait_conn, tree, parent,
                                           ring)
                        self._rank_jobids[rank] = worker.jobid
                        if worker.wait_accept > 0:
                            wait_conn[rank] = worker
                        logger.debug("%s from rank %d", worker.cmd, rank)
                        if not todo and self.world_version == 0:
                            self._first_generation(num_workers, joiners)
                except (ConnectionError, OSError) as err:
                    logger.warning("rendezvous with %s failed: %s",
                                   worker.host, err)
                    worker.conn.close()
            # ---- elastic bookkeeping, on every pass (a connection or a tick)
            if tree is not None:
                self._evict_scan(now)
            if deadline is not None and entrants:
                expected = num_workers - len(self._evicted_ranks) + activated
                if len(entrants) >= expected:
                    commit_generation()
                elif now >= deadline:
                    if not backfilled:
                        backfilled = True
                        woken = call_up(expected - len(entrants))
                        activated += woken
                        if woken:
                            # give the backfill one window to arrive
                            deadline = now + self.elastic_window
                        else:
                            commit_generation()
                    else:
                        commit_generation()
        self._release_joiners(joiners)
        for worker in shutdown.values():
            worker.conn.close()
        self.end_time = time.time()
        if self.start_time is not None:
            logger.info("@tracker %.3f secs between node start and job "
                        "finish", self.end_time - self.start_time)
        logger.info("@tracker membership world_version=%d events=%s",
                    self.world_version,
                    ",".join(e["kind"] for e in self.membership()) or "-")

    def _first_generation(self, num_workers: int, joiners) -> None:
        """Every rank of the first world is assigned: generation 1."""
        logger.info("@tracker all %d workers started", num_workers)
        if self.start_time is None:
            self.start_time = time.time()
        self.world_version += 1
        self._target_version = self.world_version
        if any(not s for _, s in joiners):
            # a grow request parked before the first world formed
            self._target_version = self.world_version + 1
        self._note_membership("rebuild", world_version=self.world_version,
                              world=num_workers)
        flight.record_event("member.rebuild",
                            world_version=self.world_version,
                            world=num_workers)

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


def _handshake(conn: FramedSocket, rank: int, world_size: int, jobid: str,
               cmd: str) -> None:
    """The worker half of the magic handshake (tracker.py:58-66)."""
    conn.send_int(MAGIC)
    got = conn.recv_int()
    if got != MAGIC:
        raise DMLCError(f"invalid tracker magic {got:#x}")
    conn.send_int(rank)
    conn.send_int(world_size)
    conn.send_str(jobid)
    conn.send_str(cmd)


def send_heartbeat(tracker_uri: str, tracker_port: int, rank: int,
                   epoch: int = -1, metrics: str = "",
                   timeout: float = 10.0) -> int:
    """Worker-side heartbeat: one short connection with cmd="heartbeat"
    and a payload line ``epoch=N [metrics]``. Returns the tracker's ack,
    its target ``world_version``: larger than the engine's generation
    means a membership transition is pending (``collective.elastic_sync``).
    A tracker before generations acks 0, which means "no change"."""
    sock = socket.create_connection((tracker_uri, tracker_port),
                                    timeout=timeout)
    conn = FramedSocket(sock)
    try:
        _handshake(conn, rank, -1, "NULL", "heartbeat")
        payload = f"epoch={epoch}"
        if metrics:
            payload += " " + metrics
        conn.send_str(payload)
        return conn.recv_int()
    finally:
        conn.close()


def request_join(tracker_uri: str, tracker_port: int, jobid: str = "NULL",
                 spare: bool = True, timeout: Optional[float] = None) -> int:
    """Worker-side ``join``: register as a warm spare (or, with
    ``spare=False``, a grow request) and block until the tracker activates
    this process into a membership transition.

    Returns the generation to enter; the caller then dials again with
    ``cmd='elastic'`` (``SocketEngine(cmd="elastic")``). Raises
    :class:`SpareUnused` when the tracker closes the parked connection
    without activating it (the job finished). ``timeout`` bounds the wait
    (None: as long as the job runs). The dial passes the ``tracker.join``
    faultpoint and retries connection errors only: a bad-magic DMLCError
    is the wrong service."""

    def dial() -> FramedSocket:
        faultpoint("tracker.join")
        sock = socket.create_connection((tracker_uri, tracker_port),
                                        timeout=30)
        conn = FramedSocket(sock)
        try:
            _handshake(conn, -1, -1 if spare else 0, jobid, "join")
            conn.recv_int()  # registration ack: the current generation
        except BaseException:
            conn.close()
            raise
        return conn

    conn = RetryPolicy(
        max_attempts=5, base_s=0.2, cap_s=2.0,
        classify=lambda err: isinstance(err, (ConnectionError, OSError)),
    ).call(dial, "tracker.join",
           display=f"tracker {tracker_uri}:{tracker_port}")
    try:
        conn.sock.settimeout(timeout)
        try:
            generation = conn.recv_int()
        except ConnectionError as err:
            raise SpareUnused("tracker closed before activation: the job "
                              "finished without needing this joiner") \
                from err
    finally:
        conn.close()
    if generation < 0:
        raise DMLCError("tracker refused the join request")
    return generation


def submit_with_tracker(nworker: int, nserver: int,
                        fun_submit: Callable[[int, int, Dict[str, object]],
                                             None],
                        host_ip: str = "auto",
                        tasks_alive: Optional[Callable[[], bool]] = None
                        ) -> None:
    """Start a tracker, hand its env to the launcher callback, and wait
    for the job (tracker.py:410-433). ``tasks_alive`` lets a launcher
    that owns the worker processes report their liveness, so a crash
    before rendezvous ends the job instead of hanging it. Parameter
    servers (``nserver`` > 0) need the PS scheduler, which is not ported."""
    if nserver:
        raise DMLCError("parameter servers (-s > 0) need the PS scheduler, "
                        "which dmlc_tpu_torch does not port yet")
    envs: Dict[str, object] = {"DMLC_NUM_WORKER": nworker,
                               "DMLC_NUM_SERVER": nserver}
    tracker = RabitTracker(host_ip=get_host_ip(host_ip), num_workers=nworker)
    try:
        envs.update(tracker.worker_envs())
        tracker.start(nworker)
        if tracker.alive():
            fun_submit(nworker, nserver, envs)
        tracker.join(tasks_alive=tasks_alive)
    finally:
        tracker.close()

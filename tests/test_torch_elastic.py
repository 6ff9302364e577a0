"""Elastic membership of the port (``dmlc_tpu_torch.tracker.rendezvous``,
``collective.reenter_elastic`` / ``elastic_sync`` / ``broadcast_state``,
``data.reshard_split``) against the JAX package's, mirroring
``tests/test_elastic.py`` and ``tests/test_chaos.py``'s kill-one run:

- the link maps keep their invariants at every world, shrinking or
  growing, and equal the JAX package's;
- the eviction scan bans a silent rank, is off by default and is deferred
  by a fired ``tracker.evict`` faultpoint;
- a world of one grows to two through ``request_join``, the heartbeat ack
  and ``cmd='elastic'``, on either package's tracker with either
  package's workers (the wire is the same), and through the collective
  API's ``elastic_sync``;
- ``broadcast_state`` round-trips, refuses a foreign frame, is the
  identity at world 1, and its frame is the JAX package's byte for byte:
  a port engine decodes a JAX root's broadcast and the reverse;
- ``reshard_split`` covers a new world exactly once and equals a static
  partition (the JAX package's too);
- the port's launcher runs a 2-worker job that loses a worker, a warm
  spare backfills it, and the digests equal a static run's.

Trackers started here bind 21650-21699; the launcher jobs scan for a
free port and hand it to their workers in the env.
"""

import os
import pathlib
import re
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from dmlc_tpu import collective as ref_collective
from dmlc_tpu.collective.socket_engine import SocketEngine as RefEngine
from dmlc_tpu.io import create_input_split as ref_create_input_split
from dmlc_tpu.tracker import rendezvous as ref_rz
from dmlc_tpu_torch import collective, resilience
from dmlc_tpu_torch.collective import SocketEngine
from dmlc_tpu_torch.data import reshard_count, reshard_split
from dmlc_tpu_torch.io import MemoryStream, create_input_split, save_obj
from dmlc_tpu_torch.tracker import rendezvous as rz
from dmlc_tpu_torch.utils.logging import DMLCError

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORTS = (21650, 21700)


@pytest.fixture(autouse=True)
def _clean_state():
    resilience.reset()
    yield
    resilience.reset()


# ---------------------------------------------------------------------------
# link maps across changing world sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", range(1, 8))
def test_link_maps_invariants(world):
    tree, parent, ring = rz.build_link_maps(world)
    assert (tree, parent, ring) == ref_rz.build_link_maps(world)
    assert set(tree) == set(parent) == set(ring) == set(range(world))
    assert parent[0] == -1
    for r, nbrs in tree.items():
        for n in nbrs:
            assert r in tree[n], "tree edges must be symmetric"
    edges = {tuple(sorted((r, n))) for r, nbrs in tree.items() for n in nbrs}
    assert len(edges) == world - 1
    for r in range(world):
        assert ring[r] == ((r - 1) % world, (r + 1) % world)


def test_link_maps_shrink_grow_round_trips():
    first = {w: rz.build_link_maps(w) for w in (1, 4, 7)}
    for w in (7, 2, 5, 1, 6, 3):
        rz.build_link_maps(w)
    for w in (1, 4, 7):
        assert rz.build_link_maps(w) == first[w]


def test_tree_neighbors_match_parent_child():
    for world in range(1, 8):
        tree, parent = rz.build_tree(world)
        for r in range(world):
            assert set(tree[r]) == set(rz.tree_neighbors(r, world))
            if r != 0:
                assert parent[r] in tree[r]


# ---------------------------------------------------------------------------
# eviction
# ---------------------------------------------------------------------------


def _tracker(monkeypatch, num_workers=2, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return rz.RabitTracker("127.0.0.1", num_workers, port=PORTS[0],
                           port_end=PORTS[1])


def test_evict_scan_bans_stale_rank(monkeypatch):
    tracker = _tracker(monkeypatch, DMLC_TPU_EVICT_AFTER_S="0.5")
    try:
        tracker.world_version = tracker._target_version = 1
        now = time.time()
        with tracker._hb_lock:
            tracker._last_seen.update({0: now, 1: now - 5.0})
        tracker._rank_jobids = {0: "w0", 1: "w1"}
        assert tracker._evict_scan(now) == [1]
        assert 1 in tracker._evicted_ranks
        assert "w1" in tracker._evicted_jobids
        # the bumped target is what the heartbeat ack advertises
        assert tracker._target_version == 2
        assert tracker._evict_scan(now) == []
        assert tracker._target_version == 2
        assert [e["kind"] for e in tracker.membership()] == ["evict"]
        assert tracker.membership()[0]["rank"] == 1
    finally:
        tracker.close()


def test_evict_scan_off_by_default(monkeypatch):
    monkeypatch.delenv("DMLC_TPU_EVICT_AFTER_S", raising=False)
    tracker = _tracker(monkeypatch)
    try:
        assert tracker.evict_after == 0.0
        with tracker._hb_lock:
            tracker._last_seen[0] = time.time() - 1e6
        assert tracker._evict_scan(time.time()) == []
        assert not tracker._evicted_ranks
    finally:
        tracker.close()


def test_evict_deferred_by_injected_fault(monkeypatch):
    tracker = _tracker(monkeypatch, DMLC_TPU_EVICT_AFTER_S="0.5")
    try:
        tracker.world_version = tracker._target_version = 1
        now = time.time()
        with tracker._hb_lock:
            tracker._last_seen[1] = now - 5.0
        tracker._rank_jobids = {1: "w1"}
        resilience.configure("tracker.evict:nth=1")
        assert tracker._evict_scan(now) == []
        assert tracker._target_version == 1
        assert tracker._evict_scan(now) == [1]
        assert tracker._target_version == 2
    finally:
        tracker.close()


def test_heartbeats_flag_stragglers(monkeypatch):
    tracker = _tracker(monkeypatch, DMLC_TPU_HEARTBEAT_GAP="0.5")
    try:
        tracker._note_heartbeat(0, "epoch=1")
        with tracker._hb_lock:
            tracker._last_seen[0] -= 5.0
        tracker._note_heartbeat(1, "epoch=2")
        assert tracker._hb_flagged == {0}
        tracker._note_heartbeat(0, "epoch=3")  # recovered and re-armed
        assert tracker._hb_flagged == set()
        assert {r: p for r, (_, p) in tracker.heartbeats().items()} == \
            {0: "epoch=3", 1: "epoch=2"}
    finally:
        tracker.close()


# ---------------------------------------------------------------------------
# grow: join + heartbeat ack + elastic re-entry, across packages
# ---------------------------------------------------------------------------

PACKAGES = {
    "port": (rz, SocketEngine),
    "ref": (ref_rz, RefEngine),
}


@pytest.mark.parametrize("tracker_pkg,worker_pkg", [
    ("port", "port"), ("port", "ref"), ("ref", "port")])
def test_grow_world_one_to_two(monkeypatch, tracker_pkg, worker_pkg):
    """A world of one admits a grow joiner: the parked ``join`` bumps the
    heartbeat ack, the first ``elastic`` entrant calls the joiner up, and
    generation 2 is a working world of two."""
    monkeypatch.setenv("DMLC_TPU_ELASTIC_WINDOW_S", "0.5")
    tracker_mod, _ = PACKAGES[tracker_pkg]
    worker_rz, Engine = PACKAGES[worker_pkg]
    tracker = tracker_mod.RabitTracker("127.0.0.1", 1, port=PORTS[0],
                                       port_end=PORTS[1])
    tracker.start(1)
    uri, port = "127.0.0.1", tracker.port
    engines, errors = {}, []
    try:
        engines["a"] = Engine(tracker_uri=uri, tracker_port=port, jobid="a")
        assert engines["a"].world_size == 1
        assert engines["a"].generation == 1
        assert worker_rz.send_heartbeat(uri, port, 0) == 1

        def do_join():
            try:
                gen = worker_rz.request_join(uri, port, jobid="g",
                                             spare=False)
                assert gen >= 2
                engines["g"] = Engine(tracker_uri=uri, tracker_port=port,
                                      jobid="g", cmd="elastic")
            except Exception as err:  # surfaced in the main thread
                errors.append(err)

        tj = threading.Thread(target=do_join, daemon=True)
        tj.start()
        ack, deadline = 0, time.time() + 10
        while time.time() < deadline:
            ack = worker_rz.send_heartbeat(uri, port, 0)
            if ack > engines["a"].generation:
                break
            time.sleep(0.05)
        assert ack == 2

        def do_reenter():
            try:
                engines["a"].abort()
                engines["a2"] = Engine(tracker_uri=uri, tracker_port=port,
                                       jobid="a", cmd="elastic")
            except Exception as err:
                errors.append(err)

        ta = threading.Thread(target=do_reenter, daemon=True)
        ta.start()
        ta.join(30)
        tj.join(30)
        assert not ta.is_alive() and not tj.is_alive(), "rendezvous hung"
        assert not errors, errors
        a2, g = engines["a2"], engines["g"]
        assert {a2.rank, g.rank} == {0, 1}
        assert a2.world_size == g.world_size == 2
        assert a2.generation == g.generation == 2 == tracker.world_version
        results = {}
        ts = [threading.Thread(
            target=lambda k, e: results.setdefault(
                k, e.allreduce(np.ones(4, dtype=np.float64))),
            args=(k, e), daemon=True) for k, e in (("a", a2), ("g", g))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        np.testing.assert_array_equal(results["a"], np.full(4, 2.0))
        np.testing.assert_array_equal(results["g"], np.full(4, 2.0))
        a2.shutdown()
        g.shutdown()
        tracker.join()
        if tracker_pkg == "port":
            kinds = [e["kind"] for e in tracker.membership()]
            assert kinds == ["rebuild", "join", "rebuild"], kinds
    finally:
        tracker.close()


def test_elastic_sync_grows_through_the_collective_api(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_ELASTIC_WINDOW_S", "0.5")
    monkeypatch.setenv("DMLC_TPU_ELASTIC", "1")
    tracker = rz.RabitTracker("127.0.0.1", 1, port=PORTS[0],
                              port_end=PORTS[1])
    tracker.start(1)
    uri, port = "127.0.0.1", tracker.port
    joined, errors = {}, []
    collective.finalize()
    try:
        collective.init("socket", tracker_uri=uri, tracker_port=port,
                        jobid="a")
        assert not collective.elastic_sync()  # nothing pending
        assert collective.world_size() == 1

        def do_join():
            try:
                rz.request_join(uri, port, jobid="g", spare=False)
                joined["g"] = SocketEngine(tracker_uri=uri,
                                           tracker_port=port, jobid="g",
                                           cmd="elastic")
            except Exception as err:
                errors.append(err)

        tj = threading.Thread(target=do_join, daemon=True)
        tj.start()
        deadline = time.time() + 10
        while rz.send_heartbeat(uri, port, 0) < 2:
            assert time.time() < deadline
            time.sleep(0.05)
        assert collective.elastic_sync()
        tj.join(30)
        assert not tj.is_alive() and not errors, errors
        assert collective.world_size() == 2
        assert collective._engine.generation == 2
        g = joined["g"]
        # the joiner takes the model from rank 0, with its version
        collective.checkpoint({"w": np.arange(3.0)})
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "g", g.broadcast(None, root=collective.rank())), daemon=True)
        t.start()
        state = collective.broadcast_state({"w": np.arange(3.0)},
                                           root=collective.rank())
        t.join(30)
        version, got = collective._decode_state(out["g"])
        assert version == collective.version_number()
        np.testing.assert_array_equal(got["w"], state["w"])
        g.shutdown()
    finally:
        collective.finalize()
        tracker.join()
        tracker.close()


def test_elastic_reentry_of_an_evicted_jobid_is_refused(monkeypatch):
    tracker = rz.RabitTracker("127.0.0.1", 1, port=PORTS[0],
                              port_end=PORTS[1])
    tracker.start(1)
    try:
        eng = SocketEngine(tracker_uri="127.0.0.1",
                           tracker_port=tracker.port, jobid="x")
        tracker._evicted_jobids.add("x")
        eng.abort()
        with pytest.raises(DMLCError, match="refused elastic"):
            SocketEngine(tracker_uri="127.0.0.1", tracker_port=tracker.port,
                         jobid="x", cmd="elastic")
    finally:
        tracker.close()


def test_spare_is_released_when_the_job_finishes(monkeypatch):
    tracker = rz.RabitTracker("127.0.0.1", 1, port=PORTS[0],
                              port_end=PORTS[1])
    tracker.start(1)
    outcome = []

    def spare():
        try:
            rz.request_join("127.0.0.1", tracker.port, jobid="s")
        except rz.SpareUnused:
            outcome.append("unused")

    t = threading.Thread(target=spare, daemon=True)
    t.start()
    try:
        # the spare is parked before the job's only worker comes and goes:
        # on a loaded host its thread could otherwise dial a tracker that
        # had already finished
        deadline = time.time() + 30
        while (not any(e["kind"] == "join" for e in tracker.membership())
               and time.time() < deadline):
            time.sleep(0.01)
        eng = SocketEngine(tracker_uri="127.0.0.1",
                           tracker_port=tracker.port, jobid="w")
        eng.shutdown()
        tracker.join()
        t.join(10)
        assert outcome == ["unused"]
        assert [e["kind"] for e in tracker.membership()] == [
            "join", "rebuild"]
    finally:
        tracker.close()


def test_a_late_spare_is_refused_once_the_job_finishes(monkeypatch):
    """A spare that dials after the job's end is refused at once (the
    tracker closed its listening socket), and gives up after its dial's
    retries instead of waiting on a backlog that is never accepted."""
    tracker = rz.RabitTracker("127.0.0.1", 1, port=PORTS[0],
                              port_end=PORTS[1])
    tracker.start(1)
    try:
        eng = SocketEngine(tracker_uri="127.0.0.1",
                           tracker_port=tracker.port, jobid="w")
        eng.shutdown()
        tracker.join()
        t0 = time.monotonic()
        with pytest.raises(DMLCError, match="gave up"):
            rz.request_join("127.0.0.1", tracker.port, jobid="s",
                            timeout=60)
        assert time.monotonic() - t0 < 20
        assert [e["kind"] for e in tracker.membership()] == ["rebuild"]
    finally:
        tracker.close()


# ---------------------------------------------------------------------------
# broadcast_state's frame
# ---------------------------------------------------------------------------


def test_encode_decode_state_round_trip_and_equals_reference():
    state = {"w": np.arange(5, dtype=np.float64), "step": 3}
    blob = collective._encode_state(state, 7)
    assert blob.dtype == np.uint8
    assert blob.tobytes() == ref_collective._encode_state(state, 7).tobytes()
    version, out = collective._decode_state(blob)
    assert version == 7 and out["step"] == 3
    np.testing.assert_array_equal(out["w"], state["w"])
    # each package decodes the other's frame
    version, out = collective._decode_state(
        ref_collective._encode_state(state, 9))
    assert version == 9
    version, out = ref_collective._decode_state(blob)
    assert version == 7


def test_decode_state_rejects_foreign_blob():
    stream = MemoryStream()
    save_obj(stream, ("something_else", 1, None))
    with pytest.raises(DMLCError):
        collective._decode_state(np.frombuffer(stream.getvalue(),
                                               dtype=np.uint8))


def test_broadcast_state_world_one(monkeypatch):
    monkeypatch.setattr(collective, "_engine", collective._LocalEngine())
    assert collective.broadcast_state({"a": 1}) == {"a": 1}
    with pytest.raises(DMLCError):
        collective.broadcast_state(None)


def test_broadcast_state_between_packages(monkeypatch):
    """One port and one JAX-package engine: each package's
    ``broadcast_state`` from either root gives both ranks the root's state
    and version."""
    tracker = rz.RabitTracker("127.0.0.1", 2, port=PORTS[0],
                              port_end=PORTS[1])
    tracker.start(2)
    engines = {}
    kw = dict(tracker_uri="127.0.0.1", tracker_port=tracker.port)
    ts = [threading.Thread(target=lambda: engines.setdefault(
              "port", SocketEngine(jobid="p", **kw)), daemon=True),
          threading.Thread(target=lambda: engines.setdefault(
              "ref", RefEngine(jobid="r", **kw)), daemon=True)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    monkeypatch.setattr(collective, "_engine", engines["port"])
    monkeypatch.setattr(ref_collective, "_engine", engines["ref"])
    monkeypatch.setattr(collective, "_version", 0)
    monkeypatch.setattr(ref_collective, "_version", 0)
    try:
        for root_pkg, want in (("port", 5), ("ref", 8)):
            # the root's version travels with its state
            setattr(collective if root_pkg == "port" else ref_collective,
                    "_version", want)
            root = engines[root_pkg].rank
            state = {"w": np.arange(4.0) + root, "tag": root_pkg}
            out = {}
            calls = {"port": collective.broadcast_state,
                     "ref": ref_collective.broadcast_state}
            threads = [threading.Thread(target=lambda p: out.setdefault(
                p, calls[p](state if p == root_pkg else None, root=root)),
                args=(p,), daemon=True) for p in ("port", "ref")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            for p in ("port", "ref"):
                assert out[p]["tag"] == root_pkg
                np.testing.assert_array_equal(out[p]["w"], state["w"])
            assert collective._version == ref_collective._version == want
    finally:
        for eng in engines.values():
            eng.shutdown()
        tracker.join()
        tracker.close()


# ---------------------------------------------------------------------------
# resharding the input
# ---------------------------------------------------------------------------


def _records(split):
    out = []
    while True:
        rec = split.next_record()
        if rec is None:
            return out
        out.append(bytes(rec).decode())


def _lines(tmp_path, n=101):
    lines = [f"row-{i}" for i in range(n)]
    path = tmp_path / "data.txt"
    path.write_bytes(b"".join(s.encode() + b"\n" for s in lines))
    return str(path), lines


def test_reshard_split_covers_new_world_exactly_once(tmp_path):
    uri, lines = _lines(tmp_path)
    before = reshard_count()
    seen = []
    for rank in range(3):
        split = create_input_split(uri, 0, 2, "text")  # an old-world part
        assert reshard_split(split, rank=rank, world=3) is split
        seen.extend(_records(split))
        split.close()
    assert seen == lines
    assert reshard_count() - before == 3


def test_reshard_split_matches_static_partition(tmp_path):
    uri, _ = _lines(tmp_path)
    for rank, world in ((0, 3), (1, 3), (2, 3), (1, 2), (0, 1)):
        split = create_input_split(uri, 0, 2, "text")
        reshard_split(split, rank=rank, world=world)
        resharded = _records(split)
        split.close()
        static = create_input_split(uri, rank, world, "text")
        assert resharded == _records(static)
        static.close()
        ref = ref_create_input_split(uri, rank, world, "text",
                                     threaded=False)
        assert resharded == [r.decode() for r in ref.records()]
        ref.close()


def test_reshard_split_defaults_to_the_collective(tmp_path, monkeypatch):
    uri, lines = _lines(tmp_path)
    monkeypatch.setattr(collective, "_engine", collective._LocalEngine())
    split = create_input_split(uri, 1, 2, "text")
    reshard_split(split)
    assert _records(split) == lines
    split.close()


# ---------------------------------------------------------------------------
# kill one worker, a warm spare backfills: through the port's launcher
# ---------------------------------------------------------------------------

ELASTIC_WORKER = textwrap.dedent("""
    import hashlib, os, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    from dmlc_tpu_torch import collective as rabit
    from dmlc_tpu_torch import resilience

    CKPT = sys.argv[1]
    SIZE = int(sys.argv[2])
    EPOCHS = 4

    rabit.init()  # a warm spare parks here until called up (or exits 0)

    def round_fn():
        state = rabit.load_checkpoint(CKPT)
        if state is None:
            state = (0, np.zeros(SIZE))
        epoch, w = state
        if epoch >= EPOCHS:
            return state
        g = rabit.allreduce(
            np.full(SIZE, (rabit.rank() + 1) * (epoch + 1),
                    dtype=np.float64))
        w = w + g
        rabit.checkpoint((epoch + 1, w),
                         CKPT if rabit.rank() == 0 else None)
        return (epoch + 1, w)

    state = (0, None)
    while state[0] < EPOCHS:
        # rank r passes worker.step r + 1 times a round, so an nth=
        # schedule kills one chosen rank at a chosen round, OUTSIDE
        # run_with_recovery: a lost worker, not a recoverable error
        for _ in range(rabit.rank() + 1):
            try:
                resilience.faultpoint("worker.step")
            except resilience.InjectedFault:
                os._exit(1)
        state = rabit.run_with_recovery(round_fn, max_attempts=6)
    epoch, w = state
    digest = hashlib.sha256(np.ascontiguousarray(w).tobytes()).hexdigest()
    print(f"RESULT rank={{rabit.rank()}} digest={{digest}} "
          f"v={{rabit.version_number()}} gen={{rabit._engine.generation}}",
          flush=True)
    rabit.finalize()
""")


def _run_elastic_job(tmp_path, spares, faults, tag, elastic=True):
    script = tmp_path / "eworker.py"
    script.write_text(ELASTIC_WORKER.format(root=str(ROOT)))
    env = dict(os.environ, DMLC_TPU_ELASTIC_WINDOW_S="1.0")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    for k in ("DMLC_TPU_FAULTS", "DMLC_TPU_ELASTIC", "DMLC_TPU_SPARE",
              "DMLC_TRACKER_URI"):
        env.pop(k, None)
    if faults:
        env["DMLC_TPU_FAULTS"] = faults
    argv = [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit",
            "--cluster", "local", "-n", "2", "--max-attempts", "1",
            "--host-ip", "127.0.0.1"]
    if elastic:
        argv.append("--elastic")
    if spares:
        argv += ["--spares", str(spares)]
    argv += [sys.executable, str(script), str(tmp_path / f"{tag}.bin"), "8"]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=200,
                          env=env, cwd=ROOT)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    # the workers share the launcher's stdout, and an unbuffered print
    # writes its text and its newline apart: find the fields, not lines
    digests, gens = {}, {}
    for rank, digest, version, gen in re.findall(
            r"RESULT rank=(\d+) digest=([0-9a-f]{64}) v=(\d+) gen=(\d+)",
            out):
        digests[int(rank)] = digest
        gens[int(rank)] = int(gen)
        assert int(version) == 4, out
    assert sorted(digests) == [0, 1], out
    assert len(set(digests.values())) == 1, digests
    member = [ln for ln in out.splitlines() if "@tracker membership" in ln]
    return digests, gens, member[-1]


def test_kill_one_spare_backfills_bit_identical(tmp_path):
    static, gens, member = _run_elastic_job(tmp_path, 0, "", "static",
                                            elastic=False)
    assert set(gens.values()) == {1}
    assert "world_version=1" in member
    # rank 1 passes worker.step twice a round and rank 0 once: nth=8 kills
    # rank 1 before round 4, after three committed checkpoints
    chaos, gens, member = _run_elastic_job(
        tmp_path, 1, "worker.step:nth=8", "elastic")
    assert chaos == static
    assert set(gens.values()) == {2}
    assert "world_version=2" in member
    kinds = set(member.split("events=")[1].split(","))
    assert {"join", "rebuild"} <= kinds, member

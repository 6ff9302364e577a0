"""The port's collectives against the JAX package's (``dmlc_tpu.collective``,
``dmlc_tpu.tracker.rendezvous``) and numpy.

- The tracker's link maps (tree, parent, ring) equal the JAX package's at
  worlds 1-33.
- A world of four ``SocketEngine``s in threads, two of each package's,
  rendezvous on each package's tracker in turn, and on the JAX package's
  tracker with four of its own engines: every allreduce op, broadcast from
  each root and allgather, on the tree and (with the threshold set to 0 on
  each engine) the ring, give the same bits on every rank and in every
  world, and the ops repeat their bits.
- ``DeviceEngine`` and ``bucketed_all_reduce`` over gloo, one process a
  rank at worlds 2 and 4: integer-valued data, so every sum and product
  is exact in any order and the results must equal numpy's bit for bit.

Trackers here bind ports 21000-21199; no other test file uses them.
"""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

from dmlc_tpu.collective.socket_engine import SocketEngine as RefEngine
from dmlc_tpu.tracker import rendezvous as ref_rendezvous
from dmlc_tpu_torch.collective import SocketEngine
from dmlc_tpu_torch.tracker import rendezvous

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORTS = {"port": (21000, 21050), "ref": (21050, 21100),
         "ref_only": (21100, 21150)}


@pytest.mark.parametrize("world", range(1, 34))
def test_link_maps_match_reference(world):
    assert rendezvous.build_link_maps(world) == \
        ref_rendezvous.build_link_maps(world)
    for r in range(world):
        assert rendezvous.tree_neighbors(r, world) == \
            ref_rendezvous.tree_neighbors(r, world)


# ---------------------------------------------------------------------------
# socket engines: two of each package's in one world of four
# ---------------------------------------------------------------------------

WORLD = 4
REDUCE_OPS = ("sum", "max", "min", "prod", "bitor")


def _rank_input(rank, op):
    rng = np.random.RandomState(100 + rank)
    if op == "bitor":
        return rng.randint(0, 1 << 30, 1000).astype(np.int32)
    if op == "prod":  # near 1, so four factors stay normal
        return (1 + 0.01 * rng.randn(1000)).astype(np.float32)
    return rng.randn(1000).astype(np.float32)


def _ops(engine, rank):
    """What every rank runs, in one order: {name: result}."""
    out = {}
    for route, threshold in (("tree", None), ("ring", 0)):
        if threshold is not None:
            engine.ring_threshold_bytes = threshold
        for op in REDUCE_OPS:
            x = _rank_input(rank, op)
            out[f"{route}/{op}"] = engine.allreduce(x, op)
            out[f"{route}/{op}/again"] = engine.allreduce(x, op)
        for root in range(WORLD):
            payload = np.arange(6, dtype=np.float64).reshape(2, 3) + root
            out[f"{route}/broadcast{root}"] = engine.broadcast(
                payload if rank == root else None, root)
        gathered = engine.allgather(
            np.full(rank + 1, rank, dtype=np.int64))
        out[f"{route}/allgather"] = np.concatenate(gathered)
        engine.barrier()
    return out


def _run_world(tracker_cls, ports, engine_classes):
    tracker = tracker_cls("127.0.0.1", WORLD, port=ports[0],
                          port_end=ports[1])
    tracker.start()
    results, errors = {}, []

    def run(rank):
        try:
            engine = engine_classes[rank](
                tracker_uri="127.0.0.1", tracker_port=tracker.port,
                rank=rank, world_size=WORLD)
            try:
                results[rank] = (_ops(engine, rank), engine.world_size)
            finally:
                engine.shutdown()
        except Exception as err:  # noqa: BLE001 (re-raised in the test)
            errors.append(err)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(WORLD)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        tracker.thread.join(10)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        assert not tracker.alive(), "the tracker still waits for shutdowns"
    finally:
        tracker.close()
    assert not errors, errors
    return results


@pytest.fixture(scope="module")
def socket_worlds():
    mixed = [RefEngine, SocketEngine, RefEngine, SocketEngine]
    return {
        "port": _run_world(rendezvous.RabitTracker, PORTS["port"], mixed),
        "ref": _run_world(ref_rendezvous.RabitTracker, PORTS["ref"], mixed),
        "ref_only": _run_world(ref_rendezvous.RabitTracker,
                               PORTS["ref_only"], [RefEngine] * WORLD),
    }


SOCKET_CASES = [f"{route}/{op}" for route in ("tree", "ring")
                for op in REDUCE_OPS
                + tuple(f"broadcast{r}" for r in range(WORLD))
                + ("allgather",)]


@pytest.mark.parametrize("tracker", ["port", "ref"])
@pytest.mark.parametrize("case", SOCKET_CASES)
def test_mixed_socket_world_bit_identical(socket_worlds, tracker, case):
    """Every rank of the mixed world gets the all-reference world's bits,
    and a repeated allreduce repeats them."""
    world = socket_worlds[tracker]
    want = socket_worlds["ref_only"][0][0][case]
    for rank in range(WORLD):
        got, size = world[rank]
        assert size == WORLD
        assert got[case].dtype == want.dtype and \
            got[case].tobytes() == want.tobytes(), (rank, case)
        if case + "/again" in got:
            assert got[case + "/again"].tobytes() == want.tobytes()


@pytest.mark.parametrize("op", REDUCE_OPS)
def test_socket_results_against_numpy(socket_worlds, op):
    """The tree and the ring against numpy's fold of the four inputs:
    equal for max, min and bitor; sum and prod within a few f32 ulps (two
    addition orders: the tree's and the ring's)."""
    inputs = [_rank_input(r, op) for r in range(WORLD)]
    fold = {"sum": np.add, "max": np.maximum, "min": np.minimum,
            "prod": np.multiply, "bitor": np.bitwise_or}[op]
    want = inputs[0]
    for x in inputs[1:]:
        want = fold(want, x)
    for route in ("tree", "ring"):
        got = socket_worlds["port"][1][0][f"{route}/{op}"]
        if op in ("sum", "prod"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert np.array_equal(got, want), route
    broadcast = socket_worlds["port"][3][0]["tree/broadcast2"]
    assert np.array_equal(broadcast, np.arange(6.0).reshape(2, 3) + 2)
    assert np.array_equal(socket_worlds["port"][2][0]["ring/allgather"],
                          np.repeat(np.arange(WORLD), np.arange(1, 5)))


# ---------------------------------------------------------------------------
# DeviceEngine and bucketed_all_reduce over gloo, one process a rank
# ---------------------------------------------------------------------------

_WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from dmlc_tpu_torch.collective import DeviceEngine, bucketed_all_reduce
from dmlc_tpu_torch.parallel import distributed
from dmlc_tpu_torch.utils import DMLCError


def rank_input(rank, dtype):
    """Integer-valued, small: exact sums and products in any order."""
    rng = np.random.RandomState(7 + rank)
    return rng.randint(-3, 4, (3, 5)).astype(dtype)


def main(rank, world, tmp):
    torch.set_num_threads(1)
    dev = distributed.initialize(f"file://{tmp}/pg", world, rank,
                                 device="cpu")
    assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
    engine = DeviceEngine()
    out = {"rank": np.array(engine.rank), "world": np.array(engine.world_size)}
    for op in ("sum", "max", "min", "prod"):
        for dtype in ("float32", "float64", "int32", "int64"):
            out[f"{op}/{dtype}"] = engine.allreduce(rank_input(rank, dtype),
                                                    op)
    for dtype in ("int32", "uint8"):
        x = np.random.RandomState(rank).randint(0, 255, 16).astype(dtype)
        out[f"bitor/{dtype}"] = engine.allreduce(x, "bitor")
    for root in range(world):
        payload = np.arange(12, dtype=np.float32).reshape(3, 4) * (root + 1)
        out[f"broadcast{root}"] = engine.broadcast(
            payload if rank == root else None, root)
    try:
        engine.broadcast(np.array(["bad"]) if rank == 0 else None, 0)
    except TypeError as err:
        out["broadcast_bad_root"] = np.array(str(err))
    out["allgather"] = np.concatenate(
        engine.allgather(np.full(rank + 1, rank, dtype=np.int64)))
    engine.barrier()
    # bucketed_all_reduce: one all_reduce per dtype, dtypes kept, inputs
    # untouched
    calls = []
    real = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        calls.append(tensor.dtype)
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counting
    leaves = [torch.tensor(rank_input(rank, "float32")),
              torch.tensor(float(rank + 1)),
              torch.tensor(rank_input(rank, "float64")[0]),
              torch.tensor(rank_input(rank, "int64")[:, 0]),
              torch.tensor(2.0 * rank, dtype=torch.float32)]
    before = [t.clone() for t in leaves]
    reduced = bucketed_all_reduce(leaves, group=None)
    dist.all_reduce = real
    out["bucket_calls"] = np.array([str(d) for d in calls])
    assert all(torch.equal(a, b) for a, b in zip(leaves, before))
    for i, t in enumerate(reduced):
        out[f"bucket/{i}"] = t.numpy()
        out[f"bucket/{i}/dtype"] = np.array(str(t.dtype))
    engine.abort()
    try:
        engine.allreduce(np.ones(2, np.float32))
    except DMLCError as err:
        out["after_abort"] = np.array(str(err).splitlines()[0])
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
'''


def _spawn(worker, world, tmp, extra=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, "-c", worker, str(r), str(world), str(tmp),
         *extra], cwd=tmp, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs, timeout=120):
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log


@pytest.fixture(scope="module")
def device_worlds(tmp_path_factory):
    tmps = {w: tmp_path_factory.mktemp(f"dev{w}") for w in (2, 4)}
    procs = [p for w in tmps for p in _spawn(_WORKER, w, tmps[w])]
    _wait(procs)
    return {w: [dict(np.load(tmps[w] / f"rank{r}.npz"))
                for r in range(w)] for w in tmps}


def _device_input(rank, dtype):
    return np.random.RandomState(7 + rank).randint(-3, 4, (3, 5)).astype(
        dtype)


DEVICE_CASES = ([f"{op}/{dt}" for op in ("sum", "max", "min", "prod")
                 for dt in ("float32", "float64", "int32", "int64")]
                + ["bitor/int32", "bitor/uint8"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", DEVICE_CASES)
def test_device_engine_allreduce_matches_numpy(device_worlds, world, case):
    op, dtype = case.split("/")
    if op == "bitor":
        inputs = [np.random.RandomState(r).randint(0, 255, 16).astype(dtype)
                  for r in range(world)]
    else:
        inputs = [_device_input(r, dtype) for r in range(world)]
    fold = {"sum": np.add, "max": np.maximum, "min": np.minimum,
            "prod": np.multiply, "bitor": np.bitwise_or}[op]
    want = inputs[0]
    for x in inputs[1:]:
        want = fold(want, x)
    for rank, got in enumerate(device_worlds[world]):
        assert int(got["rank"]) == rank and int(got["world"]) == world
        assert got[case].dtype == want.dtype
        assert np.array_equal(got[case], want), (rank, case)


@pytest.mark.parametrize("world", [2, 4])
def test_device_engine_broadcast_allgather_abort(device_worlds, world):
    for got in device_worlds[world]:
        for root in range(world):
            want = np.arange(12, dtype=np.float32).reshape(3, 4) * (root + 1)
            assert got[f"broadcast{root}"].dtype == np.float32
            assert np.array_equal(got[f"broadcast{root}"], want)
        # a root's invalid input raises the same TypeError on every rank
        assert "device collectives take" in str(got["broadcast_bad_root"]) \
            or "invalid" in str(got["broadcast_bad_root"])
        assert np.array_equal(got["allgather"],
                              np.repeat(np.arange(world),
                                        np.arange(1, world + 1)))
        assert "aborted" in str(got["after_abort"])


@pytest.mark.parametrize("world", [2, 4])
def test_bucketed_all_reduce_one_call_per_dtype(device_worlds, world):
    ranks = device_worlds[world]
    leaves = [[_device_input(r, "float32"), np.float32(r + 1),
               _device_input(r, "float64")[0],
               _device_input(r, "int64")[:, 0],
               np.float32(2.0 * r)] for r in range(world)]
    for got in ranks:
        # f32 leaves share one bucket, then f64, then int64
        assert list(got["bucket_calls"]) == ["torch.float32",
                                             "torch.float64", "torch.int64"]
        for i in range(5):
            want = sum(np.asarray(leaf[i]) for leaf in leaves)
            assert got[f"bucket/{i}"].shape == np.shape(leaves[0][i])
            assert np.array_equal(got[f"bucket/{i}"], want), i
        assert [str(got[f"bucket/{i}/dtype"]) for i in range(5)] == [
            "torch.float32", "torch.float32", "torch.float64",
            "torch.int64", "torch.float32"]


# ---------------------------------------------------------------------------
# the engine selection, the bootstrap's env contract, the tracker's guards
# ---------------------------------------------------------------------------


def test_local_engine_and_auto_selection(monkeypatch):
    from dmlc_tpu_torch import collective
    from dmlc_tpu_torch.utils import DMLCError

    monkeypatch.delenv("DMLC_TRACKER_URI", raising=False)
    collective.finalize()
    try:
        assert collective.engine_kind() == "local"
        assert (collective.rank(), collective.world_size()) == (0, 1)
        x = np.arange(4, dtype=np.float32)
        assert np.array_equal(collective.allreduce(x), x)
        assert np.array_equal(collective.broadcast(x), x)
        assert [a.tolist() for a in collective.allgather(x)] == [x.tolist()]
        collective.barrier()
        collective.tracker_print("local engine")
    finally:
        collective.finalize()
    with pytest.raises(DMLCError, match="unknown collective engine"):
        collective.init("mpi")
    with pytest.raises(DMLCError, match="DMLC_TRACKER_URI"):
        collective.init("socket")
    collective.finalize()


def test_bootstrap_env_contract(monkeypatch):
    from dmlc_tpu_torch.parallel import distributed
    from dmlc_tpu_torch.utils import DMLCError

    for key in ("DMLC_TPU_COORDINATOR", "DMLC_TPU_NUM_PROC",
                "DMLC_TPU_PROC_ID", "DMLC_TASK_ID", "DMLC_NUM_WORKER"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.env_process_info() is None
    assert not distributed.multiprocess_env()
    assert distributed.initialize_from_env() is False
    assert (distributed.process_index(), distributed.process_count()) == \
        (0, 1)
    monkeypatch.setenv("DMLC_TASK_ID", "3")
    monkeypatch.setenv("DMLC_NUM_WORKER", "5")
    assert (distributed.process_index(), distributed.process_count()) == \
        (3, 5)
    monkeypatch.setenv("DMLC_TPU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("DMLC_TPU_NUM_PROC", "4")
    monkeypatch.setenv("DMLC_TPU_PROC_ID", "2")
    assert distributed.env_process_info() == {
        "coordinator": "10.0.0.1:1234", "num_processes": 4, "process_id": 2}
    assert distributed.multiprocess_env()
    assert (distributed.process_index(), distributed.process_count()) == \
        (2, 4)
    # checked before any rendezvous is tried
    with pytest.raises(DMLCError, match="out of"):
        distributed.initialize("10.0.0.1:1234", 2, 2, device="cpu")


def test_tracker_rejects_bad_handshakes_and_fails_fast():
    import socket
    import struct

    from dmlc_tpu_torch.utils import DMLCError

    tracker = rendezvous.RabitTracker("127.0.0.1", 2, port=21150,
                                      port_end=21200)
    try:
        assert tracker.worker_envs() == {"DMLC_TRACKER_URI": "127.0.0.1",
                                         "DMLC_TRACKER_PORT": tracker.port}
        tracker.start()
        # a wrong magic is refused and the tracker keeps serving
        with socket.create_connection(("127.0.0.1", tracker.port)) as sock:
            sock.sendall(struct.pack("@i", 0x1234))
            assert sock.recv(4) == b""
        assert tracker.alive()
        # the workers' launcher reports them all dead before rendezvous
        with pytest.raises(DMLCError, match="waiting for rendezvous"):
            tracker.join(tasks_alive=lambda: False, grace_s=0.2)
    finally:
        tracker.close()
    tracker.thread.join(5)
    assert not tracker.alive()
    with pytest.raises(DMLCError, match="cmd must be start or recover"):
        SocketEngine(tracker_uri="127.0.0.1", tracker_port=tracker.port,
                     cmd="elastic")

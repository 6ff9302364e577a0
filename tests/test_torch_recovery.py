"""Crash recovery of the port (``dmlc_tpu_torch.collective.run_with_recovery``,
``reinit_recover``) against the JAX package's (``tests/test_recovery.py``,
``tests/test_device_recovery.py``) on the same job.

- Socket engine: a job of the port's launcher (``python -m
  dmlc_tpu_torch.tracker.submit --cluster local --max-attempts 2``) whose
  workers die hard after a checkpoint; the launcher relaunches them, the
  survivors recover (tracker cmd='recover'), everyone replays from the
  shared checkpoint, and every rank ends with ``tests/test_recovery.py``'s
  closed form bit for bit, at version 4. Worlds 2 and 3, a crash while
  the ring is in flight, and a double failure. Mixed packages: the port's
  workers recover on the JAX package's ``dmlc-submit`` tracker, and the
  JAX package's workers on the port's launcher and tracker.
- ``run_with_recovery`` gives up after ``max_attempts`` and raises at once
  on filesystem errors.
- Device engine: two ``torch.distributed`` ranks over gloo, each in a
  relaunch loop exporting the DMLC_TPU_COORDINATOR ``host:port`` env;
  rank 0 (which serves the store) or rank 1 crashes and the replay
  equals the closed form and a clean run, also when the survivor's first
  re-init fails and is retried (on gloo and the CPU again); without that
  env ``reinit_recover`` raises and leaves the engine as it was.
- A learner built with a group re-places its params on the new group
  after a rebuild and drops its listener when closed or collected.
- The retry policy behind the dials and the recovery loop: the JAX
  package's transient/fatal classification, retries and give-ups counted
  by site, fatal errors at once, the deadline, the budget, and the
  jittered backoff.

Trackers started here bind 21600-21649; the launcher-driven jobs scan
for a free port and hand it to their workers in the env.
"""

import gc
import hashlib
import os
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import textwrap
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dmlc_tpu_torch import collective
from dmlc_tpu_torch.tracker.rendezvous import RabitTracker
from dmlc_tpu_torch.utils.logging import DMLCError

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the JAX package's worker of tests/test_recovery.py, with the package
# to import as a parameter; RESULT lines go to stdout
WORKER = textwrap.dedent("""
    import hashlib, os, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    from {package} import collective as rabit
    if {force_ring}:
        from {package}.collective.socket_engine import SocketEngine
        SocketEngine.ring_threshold_bytes = 1

    CKPT = sys.argv[1]
    EPOCHS = 4
    CRASH_RANKS = set(
        int(r) for r in sys.argv[2].split(",") if r not in ("", "none"))
    SIZE = int(sys.argv[3])

    rabit.init()
    rank = rabit.rank()
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", 0))

    def round_fn():
        state = rabit.load_checkpoint(CKPT)
        if state is None:
            state = (0, np.zeros(SIZE))
        epoch, w = state
        if epoch >= EPOCHS:
            return state
        if rank in CRASH_RANKS and attempt == 0 and epoch == 2:
            os._exit(17)  # a hard crash after checkpointing epoch 2
        g = rabit.allreduce(
            np.full(SIZE, (rank + 1) * (epoch + 1), dtype=np.float64))
        w = w + g
        rabit.checkpoint((epoch + 1, w), CKPT if rank == 0 else None)
        return (epoch + 1, w)

    state = (0, None)
    while state[0] < EPOCHS:
        state = rabit.run_with_recovery(round_fn)
    epoch, w = state
    digest = hashlib.sha256(w.tobytes()).hexdigest()
    print(f"RESULT rank={{rank}} w={{digest}} v={{rabit.version_number()}}",
          flush=True)
    rabit.finalize()
""")

LAUNCHERS = {
    "port": [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit"],
    "ref": [sys.executable, str(ROOT / "dmlc-submit")],
}


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    for key in ("DMLC_TPU_FAULTS", "DMLC_TPU_ELASTIC", "DMLC_TPU_SPARE",
                "DMLC_TRACKER_URI", "DMLC_TPU_COORDINATOR"):
        env.pop(key, None)
    env.update(extra)
    return env


# the workers share the launcher's stdout, and an unbuffered print writes
# its text and its newline apart: find the fields, not the lines
RESULT = re.compile(r"RESULT rank=(\d+) w=([0-9a-f]{64}) v=(\d+)")


def _results(out: str, world: int):
    results = {int(r): (w, int(v)) for r, w, v in RESULT.findall(out)}
    assert sorted(results) == list(range(world)), out
    assert all(v == 4 for _, v in results.values()), results
    return {r: w for r, (w, _) in results.items()}


def _run_job(tmp_path, crash_ranks, world, size=8, tag="", launcher="port",
             package="dmlc_tpu_torch", force_ring=False):
    script = tmp_path / f"worker_{package}_{force_ring}.py"
    script.write_text(WORKER.format(root=str(ROOT), package=package,
                                    force_ring=force_ring))
    ckpt = tmp_path / f"ckpt_{tag or crash_ranks or 'clean'}.bin"
    proc = subprocess.run(
        LAUNCHERS[launcher] + [
            "--cluster", "local", "-n", str(world), "--max-attempts", "2",
            "--host-ip", "127.0.0.1", sys.executable, str(script),
            str(ckpt), crash_ranks or "none", str(size)],
        capture_output=True, text=True, timeout=240, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return _results(proc.stdout + proc.stderr, world)


def _expect(world: int, size: int = 8) -> str:
    """The digest of tests/test_recovery.py's closed form: sum over epochs
    e of (e+1) times the sum over ranks of (r+1), as float64."""
    return hashlib.sha256(np.full(size, sum(e + 1 for e in range(4))
                                  * world * (world + 1) / 2).tobytes()
                          ).hexdigest()


@pytest.mark.parametrize("world", [2, 3])
def test_crash_relaunch_replay_equals_closed_form(tmp_path, world):
    crashed = _run_job(tmp_path, "0", world)
    for rank in range(world):
        assert crashed[rank] == _expect(world)


def test_crash_with_ring_allreduce_in_flight(tmp_path):
    """The survivors are inside a ring allreduce (every payload takes the
    ring) when the peer dies: the hop fails, the world recovers and the
    replay still ends on the closed form."""
    world, size = 3, 40_000
    crashed = _run_job(tmp_path, "0", world, size=size, tag="ring",
                       force_ring=True)
    for rank in range(world):
        assert crashed[rank] == _expect(world, size)


def test_double_failure_recovers(tmp_path):
    """Two of three workers die at the same epoch; both are relaunched and
    everyone replays to the closed form."""
    crashed = _run_job(tmp_path, "0,1", 3, tag="double")
    for rank in range(3):
        assert crashed[rank] == _expect(3)


@pytest.mark.parametrize("launcher,package", [
    ("ref", "dmlc_tpu_torch"),  # port workers on the JAX package's tracker
    ("port", "dmlc_tpu"),  # JAX package workers on the port's tracker
])
def test_mixed_packages_recover_on_each_others_tracker(tmp_path, launcher,
                                                       package):
    crashed = _run_job(tmp_path, "1", 2, tag=f"{launcher}_{package}",
                       launcher=launcher, package=package)
    for rank in range(2):
        assert crashed[rank] == _expect(2)


def test_attempts_exhaustion_raises(monkeypatch):
    tracker = RabitTracker("127.0.0.1", 1, port=21600, port_end=21650)
    tracker.start(1)
    monkeypatch.setenv("DMLC_TRACKER_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_TRACKER_PORT", str(tracker.port))
    calls = []
    try:
        collective.finalize()
        collective.init("socket")

        def round_fn():
            calls.append(1)
            raise DMLCError("synthetic collective failure")

        with pytest.raises(DMLCError, match="synthetic"):
            collective.run_with_recovery(round_fn, max_attempts=3)
        assert len(calls) == 3  # the third failure spends the budget
    finally:
        collective.finalize()
        tracker.close()


@pytest.mark.parametrize("error", [FileNotFoundError, PermissionError,
                                   IsADirectoryError])
def test_filesystem_errors_raise_without_recovering(error):
    calls = []

    def round_fn():
        calls.append(1)
        raise error("/no/such/checkpoint")

    collective.finalize()
    collective.init("local")
    try:
        with pytest.raises(error):
            collective.run_with_recovery(round_fn)
        assert len(calls) == 1
    finally:
        collective.finalize()


def test_local_engine_failure_is_not_recovered():
    calls = []

    def round_fn():
        calls.append(1)
        raise DMLCError("boom")

    collective.finalize()
    collective.init("local")
    try:
        with pytest.raises(DMLCError, match="boom"):
            collective.run_with_recovery(round_fn)
        assert len(calls) == 1  # a world of one has nothing to recover
    finally:
        collective.finalize()


# ---------------------------------------------------------------------------
# the device engine over gloo
# ---------------------------------------------------------------------------

DEVICE_WORKER = textwrap.dedent("""
    import hashlib, os, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch.distributed as dist
    from dmlc_tpu_torch.parallel.distributed import initialize_from_env
    initialize_from_env(device="cpu")
    from dmlc_tpu_torch import collective as rabit

    CKPT = sys.argv[1]
    EPOCHS = 4
    CRASH_RANK = int(sys.argv[2]) if sys.argv[2] != "none" else None
    FLAKY = sys.argv[3] == "flaky"  # the survivor's first re-init fails
    HOLD = sys.argv[3] == "hold"  # rank 0 keeps its own old group

    rabit.init("device")
    rank = rabit.rank()
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", 0))
    # a learner holds the group and a step built over it, as a trainer
    # does: a re-init must still end the old group's store server
    from dmlc_tpu_torch.models import LinearLearner
    learner = LinearLearner(device="cpu", group=dist.group.WORLD)
    learner._ensure(4, "dense")
    if FLAKY and rank != CRASH_RANK and attempt == 0:
        real_init, inits = dist.init_process_group, []

        def flaky_init(*args, **kwargs):
            inits.append(1)
            if len(inits) == 1:
                raise RuntimeError("injected: the store is unreachable")
            return real_init(*args, **kwargs)

        dist.init_process_group = flaky_init
    # a caller's own reference to the first group, which no release
    # listener drops: rank 0 keeps serving the store all the same, and
    # the new group must not read the old one's keys
    held = [dist.group.WORLD] if HOLD and rank == 0 else []
    rebuilt = []
    rabit.on_membership_change(lambda: rebuilt.append(1))

    def round_fn():
        state = rabit.load_checkpoint(CKPT)
        if state is None:
            state = (0, np.zeros(4))
        epoch, w = state
        if epoch >= EPOCHS:
            return state
        if rank == CRASH_RANK and attempt == 0 and epoch == 2:
            os._exit(17)  # rank 0 serves the store: the hard case
        g = rabit.allreduce(
            np.full(4, (rank + 1) * (epoch + 1), dtype=np.float64))
        w = w + g
        rabit.checkpoint((epoch + 1, w), CKPT if rank == 0 else None)
        return (epoch + 1, w)

    state = (0, None)
    while state[0] < EPOCHS:
        # the injected failure spends one attempt of its own
        state = rabit.run_with_recovery(round_fn, max_attempts=3 + FLAKY)
    epoch, w = state
    b = rabit.broadcast(np.full(3, 7.5) if rank == 0 else None, root=0)
    assert np.array_equal(b, np.full(3, 7.5))
    digest = hashlib.sha256(w.tobytes()).hexdigest()
    print(f"RESULT rank={{rank}} w={{digest}} v={{rabit.version_number()}} "
          f"rebuilt={{len(rebuilt)}} backend={{dist.get_backend()}} "
          f"device={{rabit._engine.device}} "
          f"regrouped={{learner.group is dist.group.WORLD}}", flush=True)
    # end the group before the interpreter does: a group a live object
    # still holds at teardown can abort the process
    learner.close()
    del learner
    rabit.finalize()
    from dmlc_tpu_torch.parallel.distributed import shutdown
    shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_device_job(tmp_path, crash_rank=None, mode="steady", world=2):
    """A relaunch loop a task (up to 3 attempts; any non-zero exit, the
    crash or the re-init watchdog's 41, relaunches with the attempt
    number bumped), as a GPU launcher restarts its ranks. ``crash_rank``
    exits hard at epoch 2 on its first attempt; ``mode="flaky"`` makes
    the survivor's first ``init_process_group`` of its re-init raise, and
    ``mode="hold"`` has rank 0 keep a reference to its first group."""
    script = tmp_path / "device_worker.py"
    script.write_text(DEVICE_WORKER.format(root=str(ROOT)))
    ckpt = tmp_path / f"dev_{crash_rank}_{mode}.bin"
    port = _free_port()
    outputs, codes = {}, {tid: [] for tid in range(world)}

    def run_task(tid):
        for attempt in range(3):
            env = _env(DMLC_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       DMLC_TPU_NUM_PROC=str(world),
                       DMLC_TPU_PROC_ID=str(tid),
                       DMLC_NUM_ATTEMPT=str(attempt),
                       DMLC_TPU_RECOVER_TIMEOUT="30")
            proc = subprocess.run(
                [sys.executable, str(script), str(ckpt),
                 "none" if crash_rank is None else str(crash_rank), mode],
                capture_output=True, text=True, timeout=200, env=env)
            outputs[tid] = proc.stdout + proc.stderr
            codes[tid].append(proc.returncode)
            if proc.returncode == 0:
                return

    threads = [threading.Thread(target=run_task, args=(tid,))
               for tid in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=260)
    assert not any(t.is_alive() for t in threads)
    assert all(c[-1] == 0 for c in codes.values()), (codes, outputs)
    text = "\n".join(outputs.values())
    ends = {int(r): (int(n), b, d, g) for r, n, b, d, g in re.findall(
        r"RESULT rank=(\d+) w=[0-9a-f]{64} v=\d+ rebuilt=(\d+) "
        r"backend=(\w+) device=(\w+) regrouped=(\w+)", text)}
    # a re-init keeps the job's backend and device, and the learner ends
    # on the new default group
    assert all(b == "gloo" and d == "cpu" and g == "True"
               for _, b, d, g in ends.values()), ends
    rebuilt = {r: n for r, (n, _, _, _) in ends.items()}
    return _results(text, world), codes, rebuilt


def _hold_device_crash(tmp_path, crash_rank):
    clean, _, _ = _run_device_job(tmp_path)
    crashed, codes, rebuilt = _run_device_job(tmp_path, crash_rank)
    survivor = 1 - crash_rank
    for rank in range(2):
        assert clean[rank] == _expect(2, 4)
        assert crashed[rank] == clean[rank]
    assert codes[crash_rank][0] == 17  # crashed and was relaunched
    # the survivor re-initialized in process (and ran its listeners), or
    # took the fail-stop exit and was relaunched
    assert rebuilt[survivor] == 1 or 41 in codes[survivor], (codes, rebuilt)


def test_device_engine_crash_of_rank_0_replays_clean_run(tmp_path):
    """Rank 0 serves the store: the survivor's new group waits for the
    relaunched rank 0."""
    _hold_device_crash(tmp_path, 0)


def test_device_engine_crash_of_rank_1_replays_clean_run(tmp_path):
    """The surviving rank 0 serves the store again for the relaunched
    rank 1."""
    _hold_device_crash(tmp_path, 1)


def test_device_reinit_retried_after_a_failed_rendezvous(tmp_path):
    """The survivor's first re-init raises after its group is aborted;
    the retry starts the group with the job's backend and device (gloo,
    cpu), not the defaults, and the replay equals a clean run."""
    clean, _, _ = _run_device_job(tmp_path)
    crashed, codes, rebuilt = _run_device_job(tmp_path, 0, mode="flaky")
    assert crashed == clean
    assert codes[1] == [0] and rebuilt[1] == 1, (codes, rebuilt)


def test_device_engine_rank_0_holding_its_old_group_replays_clean_run(
        tmp_path):
    """Rank 1 crashes while rank 0's worker keeps its own reference to the
    old group: rank 0 keeps serving the store, the new group rendezvouses
    under the next generation's prefix, and the job replays the clean
    digest (or the survivor takes the fail-stop exit 41 and is
    relaunched), within the relaunch loop's time limits."""
    clean, _, _ = _run_device_job(tmp_path)
    crashed, codes, rebuilt = _run_device_job(tmp_path, 1, mode="hold")
    assert crashed == clean
    assert codes[1][0] == 17
    assert rebuilt[0] == 1 or codes[0][:-1] == [41] * (len(codes[0]) - 1), (
        codes, rebuilt)


def test_generations_are_agreed_on_the_store(monkeypatch):
    """The generation protocol of ``parallel.distributed`` on one store:
    rank 0 publishes a new generation at each initialization (none on a
    retry before its group forms), and another rank, a relaunched one
    too, takes the first published generation above the last it joined,
    which the store remembers."""
    from dmlc_tpu_torch.parallel import distributed as pd

    address = ("127.0.0.1", _free_port())
    for name in ("_store", "_store_address", "_pending_generation"):
        monkeypatch.setattr(pd, name, None)
    server, gen = pd._generation_store(address, 0)
    assert gen == 1
    assert pd._generation_store(address, 0) == (server, 1)  # a retry

    def rank1():
        store, generation = pd._generation_store(address, 1)
        monkeypatch.setattr(pd, "_store", server)  # this process is rank 0
        return store, generation

    client, gen = rank1()
    assert gen == 1
    pd._joined(server, 0, 1)
    pd._joined(client, 1, 1)
    assert pd._generation_store(address, 0)[1] == 2  # rank 0's re-init
    # a relaunched rank 1 remembers nothing: its last join is on the store
    assert rank1()[1] == 2
    pd._joined(client, 1, 2)
    monkeypatch.setattr(pd, "PG_TIMEOUT_S", 0.2)
    with pytest.raises(DMLCError, match="no generation above 2"):
        rank1()


def test_reinit_recover_without_launcher_env_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("DMLC_TPU_COORDINATOR", raising=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        collective.finalize()
        collective.init("device")
        engine = collective._engine
        collective.checkpoint({"w": np.arange(3.0)})
        with pytest.raises(DMLCError, match="launcher env"):
            collective.reinit_recover()
        assert collective._engine is engine
        np.testing.assert_array_equal(collective.allreduce(np.ones(2)),
                                      np.ones(2))
        assert collective.load_checkpoint()["w"].tolist() == [0, 1, 2]
    finally:
        collective.finalize()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the membership listener of a learner built with a group
# ---------------------------------------------------------------------------


def test_membership_listener_replaces_params_on_the_new_group():
    from dmlc_tpu_torch.models import FMLearner, LinearLearner
    from dmlc_tpu_torch.models.fm import fm_params_from_numpy

    listeners = len(collective._membership_listeners)
    releases = len(collective._release_listeners)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg1",
                                rank=0, world_size=1)
        old = dist.group.WORLD
        linear = LinearLearner(device="cpu", group=old)
        linear.params = {"w": torch.arange(4.0), "b": torch.tensor(0.5)}
        linear.velocity = {"w": torch.ones(4), "b": torch.tensor(0.25)}
        linear._step = object()
        fm = FMLearner(device="cpu", group=old, num_features=4,
                       num_factors=2)
        fm.params = fm_params_from_numpy(
            {"w": np.arange(4.0), "b": np.float32(1.0),
             "v": np.ones((4, 2))}, "cpu")
        unset = LinearLearner(device="cpu", group=old)  # no params yet
        assert len(collective._membership_listeners) == listeners + 3
        assert len(collective._release_listeners) == releases + 3
        # a device re-init: the learners drop the old group and their
        # steps, the old default group goes, a new one comes up
        for fn in list(collective._release_listeners):
            fn()
        for learner in (linear, fm, unset):
            assert learner.group is not old and learner._step is None
        dist.destroy_process_group()
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg2",
                                rank=0, world_size=1)
        try:
            collective._notify_membership()
            for learner in (linear, fm):
                assert learner.group is dist.group.WORLD
                assert learner.group is not old
                assert learner._step is None
            # nothing to re-place: its first step takes the new group
            assert unset.group is not dist.group.WORLD
            unset._ensure(4, "dense")
            assert unset.group is dist.group.WORLD
            assert linear.params["w"].tolist() == [0, 1, 2, 3]
            assert linear.velocity["b"].item() == 0.25
            assert fm.params["v"].tolist() == [[1, 1]] * 4
        finally:
            dist.destroy_process_group()
    linear.close()
    linear.close()  # idempotent
    assert len(collective._membership_listeners) == listeners + 2
    assert len(collective._release_listeners) == releases + 2
    del fm, unset, learner
    gc.collect()
    assert len(collective._membership_listeners) == listeners
    assert len(collective._release_listeners) == releases


# ---------------------------------------------------------------------------
# the retry policy behind the dials and the recovery loop
# ---------------------------------------------------------------------------


def _http(code):
    import urllib.error

    return urllib.error.HTTPError("http://x", code, "m", {}, None)


@pytest.mark.parametrize("make", [
    lambda E: OSError("reset"), lambda E: ConnectionError("closed"),
    lambda E: TimeoutError("t"), lambda E: E("engine"),
    lambda E: FileNotFoundError("f"), lambda E: PermissionError("p"),
    lambda E: IsADirectoryError("d"), lambda E: ValueError("v"),
    lambda E: KeyError("k"), lambda E: _http(500), lambda E: _http(503),
    lambda E: _http(429), lambda E: _http(408), lambda E: _http(404),
    lambda E: _http(403),
], ids=["oserror", "connection", "timeout", "dmlcerror", "notfound",
        "permission", "isadir", "value", "key", "http500", "http503",
        "http429", "http408", "http404", "http403"])
def test_classify_transient_matches_reference(make):
    """Each package's DMLCError is its own class: each side is asked
    about its own."""
    from dmlc_tpu.resilience.retry import classify_transient as ref_classify
    from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
    from dmlc_tpu_torch.resilience import classify_transient

    assert classify_transient(make(DMLCError)) == \
        ref_classify(make(RefDMLCError))


class _Clock:
    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


def _policy(clock, **kw):
    import random

    from dmlc_tpu_torch.resilience import RetryPolicy

    return RetryPolicy(rng=random.Random(3), sleep=clock.sleep,
                       clock=lambda: clock.now, **kw)


def test_retry_policy_retries_transient_errors_then_gives_up():
    from dmlc_tpu_torch.resilience import reset_stats, retry

    reset_stats()
    clock, calls = _Clock(), []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("reset")
        return "ok"

    assert _policy(clock, max_attempts=3).call(flaky, "t.flaky") == "ok"
    assert len(calls) == 3 and len(clock.sleeps) == 2
    assert all(0.1 <= s <= 2.0 for s in clock.sleeps)
    with pytest.raises(DMLCError, match="gave up after 2 attempt"):
        _policy(clock, max_attempts=2).call(
            lambda: (_ for _ in ()).throw(OSError("down")), "t.down")
    assert retry.stats() == {"attempts": {"t.flaky": 2, "t.down": 1},
                             "giveups": {"t.down": 1}}
    reset_stats()


def test_retry_policy_fatal_errors_deadline_and_budget():
    from dmlc_tpu_torch.resilience import RetryBudget

    clock, calls = _Clock(), []

    def missing():
        calls.append(1)
        raise FileNotFoundError("cfg")

    with pytest.raises(FileNotFoundError):
        _policy(clock, max_attempts=5).call(missing, "t.fatal")
    assert len(calls) == 1 and not clock.sleeps  # fatal: nothing spent

    def down():
        raise OSError("down")

    with pytest.raises(DMLCError, match="deadline"):
        _policy(clock, max_attempts=100, deadline_s=1.0, base_s=0.4,
                cap_s=0.4).call(down, "t.deadline")
    assert clock.now <= 1.0
    with pytest.raises(DMLCError, match="budget exhausted"):
        _policy(clock, max_attempts=100, budget=RetryBudget(2)).call(
            down, "t.budget")
    # one bucket shared by two policies: the first spent it
    shared = RetryBudget(1)
    with pytest.raises(DMLCError, match="after 2 attempt.*budget"):
        _policy(clock, max_attempts=100, budget=shared).call(down, "t.a")
    with pytest.raises(DMLCError, match="after 1 attempt.*budget"):
        _policy(clock, max_attempts=100, budget=shared).call(down, "t.b")


def test_retry_call_retries_transient_errors_only():
    from dmlc_tpu_torch.resilience import retry_call

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise ConnectionError("reset")
        return len(calls)

    assert retry_call(flaky, "t.call", base_s=0.001, cap_s=0.001) == 2
    with pytest.raises(PermissionError):
        retry_call(lambda: (_ for _ in ()).throw(PermissionError("p")),
                   "t.call")


def test_backoff_sleep_is_jittered_and_capped(monkeypatch):
    from dmlc_tpu_torch.resilience import retry

    slept = []
    monkeypatch.setattr(retry.time, "sleep", slept.append)
    for attempt in (1, 2, 3, 8):
        retry.backoff_sleep(attempt, "t.backoff", base_s=0.5, cap_s=5.0)
    assert all(0.5 <= s <= 5.0 for s in slept)
    assert slept[0] <= 1.5  # the first sleep is within [base, 3 * base]

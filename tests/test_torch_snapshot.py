"""The port's checkpoint and job-snapshot plane (``collective/checkpoint``,
``collective/snapshot``, ``resilience``) held to the JAX package's.

- The cases of ``tests/test_checkpoint.py`` and ``tests/test_snapshot.py``
  that need no mem://, object store or obs registry, run on the port.
- Across the packages: a ``JobSnapshot`` directory written by either is
  restored by the other, equal part bytes for one numpy state tree, and
  the rabit ``("dmlc_ckpt_v1", version, state)`` blob read both ways.
- ``_to_host`` makes a real copy: an in-place step right after a capture
  does not reach the captured tree.
- An injected preemption mid-epoch exits with code 75 after committing the
  last epoch boundary, and the resumed fit of ``LinearLearner`` and
  ``FMLearner`` is bit-identical to an uninterrupted run on the CPU.
"""

import collections
import os
import shutil
import signal
import time

import numpy as np
import pytest
import torch

import dmlc_tpu.collective as ref_collective
from dmlc_tpu import resilience as ref_resilience
from dmlc_tpu.collective import JobSnapshot as RefJobSnapshot
from dmlc_tpu.resilience import preempt as ref_preempt
from dmlc_tpu_torch import collective, resilience
from dmlc_tpu_torch.collective import (CheckpointManager, JobSnapshot,
                                       Snapshotter, load_snapshot)
from dmlc_tpu_torch.collective.checkpoint import _to_host
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.io import exists, list_dir
from dmlc_tpu_torch.models import (FMLearner, LinearLearner,
                                   fm_params_from_numpy, fm_params_to_numpy,
                                   init_fm_params, make_fm_train_step,
                                   params_to_numpy)
from dmlc_tpu_torch.resilience import EXIT_PREEMPTED, Preempted, preempt
from dmlc_tpu_torch.utils import DMLCError


@pytest.fixture(autouse=True)
def _clean_state():
    for mod in (resilience, ref_resilience):
        mod.reset()
    for mod in (preempt, ref_preempt):
        mod.reset()
    yield
    for mod in (resilience, ref_resilience):
        mod.reset()
    for mod in (preempt, ref_preempt):
        mod.reset()
        mod.uninstall()


def _state(tag: float):
    return {"w": np.full(4, tag), "b": np.array(tag, dtype=np.float32),
            "epoch": int(tag)}


# ---------------------------------------------------------------------------
# CheckpointManager (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


class TestCheckpointManager:
    def test_roundtrip_and_versions(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        assert mgr.version_number == 0
        assert mgr.load_checkpoint() == (0, None)
        state = {"w": np.arange(4, dtype=np.float32), "step": 7}
        assert mgr.checkpoint(state) == 1
        assert mgr.checkpoint({"w": state["w"] * 2, "step": 8}) == 2
        version, loaded = mgr.load_checkpoint()
        assert version == 2
        np.testing.assert_array_equal(loaded["w"], state["w"] * 2)
        assert loaded["step"] == 8

    def test_restart_recovers_latest(self, tmp_path):
        uri = str(tmp_path / "ckpt")
        mgr = CheckpointManager(uri)
        mgr.checkpoint({"step": 1})
        mgr.checkpoint({"step": 2})
        recovered = CheckpointManager(uri)
        assert recovered.version_number == 2
        version, state = recovered.load_checkpoint()
        assert (version, state["step"]) == (2, 2)
        assert recovered.checkpoint({"step": 3}) == 3

    def test_non_writer_ranks_do_not_write(self, tmp_path):
        uri = str(tmp_path / "ckpt")
        w0 = CheckpointManager(uri, rank=0, world_size=2)
        w1 = CheckpointManager(uri, rank=1, world_size=2)
        assert w1.checkpoint({"step": 1}) == 1
        assert CheckpointManager(uri).version_number == 0
        assert w0.checkpoint({"step": 1}) == 1
        assert CheckpointManager(uri).version_number == 1

    def test_per_rank_local_state(self, tmp_path):
        uri = str(tmp_path / "ckpt")
        w0 = CheckpointManager(uri, rank=0, world_size=2, per_rank=True)
        w1 = CheckpointManager(uri, rank=1, world_size=2, per_rank=True)
        w1.checkpoint({"rank": 1})
        w0.checkpoint({"rank": 0})
        for rank in (0, 1):
            assert CheckpointManager(uri, rank=rank, per_rank=True) \
                .load_checkpoint()[1] == {"rank": rank}

    def test_prune_keeps_window(self, tmp_path):
        uri = tmp_path / "ckpt"
        mgr = CheckpointManager(str(uri), keep=2)
        for step in range(6):
            mgr.checkpoint({"step": step})
        names = list_dir(f"file://{uri}")
        assert exists(str(uri / "ckpt_v6.bin"))
        assert not exists(str(uri / "ckpt_v4.bin"))
        assert "LATEST" in names
        assert [n for n in names if n.startswith("ckpt_v")] == [
            "ckpt_v5.bin", "ckpt_v6.bin"]
        assert mgr.load_checkpoint()[1]["step"] == 5

    def test_missing_state_file_raises(self, tmp_path):
        uri = tmp_path / "ckpt"
        CheckpointManager(str(uri)).checkpoint({"step": 1})
        (uri / "ckpt_v1.bin").unlink()
        with pytest.raises(DMLCError):
            CheckpointManager(str(uri)).load_checkpoint()

    def test_per_rank_missing_file_falls_back(self, tmp_path):
        uri = str(tmp_path / "ckpt")
        w0 = CheckpointManager(uri, rank=0, world_size=2, per_rank=True,
                               keep=3)
        w1 = CheckpointManager(uri, rank=1, world_size=2, per_rank=True,
                               keep=3)
        w1.checkpoint({"step": 1})
        w0.checkpoint({"step": 1})
        w0.checkpoint({"step": 2})  # rank 1 crashed before its v2 write
        version, state = CheckpointManager(
            uri, rank=1, world_size=2, per_rank=True,
            keep=3).load_checkpoint()
        assert (version, state["step"]) == (1, 1)

    def test_namedtuple_state_roundtrips(self, tmp_path):
        Opt = collections.namedtuple("Opt", ["mu", "nu"])
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.checkpoint({"opt": Opt(mu=np.ones(2), nu=np.zeros(2))})
        mu, nu = mgr.load_checkpoint()[1]["opt"]
        np.testing.assert_array_equal(mu, np.ones(2))
        np.testing.assert_array_equal(nu, np.zeros(2))

    def test_empty_latest_treated_as_no_checkpoint(self, tmp_path):
        uri = tmp_path / "ckpt"
        uri.mkdir()
        (uri / "LATEST").write_bytes(b"")  # torn write remnant
        assert CheckpointManager(str(uri)).load_checkpoint() == (0, None)

    def test_torn_state_write_not_visible(self, tmp_path):
        uri = tmp_path / "ckpt"
        mgr = CheckpointManager(str(uri), keep=3)
        mgr.checkpoint({"step": 1})
        resilience.configure("ckpt.commit:nth=1")
        with pytest.raises(OSError):
            mgr.checkpoint({"step": 2})
        resilience.reset()
        assert (uri / "LATEST").read_bytes().strip() == b"1"
        version, state = CheckpointManager(str(uri)).load_checkpoint()
        assert (version, state["step"]) == (1, 1)
        (uri / "ckpt_v2.bin").write_bytes(b"\x00garbage")
        version, state = CheckpointManager(str(uri)).load_checkpoint()
        assert (version, state["step"]) == (1, 1)

    def test_prune_never_removes_latest_pointed_version(self, tmp_path):
        uri = tmp_path / "ckpt"
        mgr = CheckpointManager(str(uri), per_rank=True, keep=3)
        for step in range(8):
            mgr.checkpoint({"step": step})
        latest = int((uri / "LATEST").read_bytes())
        kept = {p.name for p in uri.iterdir()}
        for version in range(latest - mgr.keep + 1, latest + 1):
            assert f"ckpt_v{version}.rank0.bin" in kept
        version, state = CheckpointManager(
            str(uri), per_rank=True, keep=3).load_checkpoint()
        assert (version, state["step"]) == (8, 7)

    def test_fallback_uri_commit_and_recover(self, tmp_path):
        primary = str(tmp_path / "primary")
        fallback = str(tmp_path / "fallback")
        mgr = CheckpointManager(primary, fallback_uri=fallback)
        mgr.checkpoint({"step": 1})
        resilience.configure("ckpt.commit:nth=1")
        assert mgr.checkpoint({"step": 2}) == 2
        resilience.reset()
        assert (tmp_path / "fallback" / "ckpt_v2.bin").exists()
        assert (tmp_path / "primary" / "LATEST").read_bytes().strip() == b"1"
        version, state = CheckpointManager(
            primary, fallback_uri=fallback).load_checkpoint()
        assert (version, state["step"]) == (2, 2)
        version, state = CheckpointManager(primary).load_checkpoint()
        assert (version, state["step"]) == (1, 1)

    def test_fallback_env_setting(self, tmp_path, monkeypatch):
        monkeypatch.setenv("DMLC_TPU_CKPT_FALLBACK_URI", str(tmp_path / "fb"))
        mgr = CheckpointManager(str(tmp_path / "primary"))
        resilience.configure("ckpt.commit:nth=1")
        assert mgr.checkpoint({"step": 1}) == 1
        assert (tmp_path / "fb" / "ckpt_v1.bin").exists()

    def test_fallback_config_errors_not_degraded(self, tmp_path):
        primary = tmp_path / "primary"
        mgr = CheckpointManager(str(primary),
                                fallback_uri=str(tmp_path / "fallback"))
        shutil.rmtree(primary)
        with pytest.raises(FileNotFoundError):
            mgr.checkpoint({"step": 1})
        assert not (tmp_path / "fallback" / "ckpt_v1.bin").exists()

    def test_tensors_become_numpy(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "ckpt"))
        mgr.checkpoint({"w": torch.ones(3), "nested": [torch.zeros(2)],
                        "b": torch.tensor(0.5)})
        _, state = mgr.load_checkpoint()
        assert isinstance(state["w"], np.ndarray)
        np.testing.assert_array_equal(state["w"], np.ones(3, np.float32))
        assert isinstance(state["nested"][0], np.ndarray)
        assert state["b"].shape == () and state["b"].dtype == np.float32


# ---------------------------------------------------------------------------
# JobSnapshot (tests/test_snapshot.py)
# ---------------------------------------------------------------------------


class TestJobSnapshot:
    def test_commit_restore_roundtrip(self, tmp_path):
        snap = JobSnapshot(str(tmp_path / "snap"))
        assert snap.restore() == (0, None, {})
        assert snap.commit(_state(1.0), meta={"epoch": 0}) == 1
        assert snap.commit(_state(2.0), meta={"epoch": 1}) == 2
        version, state, meta = JobSnapshot(str(tmp_path / "snap")).restore()
        assert version == 2 and meta["epoch"] == 1
        np.testing.assert_array_equal(state["w"], np.full(4, 2.0))
        assert state["b"].shape == ()

    def test_two_rank_two_phase_commit(self, tmp_path):
        import json

        uri = str(tmp_path / "snap")
        r0 = JobSnapshot(uri, rank=0, world_size=2)
        r1 = JobSnapshot(uri, rank=1, world_size=2)
        r1.commit({"rank": 1})
        r0.commit({"rank": 0})
        manifest = json.loads(
            (tmp_path / "snap" / "snap_v1.manifest").read_bytes()
            .split(b"\n", 1)[1])
        assert [p["name"] for p in manifest["parts"]] == [
            "snap_v1.rank0", "snap_v1.rank1"]
        assert manifest["world_size"] == 2
        for rank in (0, 1):
            _, state, _ = JobSnapshot(uri, rank=rank, world_size=2).restore()
            assert state == {"rank": rank}

    def test_rank0_barrier_times_out_without_peers(self, tmp_path):
        r0 = JobSnapshot(str(tmp_path / "snap"), rank=0, world_size=2,
                         part_timeout_s=0.2)
        with pytest.raises(DMLCError, match="did not write"):
            r0.commit({"rank": 0})

    def test_torn_manifest_falls_back_to_older_version(self, tmp_path):
        uri = tmp_path / "snap"
        snap = JobSnapshot(str(uri), keep=3)
        snap.commit(_state(1.0))
        snap.commit(_state(2.0))
        manifest = uri / "snap_v2.manifest"
        manifest.write_bytes(manifest.read_bytes()[:20])
        version, state, _ = JobSnapshot(str(uri), keep=3).restore()
        assert version == 1
        np.testing.assert_array_equal(state["w"], np.full(4, 1.0))

    def test_corrupt_part_falls_back_to_older_version(self, tmp_path):
        uri = tmp_path / "snap"
        snap = JobSnapshot(str(uri), keep=3)
        snap.commit(_state(1.0))
        snap.commit(_state(2.0))
        part = uri / "snap_v2.rank0"
        raw = bytearray(part.read_bytes())
        raw[3] ^= 0xFF
        part.write_bytes(bytes(raw))
        version, state, _ = JobSnapshot(str(uri), keep=3).restore()
        assert version == 1
        np.testing.assert_array_equal(state["w"], np.full(4, 1.0))

    def test_crash_between_part_write_and_manifest_commit(self, tmp_path):
        uri = tmp_path / "snap"
        snap = JobSnapshot(str(uri), keep=3)
        snap.commit(_state(1.0))
        resilience.configure("snap.commit:nth=1")
        with pytest.raises(OSError):
            snap.commit(_state(2.0))
        resilience.reset()
        assert (uri / "snap_v2.rank0").exists()
        assert not (uri / "snap_v2.manifest").exists()
        version, state, _ = JobSnapshot(str(uri), keep=3).restore()
        assert version == 1
        np.testing.assert_array_equal(state["w"], np.full(4, 1.0))

    def test_fallback_uri_newest_committed_wins(self, tmp_path):
        primary = str(tmp_path / "primary")
        fallback = str(tmp_path / "fallback")
        snap = JobSnapshot(primary, fallback_uri=fallback)
        snap.commit(_state(1.0))
        resilience.configure("snap.commit:nth=1")
        assert snap.commit(_state(2.0)) == 2
        resilience.reset()
        assert (tmp_path / "fallback" / "snap_v2.manifest").exists()
        assert (tmp_path / "primary" / "LATEST").read_bytes().strip() == b"1"
        version, state, _ = JobSnapshot(primary,
                                        fallback_uri=fallback).restore()
        assert version == 2
        np.testing.assert_array_equal(state["w"], np.full(4, 2.0))
        version, state, _ = JobSnapshot(primary).restore()
        assert (version, state["epoch"]) == (1, 1)

    def test_world_size_change_raises_clean_error(self, tmp_path):
        uri = str(tmp_path / "snap")
        JobSnapshot(uri, rank=0, world_size=1).commit(_state(1.0))
        with pytest.raises(DMLCError, match="resharded"):
            JobSnapshot(uri, rank=0, world_size=2).restore()

    def test_superseded_version_does_not_wedge_the_barrier(self, tmp_path):
        uri = str(tmp_path / "snap")
        JobSnapshot(uri, rank=1, world_size=2).commit(
            _state(2.0), meta={"epoch": 1}, version=2)
        r0 = JobSnapshot(uri, rank=0, world_size=2, part_timeout_s=30.0)
        t0 = time.monotonic()
        assert r0.commit(_state(1.0), meta={"epoch": 0}, version=1) == 1
        assert time.monotonic() - t0 < 10.0
        assert not (tmp_path / "snap" / "snap_v1.manifest").exists()
        assert r0.commit(_state(2.0), meta={"epoch": 1}, version=2) == 2
        version, state, meta = JobSnapshot(uri, rank=0,
                                           world_size=2).restore()
        assert (version, meta["epoch"]) == (2, 1)
        np.testing.assert_array_equal(state["w"], np.full(4, 2.0))

    def test_explicit_version_must_advance(self, tmp_path):
        snap = JobSnapshot(str(tmp_path / "snap"))
        snap.commit(_state(1.0), version=3)
        with pytest.raises(DMLCError, match="monotonically"):
            snap.commit(_state(2.0), version=3)

    def test_restore_walks_past_version_gaps(self, tmp_path):
        uri = str(tmp_path / "snap")
        snap = JobSnapshot(uri, keep=2)
        snap.commit(_state(3.0), meta={"epoch": 2}, version=3)
        snap.commit(_state(7.0), meta={"epoch": 6}, version=7)
        (tmp_path / "snap" / "snap_v7.manifest").write_bytes(b"garbage")
        version, state, _ = JobSnapshot(uri, keep=2).restore()
        assert version == 3
        np.testing.assert_array_equal(state["w"], np.full(4, 3.0))

    def test_prune_keeps_restore_window(self, tmp_path):
        uri = tmp_path / "snap"
        snap = JobSnapshot(str(uri), keep=2)
        for tag in range(1, 6):
            snap.commit(_state(float(tag)))
        names = {p.name for p in uri.iterdir()}
        assert "snap_v1.manifest" not in names
        assert "snap_v5.manifest" in names
        version, state, _ = JobSnapshot(str(uri), keep=2).restore()
        assert version == 5
        np.testing.assert_array_equal(state["w"], np.full(4, 5.0))


# ---------------------------------------------------------------------------
# Snapshotter
# ---------------------------------------------------------------------------


class TestSnapshotter:
    def test_async_commit_and_epoch_cadence(self, tmp_path):
        snap = JobSnapshot(str(tmp_path / "snap"))
        snapper = Snapshotter(snap, every_epochs=2, every_s=0,
                              install_sigterm=False)
        try:
            assert snapper.capture(0, _state(0.0)) is True
            assert snapper.drain(timeout=10)
            assert snapper.committed_epoch == 0
            assert snapper.capture(1, _state(1.0)) is False
            assert snapper.capture(2, _state(2.0)) is True
            assert snapper.drain(timeout=10)
            assert snapper.committed_epoch == 2
            stats = snapper.stats()
            assert stats["commits"] == 2 and len(stats["capture_ns"]) == 3
            assert len(stats["write_ns"]) == 2 and stats["bytes"] > 0
        finally:
            snapper.close()
        _, state, meta = JobSnapshot(str(tmp_path / "snap")).restore()
        assert meta["epoch"] == 2
        np.testing.assert_array_equal(state["w"], np.full(4, 2.0))

    def test_state_builder_callable_and_coalescing(self, tmp_path):
        snap = JobSnapshot(str(tmp_path / "snap"))
        snapper = Snapshotter(snap, every_epochs=1, every_s=0,
                              install_sigterm=False)
        try:
            for epoch in range(3):
                snapper.capture(epoch, lambda e=epoch: _state(float(e)))
            assert snapper.drain(timeout=10)
            assert snapper.committed_epoch == 2
        finally:
            snapper.close()
        _, state, meta = JobSnapshot(str(tmp_path / "snap")).restore()
        assert meta["epoch"] == 2
        np.testing.assert_array_equal(state["w"], np.full(4, 2.0))

    def test_finalize_commits_pending_outside_cadence(self, tmp_path):
        snap = JobSnapshot(str(tmp_path / "snap"))
        snapper = Snapshotter(snap, every_epochs=0, every_s=0,
                              install_sigterm=False)
        try:
            assert snapper.capture(3, _state(3.0)) is False
            assert snap.version_number == 0
            assert snapper.finalize(deadline_s=10) is True
            assert snapper.committed_epoch == 3
        finally:
            snapper.close()
        version, _, meta = JobSnapshot(str(tmp_path / "snap")).restore()
        assert (version, meta["epoch"]) == (4, 3)

    def test_mark_restored_suppresses_recommit(self, tmp_path):
        snap = JobSnapshot(str(tmp_path / "snap"))
        snap.commit(_state(1.0), meta={"epoch": 1})
        snapper = Snapshotter(snap, every_epochs=0, every_s=0,
                              install_sigterm=False)
        try:
            snapper.mark_restored(1)
            snapper.capture(1, _state(1.0))
            assert snapper.finalize(deadline_s=10) is True
        finally:
            snapper.close()
        assert JobSnapshot(str(tmp_path / "snap")).restore()[0] == 1

    def test_writer_error_is_surfaced_not_fatal(self, tmp_path):
        snap = JobSnapshot(str(tmp_path / "gone"))
        shutil.rmtree(tmp_path / "gone")
        snapper = Snapshotter(snap, every_epochs=1, every_s=0,
                              install_sigterm=False)
        try:
            snapper.capture(0, _state(0.0), force=True)
            assert snapper.finalize(deadline_s=10) is False
            assert isinstance(snapper.last_error, FileNotFoundError)
            assert snapper.committed_epoch == -1
        finally:
            snapper.close()

    def test_wall_clock_cadence_from_the_job_setting(self, tmp_path,
                                                     monkeypatch):
        monkeypatch.setenv("DMLC_TPU_SNAP_EVERY_S", "0.01")
        snapper = Snapshotter(JobSnapshot(str(tmp_path / "snap")),
                              every_epochs=0, install_sigterm=False)
        try:
            time.sleep(0.05)
            assert snapper.capture(5, _state(5.0)) is True
        finally:
            snapper.close()


# ---------------------------------------------------------------------------
# preempt and the fault spec
# ---------------------------------------------------------------------------


class TestPreempt:
    def test_notice_poll_reset(self):
        assert not preempt.poll() and not preempt.requested()
        preempt.notice("test")
        assert preempt.poll() and preempt.requested()
        assert preempt.deadline_remaining() <= preempt.deadline_s()
        preempt.reset()
        assert not preempt.poll()
        assert preempt.deadline_remaining() == preempt.deadline_s()

    def test_injected_notice_via_faultpoint(self):
        resilience.configure("preempt.notice:nth=2")
        notices = preempt.stats()["notices"]
        assert not preempt.poll()
        assert preempt.poll()
        assert preempt.requested()
        assert preempt.stats()["notices"] == notices + 1
        assert resilience.faults.stats() == {
            "sites": ["preempt.notice"], "fired": [("preempt.notice", 2)]}

    def test_notice_from_the_job_setting(self, monkeypatch):
        monkeypatch.setenv("DMLC_TPU_FAULTS", "preempt.notice:nth=1")
        monkeypatch.setenv("DMLC_TPU_PREEMPT_DEADLINE_S", "7")
        resilience.reset()
        assert preempt.poll() and preempt.deadline_s() == 7.0

    def test_sigterm_handler_records_notice(self):
        assert preempt.install(deadline_s=30.0)
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.monotonic() + 5.0
            while not preempt.requested() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert preempt.requested()
        finally:
            preempt.uninstall()

    def test_preempted_is_systemexit_with_relaunch_code(self):
        assert EXIT_PREEMPTED == 75
        with pytest.raises(SystemExit) as excinfo:
            raise Preempted("mid-epoch")
        assert excinfo.value.code == EXIT_PREEMPTED

    @pytest.mark.parametrize("spec", [
        "io.read:p=0.3:seed=7;snap.commit:nth=3:times=2", "a:nth=1",
        "b:p=1", " ; c:nth=2 ;"])
    def test_spec_fires_as_the_reference_does(self, spec):
        """The same spec fires at the same passes in both packages."""
        got = resilience.parse_spec(spec)
        want = ref_resilience.parse_spec(spec)
        assert sorted(got) == sorted(want)
        for site in got:
            assert [got[site].should_fire() for _ in range(40)] == \
                [want[site].should_fire() for _ in range(40)], site

    @pytest.mark.parametrize("spec", ["x", "x:nth", "x:bad=1", "x:p=2",
                                      ":nth=1", "x:nth=a"])
    def test_bad_spec_raises(self, spec):
        with pytest.raises(resilience.FaultSpecError):
            resilience.parse_spec(spec)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _tree():
    rng = np.random.RandomState(3)
    return {"model": {"params": {"w": rng.randn(6).astype(np.float32),
                                 "b": np.array(0.25, np.float32),
                                 "v": rng.randn(6, 2).astype(np.float32)},
                      "velocity": {}},
            "epoch": 2, "history": [0.5, 0.25, 0.125], "rng": None,
            "audit": None}


def test_snapshot_directories_restore_across_packages(tmp_path):
    tree = _tree()
    for writer, reader in ((RefJobSnapshot, JobSnapshot),
                           (JobSnapshot, RefJobSnapshot)):
        uri = str(tmp_path / writer.__module__.replace(".", "_"))
        for rank in (1, 0):
            writer(uri, rank=rank, world_size=2).commit(
                dict(tree, rank=rank), meta={"epoch": 2})
        for rank in (0, 1):
            version, state, meta = reader(uri, rank=rank,
                                          world_size=2).restore()
            assert (version, meta["epoch"], state["rank"]) == (1, 2, rank)
            for k, v in tree["model"]["params"].items():
                got = state["model"]["params"][k]
                assert got.dtype == v.dtype and got.tobytes() == v.tobytes()
            assert state["history"] == tree["history"]


def test_equal_part_bytes_for_one_state_tree(tmp_path):
    tree = _tree()
    JobSnapshot(str(tmp_path / "port")).commit(tree, meta={"epoch": 2})
    RefJobSnapshot(str(tmp_path / "ref")).commit(tree, meta={"epoch": 2})
    for name in ("snap_v1.rank0", "snap_v1.manifest", "LATEST",
                 "snap.rank0.frontier"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


def test_jax_snapshot_audit_section_is_ignored(tmp_path):
    tree = dict(_tree(), audit={"model": {"head": "ab" * 8}})
    RefJobSnapshot(str(tmp_path / "snap")).commit(tree, meta={"epoch": 2})
    version, state, meta = load_snapshot(JobSnapshot(str(tmp_path / "snap")))
    assert version == 1 and state["audit"]["model"]["head"] == "ab" * 8


def test_rabit_blob_reads_both_ways(tmp_path):
    state = {"w": np.arange(3, dtype=np.float32), "round": 4}
    port_file = str(tmp_path / "port.ckpt")
    ref_file = str(tmp_path / "ref.ckpt")
    saved = [(mod._version, mod._checkpoint_blob)
             for mod in (collective, ref_collective)]
    try:
        for mod, path in ((collective, port_file),
                          (ref_collective, ref_file)):
            mod._version, mod._checkpoint_blob = 6, None
            mod.checkpoint(state, path)
            assert mod.version_number() == 7
        assert open(port_file, "rb").read() == open(ref_file, "rb").read()
        # restarted processes: no blob in memory, the other's file decides
        for mod, path in ((collective, ref_file),
                          (ref_collective, port_file)):
            mod._version, mod._checkpoint_blob = 0, None
            got = mod.load_checkpoint(path)
            assert mod.version_number() == 7 and got["round"] == 4
            np.testing.assert_array_equal(got["w"], state["w"])
        collective._checkpoint_blob = None
        assert collective.load_checkpoint(str(tmp_path / "none")) is None
    finally:
        for mod, (version, blob) in zip((collective, ref_collective), saved):
            mod._version, mod._checkpoint_blob = version, blob


def test_to_host_survives_an_in_place_step():
    batch = {"label": torch.tensor([1.0, 0.0]),
             "weight": torch.ones(2),
             "indices": torch.tensor([1, 2, 2, 3], dtype=torch.int32),
             "values": torch.ones(4),
             "offsets": torch.tensor([0, 2, 4], dtype=torch.int32)}
    params = init_fm_params(5, 2, 0.5, device="cpu")
    view = params["v"].numpy()  # what tensor.numpy() alone would capture
    captured = _to_host({"params": dict(params)})
    before = {k: v.copy() for k, v in captured["params"].items()}
    step = make_fm_train_step(None, 5, learning_rate=1.0, donate_batch=True)
    params, _ = step(params, batch)
    assert not np.array_equal(view, before["v"])  # the step reached the view
    for k, v in captured["params"].items():
        assert v.tobytes() == before[k].tobytes(), k


# ---------------------------------------------------------------------------
# the learners: injected preemption, then resume, bit-identical
# ---------------------------------------------------------------------------


def _linear_file(tmp_path):
    rng = np.random.RandomState(11)
    path = tmp_path / "fit.svm"
    with open(path, "w") as fh:
        for _ in range(160):
            x = rng.rand(4)
            fh.write("%d %s\n" % (int(x.sum() > 2), " ".join(
                f"{j}:{x[j]:.6f}" for j in range(4))))
    return str(path)


def _linear_fit(path, epochs, layout, **snap):
    learner = LinearLearner(device="cpu", learning_rate=0.5, momentum=0.5)
    history = learner.fit_uri(path, batch_size=16, epochs=epochs,
                              num_features=5, layout=layout,
                              drop_remainder=True, **snap)
    return params_to_numpy(learner.params), params_to_numpy(
        learner.velocity), history


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_linear_injected_preemption_resumes_bit_identical(tmp_path, layout):
    """10 steps an epoch: poll 25 is epoch 2, step 5, after the epoch-0
    and epoch-1 boundary snapshots; the relaunch replays epoch 2 whole."""
    path = _linear_file(tmp_path)
    clean = _linear_fit(path, 4, layout)
    snap_uri = str(tmp_path / "snap")
    resilience.configure("preempt.notice:nth=25")
    with pytest.raises(SystemExit) as excinfo:
        _linear_fit(path, 4, layout, snapshot_uri=snap_uri)
    assert excinfo.value.code == EXIT_PREEMPTED
    resilience.reset()
    preempt.reset()
    version, state, meta = JobSnapshot(snap_uri).restore()
    assert meta["epoch"] == 1 and len(state["history"]) == 2
    resumed = _linear_fit(path, 4, layout, snapshot_uri=snap_uri,
                          resume=True)
    assert resumed[2] == clean[2]
    for got, want in zip(resumed[:2], clean[:2]):
        for k in ("w", "b"):
            assert got[k].tobytes() == want[k].tobytes(), k


def test_linear_resume_after_a_finished_run_is_bit_identical(tmp_path):
    path = _linear_file(tmp_path)
    clean = _linear_fit(path, 4, "dense")
    snap_uri = str(tmp_path / "snap")
    part = _linear_fit(path, 2, "dense", snapshot_uri=snap_uri)
    resumed = _linear_fit(path, 4, "dense", snapshot_uri=snap_uri,
                          resume=True)
    assert resumed[2][:2] == part[2] and resumed[2] == clean[2]
    for k in ("w", "b"):
        assert resumed[0][k].tobytes() == clean[0][k].tobytes(), k
    with pytest.raises(DMLCError, match="snapshot_uri"):
        _linear_fit(path, 1, "dense", resume=True)


def test_linear_snapshot_cadence(tmp_path):
    """``snap_every_epochs=2`` commits epochs 0 and 2 of 3 (versions are
    epoch-derived: epoch 2 is v3), and keeps the captures in between
    uncommitted."""
    path = _linear_file(tmp_path)
    snap_uri = str(tmp_path / "snap")
    _linear_fit(path, 3, "dense", snapshot_uri=snap_uri, snap_every_epochs=2)
    version, state, meta = JobSnapshot(snap_uri).restore()
    assert (version, meta["epoch"], len(state["history"])) == (3, 2, 3)
    assert not exists(str(tmp_path / "snap" / "snap_v2.manifest"))


def _write_libfm(path, rows, nf, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for _ in range(rows):
            ids = np.sort(rng.choice(np.arange(1, nf), 5, replace=False))
            vals = rng.rand(5)
            fh.write("%d %s\n" % (int(ids[0] % 2 == ids[1] % 2), " ".join(
                "%d:%d:%.4f" % (f, j, v)
                for f, (j, v) in enumerate(zip(ids, vals)))))
    return str(path)


def _fm_fit(path, nf, epochs, start, snap_uri=None, resume=False):
    learner = FMLearner(device="cpu", num_features=nf, num_factors=3,
                        learning_rate=0.3, l2=0.001)
    learner.params = fm_params_from_numpy(start, "cpu")
    feed = DeviceFeed(create_parser(path, 0, 1, "libfm", device="cpu"),
                      BatchSpec(batch_size=16, layout="csr",
                                num_features=nf, drop_remainder=True),
                      device="cpu")
    snapshotter, start_epoch, history = None, 0, None
    try:
        if snap_uri is not None:
            snap = JobSnapshot(snap_uri)
            snapshotter = Snapshotter(snap)
            if resume:
                version, state, _ = load_snapshot(snap)
                learner.restore_snapshot_model(state["model"])
                start_epoch = state["epoch"] + 1
                history = state["history"]
                snapshotter.mark_restored(state["epoch"])
        history = learner.fit_feed(feed, epochs, snapshotter=snapshotter,
                                   start_epoch=start_epoch, history=history)
    finally:
        if snapshotter is not None:
            snapshotter.close()
        feed.close()
    return fm_params_to_numpy(learner.params), history


def test_fm_injected_preemption_resumes_bit_identical(tmp_path):
    nf = 50
    path = _write_libfm(tmp_path / "fm.libfm", 160, nf, 4)
    start = fm_params_to_numpy(init_fm_params(nf, 3, 0.1, seed=1,
                                              device="cpu"))
    clean = _fm_fit(path, nf, 3, start)
    snap_uri = str(tmp_path / "snap")
    resilience.configure("preempt.notice:nth=15")  # epoch 1, step 5
    with pytest.raises(Preempted) as excinfo:
        _fm_fit(path, nf, 3, start, snap_uri)
    assert excinfo.value.code == EXIT_PREEMPTED
    resilience.reset()
    preempt.reset()
    assert JobSnapshot(snap_uri).restore()[2]["epoch"] == 0
    resumed = _fm_fit(path, nf, 3, start, snap_uri, resume=True)
    assert resumed[1] == clean[1] and len(clean[1]) == 3
    for k in ("w", "b", "v"):
        assert resumed[0][k].tobytes() == clean[0][k].tobytes(), k

"""The port's worker autoscaler (``dmlc_tpu_torch/data/autoscale.py``) on
the CPU: the JAX package's autoscaler cases (from ``tests/test_dispatcher
.py``) against a fake dispatcher, the JAX package's scale-event chaos case
on a real port fleet, and one decision sequence held step for step
against the JAX package's controller."""

import hashlib

import numpy as np
import pytest

from dmlc_tpu_torch import resilience
from dmlc_tpu_torch.data import (BlockService, DataDispatcher,
                                 RemoteBlockParser, WorkerAutoscaler,
                                 reset_source_cache)


@pytest.fixture(autouse=True)
def _clean_state():
    resilience.reset()
    reset_source_cache()
    yield
    resilience.reset()
    reset_source_cache()


class _FakeDispatcher:
    """Just enough of DataDispatcher's surface for the autoscaler."""

    def __init__(self, queued, workers):
        self.queued = queued
        self.workers = workers  # wid -> {"live","draining","leased"}
        self.drained = []

    def snapshot(self):
        return {"chunks": {"queued": self.queued},
                "workers": {str(w): dict(info)
                            for w, info in self.workers.items()}}

    def drain_worker(self, wid):
        self.drained.append(wid)
        self.workers[wid]["draining"] = True


class _FakeWorker:
    def __init__(self, wid):
        self._worker_id = wid
        self.closed = False

    def close(self):
        self.closed = True


class TestWorkerAutoscaler:
    def test_scales_up_one_per_tick_to_backlog(self):
        from dmlc_tpu_torch.data import WorkerAutoscaler

        disp = _FakeDispatcher(queued=8, workers={
            0: {"live": True, "draining": False, "leased": 0}})
        spawned = []

        def spawn():
            wid = len(spawned) + 1
            disp.workers[wid] = {"live": True, "draining": False,
                                 "leased": 0}
            handle = _FakeWorker(wid)
            spawned.append(handle)
            return handle

        scaler = WorkerAutoscaler(disp, spawn, min_workers=1, max_workers=3,
                                  backlog_per_worker=4)
        step = scaler.step()
        assert step["want"] == 2 and step["spawned"] == 1
        assert scaler.step()["spawned"] == 0  # want == live: steady state
        disp.queued = 40
        assert scaler.step()["want"] == 3  # capped at max_workers
        assert len(spawned) == 2
        scaler.close()

    def test_drains_least_loaded_and_reaps(self):
        from dmlc_tpu_torch.data import WorkerAutoscaler

        disp = _FakeDispatcher(queued=0, workers={
            0: {"live": True, "draining": False, "leased": 3},
            1: {"live": True, "draining": False, "leased": 1},
            2: {"live": True, "draining": False, "leased": 1}})
        handle = _FakeWorker(2)
        scaler = WorkerAutoscaler(disp, spawn=lambda: None, min_workers=1,
                                  max_workers=3, backlog_per_worker=4)
        scaler._handles[2] = handle
        scaler.step()
        # least leases, ties to the HIGHEST wid: 2 drains before 1
        assert disp.drained == [2]
        assert scaler.step()["draining"] >= 1
        # the dispatcher delists it once drained; the reaper closes it
        del disp.workers[2]
        scaler.step()
        assert handle.closed and 2 not in scaler._handles
        scaler.close()

    def test_drain_fault_is_retried_next_tick(self):
        from dmlc_tpu_torch.data import WorkerAutoscaler

        disp = _FakeDispatcher(queued=0, workers={
            0: {"live": True, "draining": False, "leased": 0},
            1: {"live": True, "draining": False, "leased": 0}})
        real_drain, calls = disp.drain_worker, []

        def flaky_drain(wid):
            calls.append(wid)
            if len(calls) == 1:
                raise OSError("injected fault: scale.drain")
            real_drain(wid)

        disp.drain_worker = flaky_drain
        scaler = WorkerAutoscaler(disp, spawn=lambda: None, min_workers=1,
                                  max_workers=2, backlog_per_worker=4)
        scaler.step()   # drain raises: swallowed, no state change
        assert not disp.drained
        scaler.step()   # retried
        assert disp.drained == [1]
        scaler.close()


def _epoch(disp, scaler=None):
    """Drain the default job through one consumer; with ``scaler``, step
    it once the backlog has fallen. Returns the order-insensitive
    aggregate's digest."""
    parser = RemoteBlockParser(disp.address, dispatcher=True, device="cpu")
    agg = np.zeros(3)
    for nblock, block in enumerate(parser):
        agg[0] += np.sum(np.asarray(block.label))
        agg[1] += np.sum(np.asarray(block.value))
        agg[2] += len(block)
        if scaler is not None and nblock >= 3:
            scaler.step()
    parser.close()
    assert disp.join(timeout=30), disp.snapshot()
    return hashlib.sha256(agg.tobytes()).hexdigest()


def test_scale_event_mid_epoch_exactly_once(tmp_path):
    """The JAX package's ``test_chaos_scale_event_bit_identical`` on the
    port: the autoscaler grows the fleet on backlog and drains a worker
    back down mid-epoch; the consumer fails over off the retiring worker
    and the aggregate equals a clean one-worker run's."""
    path = tmp_path / "scale.svm"
    with open(path, "w") as fh:
        for i in range(40):
            fh.write(f"{i % 3} 1:{i}\n")

    def worker(disp):
        return BlockService(dispatcher=disp.address, nthread=1, device="cpu")

    with DataDispatcher(str(path), nchunks=8) as disp:
        with worker(disp):
            clean = _epoch(disp)
    reset_source_cache()
    with DataDispatcher(str(path), nchunks=8, lease_s=1.0,
                        dead_after_s=0.75) as disp:
        seed = worker(disp)
        scaler = WorkerAutoscaler(disp, spawn=lambda: worker(disp),
                                  min_workers=1, max_workers=2,
                                  backlog_per_worker=4)
        try:
            assert scaler.step()["spawned"] == 1  # backlog 8 -> 2 workers
            digest = _epoch(disp, scaler)
            snap = disp.snapshot()
        finally:
            scaler.close(retire_spawned=True)
            seed.close()
    assert digest == clean
    assert snap["chunks"] == {"total": 8, "queued": 0, "leased": 0,
                              "delivered": 0, "acked": 8}
    assert any(w["draining"] or not w["live"]
               for w in snap["workers"].values()), snap["workers"]


@pytest.mark.parametrize("queued", [0, 3, 8, 40])
def test_decisions_equal_the_jax_controllers(queued):
    """Both packages' controllers over the same fake fleet take the same
    decision at each of five ticks."""
    from dmlc_tpu.data import WorkerAutoscaler as RefAutoscaler

    def run(cls):
        disp = _FakeDispatcher(queued=queued, workers={
            0: {"live": True, "draining": False, "leased": 2},
            1: {"live": True, "draining": False, "leased": 0}})

        def spawn():
            wid = max(disp.workers) + 1
            disp.workers[wid] = {"live": True, "draining": False,
                                 "leased": 0}
            return _FakeWorker(wid)

        scaler = cls(disp, spawn, min_workers=1, max_workers=4,
                     backlog_per_worker=4)
        steps = [scaler.step() for _ in range(5)]
        scaler.close()
        return steps, disp.drained, sorted(disp.workers)

    assert run(WorkerAutoscaler) == run(RefAutoscaler)


def test_interval_knob(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_DATA_SCALE_INTERVAL_S", "0.25")
    scaler = WorkerAutoscaler(_FakeDispatcher(0, {}), spawn=lambda: None)
    assert scaler.interval_s == 0.25
    assert WorkerAutoscaler(_FakeDispatcher(0, {}), spawn=lambda: None,
                            interval_s=0.01).interval_s == 0.05

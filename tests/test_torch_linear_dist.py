"""The port's distributed linear training at world 2, one process a rank,
against the JAX package's.

- The data-parallel step (``make_linear_train_step(group)``: local
  gradients, one ``bucketed_all_reduce`` over gloo, the update) against the
  JAX package's mesh step (``make_linear_train_step(mesh)``: a bucketed
  psum in a shard_map) on a 2-device virtual CPU mesh, the two ranks'
  batches being the two shards of the mesh's batch. Dense and csr, each
  objective, with and without momentum. Integer-valued data, integer
  params and powers of two for the batch weight, learning rate, l2 and
  momentum: with the squared and hinge objectives every value is exact in
  f32, so the steps must agree bit for bit; the logistic objective is held
  to rtol 1e-5 / atol 1e-6 (the dense gradient sums in another order, and
  the two packages' exp differ by an ulp).
- ``LinearLearner.fit_uri`` at world 2 from one LibSVM file, each rank
  reading its own byte range: ``sync="spmd"`` over a gloo group and
  ``sync="host"`` over the port's tracker and socket engine. Every rank
  ends with the same bits, the two flavors give the same bits (at world 2
  each element is one addition, a + b, on either route), and both are
  within a relative norm of 1e-5 of the JAX package's ``sync="host"`` fit
  under its own tracker and engine (two epochs of logistic SGD: the
  gradients sum in another f32 order and exp comes from another library).
  The dense bucket (17 + 3 floats) takes the socket engine's tree and the
  csr bucket (2^19 + 4 floats, 2 MiB + 16 bytes) its ring.

Trackers here bind ports 21200-21399; no other test file uses them.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from dmlc_tpu.models import make_linear_train_step as ref_make_step
from dmlc_tpu.tracker.rendezvous import RabitTracker as RefTracker
from dmlc_tpu_torch.collective import SocketEngine
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.tracker import RabitTracker

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_NF = {"dense": 17, "csr": 4097}
FIT_NF = {"dense": 17, "csr": (1 << 19) + 1}
ROWS_PER_RANK = 64
FIT_ROWS, FIT_BATCH, FIT_EPOCHS = 300, 32, 2
FIT_HYPER = dict(objective="logistic", learning_rate=0.5, l2=0.01,
                 momentum=0.5)
STEP_CASES = [(layout, objective, momentum)
              for layout in ("dense", "csr")
              for objective in ("logistic", "squared", "hinge")
              for momentum in (0.0, 0.5)]


def _case_name(case):
    layout, objective, momentum = case
    return f"{layout}-{objective}-m{momentum}"


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _dense_batch(rng, nf):
    return {"x": rng.randint(-2, 3, (ROWS_PER_RANK, nf)).astype(np.float32),
            "label": rng.randint(0, 2, ROWS_PER_RANK).astype(np.float32),
            "weight": np.ones(ROWS_PER_RANK, np.float32)}


def _csr_batch(rng, nf, bucket):
    counts = rng.randint(1, 9, ROWS_PER_RANK)
    nnz = int(counts.sum())
    indices = np.zeros(bucket, np.int32)
    values = np.zeros(bucket, np.float32)
    indices[:nnz] = np.concatenate(
        [np.sort(rng.choice(np.arange(1, nf), c, replace=False))
         for c in counts])
    values[:nnz] = rng.randint(-2, 3, nnz)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return {"label": rng.randint(0, 2, ROWS_PER_RANK).astype(np.float32),
            "weight": np.ones(ROWS_PER_RANK, np.float32),
            "indices": indices, "values": values, "offsets": offsets}


def _step_inputs():
    """{case/...: array}: each case's initial params and velocity and, for
    each of two steps, rank 0's and rank 1's batch. The csr batches share
    one bucket (a multiple of 256), so they stack into the mesh's batch."""
    arrays = {}
    for i, case in enumerate(STEP_CASES):
        layout = case[0]
        nf = STEP_NF[layout]
        rng = np.random.RandomState(30 + i)
        name = _case_name(case)
        arrays[f"{name}/w"] = rng.randint(-1, 2, nf).astype(np.float32)
        arrays[f"{name}/b"] = np.float32(1.0)
        arrays[f"{name}/vw"] = rng.randint(-1, 2, nf).astype(np.float32)
        arrays[f"{name}/vb"] = np.float32(-1.0)
        for s in range(2):
            for r in range(2):
                batch = (_dense_batch(rng, nf) if layout == "dense"
                         else _csr_batch(rng, nf, 768))
                for k, v in batch.items():
                    arrays[f"{name}/step{s}/rank{r}/{k}"] = v
    return arrays


def _write_libsvm(path, rows, nf, seed):
    rng = np.random.RandomState(seed)
    true_w = rng.randn(nf)
    lines = []
    for _ in range(rows):
        ids = np.sort(rng.choice(np.arange(1, nf), 8, replace=False))
        vals = rng.randn(8)
        label = int(vals @ true_w[ids] + 0.5 * rng.randn() > 0)
        lines.append("%d %s" % (label, " ".join(
            "%d:%.5f" % (j, v) for j, v in zip(ids, vals))))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

_PORT_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlc_tpu_torch import collective
from dmlc_tpu_torch.models import (LinearLearner, make_linear_train_step,
                                   params_to_numpy)
from dmlc_tpu_torch.parallel import distributed


def tensors(arrays, prefix):
    n = len(prefix)
    return {k[n:]: torch.from_numpy(np.array(v)) for k, v in arrays.items()
            if k.startswith(prefix)}


def main(rank, world, tmp, tracker_port):
    torch.set_num_threads(1)
    spec = json.load(open(f"{tmp}/spec.json"))
    distributed.initialize(f"file://{tmp}/pg", world, rank, device="cpu")
    out = {}
    # the data-parallel step against the mesh step
    arrays = np.load(f"{tmp}/steps.npz")
    for name, layout, objective, momentum in spec["step_cases"]:
        step = make_linear_train_step(
            dist.group.WORLD, objective=objective, learning_rate=0.125,
            l2=0.5, momentum=momentum, layout=layout,
            num_features=spec["step_nf"][layout])
        for s in range(2):
            params = {"w": torch.tensor(arrays[f"{name}/w"]),
                      "b": torch.tensor(arrays[f"{name}/b"])}
            velocity = {"w": torch.tensor(arrays[f"{name}/vw"]),
                        "b": torch.tensor(arrays[f"{name}/vb"])}
            batch = tensors(arrays, f"{name}/step{s}/rank{rank}/")
            p, v, m = step(params, velocity, batch)
            for k in ("w", "b"):
                out[f"{name}/step{s}/{k}"] = p[k].numpy()
                out[f"{name}/step{s}/v{k}"] = v[k].numpy()
            for k in ("loss_sum", "weight_sum"):
                out[f"{name}/step{s}/{k}"] = m[k].numpy()
    # fit_uri, sync="spmd" over the gloo group, then sync="host" over the
    # tracker's socket engine
    collective.init()
    out["spmd/engine"] = np.array(collective.engine_kind())
    for sync in ("spmd", "host"):
        if sync == "host":
            collective.finalize()
            collective.init("socket", tracker_uri="127.0.0.1",
                            tracker_port=tracker_port, rank=rank,
                            world_size=world)
            out["host/engine"] = np.array(collective.engine_kind())
        for layout in ("dense", "csr"):
            group = dist.group.WORLD if sync == "spmd" else None
            learner = LinearLearner(device="cpu", group=group, sync=sync,
                                    **spec["hyper"])
            history = learner.fit_uri(
                spec["files"][layout], batch_size=spec["batch"],
                epochs=spec["epochs"], layout=layout,
                num_features=spec["fit_nf"][layout], drop_remainder=True)
            got = params_to_numpy(learner.params)
            out[f"{sync}/{layout}/history"] = np.array(history)
            out[f"{sync}/{layout}/w"] = got["w"]
            out[f"{sync}/{layout}/b"] = got["b"]
    collective.finalize()
    distributed.shutdown()
    np.savez(f"{tmp}/port{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
'''

# The JAX package's sync="host" fit: its LinearLearner.fit_uri, with the
# feed built here (unthreaded parser, no prefetch thread) so that it is
# closed; the part is the rank's, as fit_uri's default.
_REF_WORKER = r'''
import json, sys
import numpy as np
from dmlc_tpu import collective
from dmlc_tpu.data import create_parser
from dmlc_tpu.device import BatchSpec, DeviceFeed
from dmlc_tpu.models import LinearLearner


def main(rank, world, tmp, tracker_port):
    spec = json.load(open(f"{tmp}/spec.json"))
    collective.init("socket", tracker_uri="127.0.0.1",
                    tracker_port=tracker_port, rank=rank, world_size=world)
    out = {}
    for layout in ("dense", "csr"):
        learner = LinearLearner(None, sync="host", **spec["hyper"])
        feed = DeviceFeed(
            create_parser(spec["files"][layout], collective.rank(),
                          collective.world_size(), threaded=False),
            BatchSpec(batch_size=spec["batch"], layout=layout,
                      num_features=spec["fit_nf"][layout],
                      drop_remainder=True),
            host_prefetch=0)
        try:
            history = learner.fit_feed(feed, epochs=spec["epochs"])
        finally:
            feed.close()
        out[f"{layout}/history"] = np.array(history)
        out[f"{layout}/w"] = np.asarray(learner.params["w"])
        out[f"{layout}/b"] = np.asarray(learner.params["b"])
    collective.finalize()
    np.savez(f"{tmp}/ref{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
'''


def _spawn(worker, rank, tmp, port, env_extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra)
    return subprocess.Popen(
        [sys.executable, "-c", worker, str(rank), "2", str(tmp), str(port)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    files = {layout: _write_libsvm(tmp / f"{layout}.svm", FIT_ROWS,
                                   FIT_NF[layout], 40 + i)
             for i, layout in enumerate(("dense", "csr"))}
    spec = {"step_cases": [[_case_name(c), *c] for c in STEP_CASES],
            "step_nf": STEP_NF, "fit_nf": FIT_NF, "files": files,
            "batch": FIT_BATCH, "epochs": FIT_EPOCHS, "hyper": FIT_HYPER}
    (tmp / "spec.json").write_text(json.dumps(spec))
    arrays = _step_inputs()
    np.savez(tmp / "steps.npz", **arrays)
    trackers = [RabitTracker("127.0.0.1", 2, port=21200, port_end=21300),
                RefTracker("127.0.0.1", 2, port=21300, port_end=21400)]
    ref_env = {"JAX_PLATFORMS": "cpu", "DMLC_TPU_PARSE_BACKEND": "vector",
               "DMLC_TPU_NATIVE": "0"}
    procs = []
    try:
        for tracker in trackers:
            tracker.start()
        procs = [_spawn(_PORT_WORKER, r, tmp, trackers[0].port, {})
                 for r in range(2)]
        procs += [_spawn(_REF_WORKER, r, tmp, trackers[1].port, ref_env)
                  for r in range(2)]
        logs = [p.communicate(timeout=180)[0] for p in procs]
        for tracker in trackers:
            tracker.thread.join(10)
            assert not tracker.alive(), "a tracker still waits for shutdowns"
    finally:
        for p in procs:
            p.kill()
        for tracker in trackers:
            tracker.close()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return {"arrays": arrays, "files": files,
            "port": [dict(np.load(tmp / f"port{r}.npz")) for r in range(2)],
            "ref": [dict(np.load(tmp / f"ref{r}.npz")) for r in range(2)]}


# ---------------------------------------------------------------------------
# the data-parallel step against the JAX package's mesh step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", STEP_CASES, ids=_case_name)
def test_data_parallel_step_matches_reference_mesh(world2, case):
    layout, objective, momentum = case
    name = _case_name(case)
    arrays = world2["arrays"]
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    step = ref_make_step(mesh, objective=objective, learning_rate=0.125,
                         l2=0.5, momentum=momentum, layout=layout,
                         num_features=STEP_NF[layout])
    exact = objective != "logistic"
    for s in range(2):
        prefix = [f"{name}/step{s}/rank{r}/" for r in range(2)]
        keys = [k[len(prefix[0]):] for k in arrays if
                k.startswith(prefix[0])]
        # the mesh's batch: the ranks' batches as its two shards
        batch = {k: jnp.asarray(np.concatenate(
            [arrays[p + k] for p in prefix])) for k in keys}
        params = {"w": jnp.asarray(arrays[f"{name}/w"]),
                  "b": jnp.asarray(arrays[f"{name}/b"])}
        velocity = {"w": jnp.asarray(arrays[f"{name}/vw"]),
                    "b": jnp.asarray(arrays[f"{name}/vb"])}
        rp, rv, rm = step(params, velocity, batch)
        want = {"w": rp["w"], "b": rp["b"], "vw": rv["w"], "vb": rv["b"],
                "loss_sum": rm["loss_sum"], "weight_sum": rm["weight_sum"]}
        for rank in range(2):
            got = world2["port"][rank]
            for k, ref in want.items():
                ref = np.asarray(ref)
                mine = got[f"{name}/step{s}/{k}"]
                assert mine.dtype == ref.dtype and mine.shape == ref.shape
                if exact:
                    assert mine.tobytes() == ref.tobytes(), (rank, s, k)
                else:
                    np.testing.assert_allclose(mine, ref, rtol=1e-5,
                                               atol=1e-6)
            if rank == 1:
                for k in want:
                    assert got[f"{name}/step{s}/{k}"].tobytes() == \
                        world2["port"][0][f"{name}/step{s}/{k}"].tobytes()
        assert float(rm["weight_sum"]) == 2 * ROWS_PER_RANK


# ---------------------------------------------------------------------------
# fit_uri at world 2
# ---------------------------------------------------------------------------


def _param_rel_err(a, ref):
    x = np.append(a["w"], a["b"]).astype(np.float64)
    r = np.append(ref["w"], ref["b"]).astype(np.float64)
    return float(np.linalg.norm(x - r) / np.linalg.norm(r))


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_fit_world2_parts_take_equal_steps(world2, layout):
    """The precondition of a world-2 fit: each rank's byte-range part gives
    the same number of full batches (a rank with a batch more would wait
    for ever in its extra allreduce), and the two parts hold every row.
    The bucket takes the tree (dense) or the ring (csr)."""
    rows = []
    for part in range(2):
        parser = create_parser(world2["files"][layout], part, 2,
                               device="cpu")
        try:
            rows.append(sum(len(b) for b in parser))
        finally:
            parser.close()
    assert sum(rows) == FIT_ROWS
    assert rows[0] // FIT_BATCH == rows[1] // FIT_BATCH >= 3, rows
    ring = (FIT_NF[layout] + 3) * 4 >= SocketEngine.ring_threshold_bytes
    assert ring == (layout == "csr")


@pytest.mark.parametrize("sync", ["spmd", "host"])
@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_fit_world2_ranks_agree_and_match_reference(world2, layout, sync):
    port, ref = world2["port"], world2["ref"]
    assert str(port[0][f"{sync}/engine"]) == (
        "device" if sync == "spmd" else "socket")
    key = f"{sync}/{layout}"
    for k in ("w", "b", "history"):
        assert port[0][f"{key}/{k}"].tobytes() == \
            port[1][f"{key}/{k}"].tobytes(), k
        assert ref[0][f"{layout}/{k}"].tobytes() == \
            ref[1][f"{layout}/{k}"].tobytes(), k
    got = {k: port[0][f"{key}/{k}"] for k in ("w", "b")}
    want = {k: ref[0][f"{layout}/{k}"] for k in ("w", "b")}
    assert got["w"].shape == (FIT_NF[layout],) and got["b"].shape == ()
    assert _param_rel_err(got, want) <= 1e-5
    history = port[0][f"{key}/history"]
    np.testing.assert_allclose(history, ref[0][f"{layout}/history"],
                               rtol=1e-5)
    assert len(history) == FIT_EPOCHS and history[1] < history[0]


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_fit_world2_spmd_and_host_bit_identical(world2, layout):
    for rank in range(2):
        got = world2["port"][rank]
        for k in ("w", "b", "history"):
            assert got[f"spmd/{layout}/{k}"].tobytes() == \
                got[f"host/{layout}/{k}"].tobytes(), (rank, k)

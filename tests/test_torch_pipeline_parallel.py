"""The port's GPipe pipeline (``dmlc_tpu_torch/ops/pipeline_parallel.py``)
and the collectives it and the MoE layer add to ``parallel/axis.py``
(``psum``, ``pmean``, ``pvary``, ``ppermute`` over explicit pairs),
against ``dmlc_tpu.ops.pipeline_parallel`` on the same numpy inputs.

Every case of tests/test_pipeline_parallel.py and the pipeline cases of
tests/test_mesh_composition.py run as real ranks: one ``python -c``
process per rank over gloo on the CPU at world 2 and world 4 (dp × pp as
2 × 2 sub-groups), and in this process at world 1 with no process group.
Each rank passes its stage (``shard_pipeline_params``) and the batch (its
dp shard under dp × pp) and saves the output and the gradients of
sum(out²) w.r.t. its stage and x; the test holds them against the JAX
package's sharded pipeline (``make_pipeline`` on a mesh of the first n
virtual CPU devices) under ``jax.grad`` of the same loss, and against
``pipeline_oracle``.

Tolerances: outputs rtol 2e-5 / atol 2e-6, the reference's own
(tests/test_pipeline_parallel.py). Gradients against the JAX package's
pipeline rtol 1e-4 / atol 1e-5: the same schedule, with f32 products
summed in another order by torch's matmul and XLA's dot (the reference's
2e-3 / 2e-4 is its pipeline against the sequential fold).

The collectives' backward: ``psum``'s is the identity and ``pmean``'s is
×1/n, with no communication (each rank holds the whole replicated
cotangent; an all-reduce there would scale every gradient by the world
size), ``pvary``'s sums over the group, and ``ppermute`` over the open
pairs sends a zero cotangent to the rank that received nothing.
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
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dmlc_tpu.ops import pipeline_parallel as jpp
from dmlc_tpu_torch.ops import pipeline_parallel as tpp
from dmlc_tpu_torch.parallel import axis
from dmlc_tpu_torch.utils import DMLCError

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# Run by every rank: the collectives' cases, then each pipeline case over
# this rank's groups; saves outputs and gradients (or the error's message).
_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlc_tpu_torch.ops.pipeline_parallel import (
    make_pipeline, shard_pipeline_params)
from dmlc_tpu_torch.parallel import axis
from dmlc_tpu_torch.utils import DMLCError

STAGES = {
    "mlp": lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
    "norm": lambda p, x: (x / torch.linalg.norm(x, dim=-1, keepdim=True))
    @ p["w"],
    "matmul": lambda p, x: x @ p["w"],
}


def collectives(rank, world, saved):
    """psum, pmean, pvary and the open ppermute, forward and backward."""
    c = torch.tensor([1.0, 2.0, 3.0])
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = axis.psum(x)
    (y * c).sum().backward()
    saved["psum/y"], saved["psum/dx"] = y.detach().numpy(), x.grad.numpy()
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = axis.pmean(x)
    (y * c).sum().backward()
    saved["pmean/y"], saved["pmean/dx"] = y.detach().numpy(), x.grad.numpy()
    w = torch.ones(3, requires_grad=True)
    (v,) = axis.pvary([w], [(None,)])
    (v * (rank + 1)).sum().backward()
    saved["pvary/dw"] = w.grad.numpy()
    # the pipeline's hand-off: stage i sends to i + 1
    x = torch.full((2,), float(rank + 1), requires_grad=True)
    perm = [(i, i + 1) for i in range(world - 1)]
    y = axis.ppermute(x, perm=perm)
    (y * (rank + 1)).sum().backward()
    saved["open/y"], saved["open/dx"] = y.detach().numpy(), x.grad.numpy()
    # the ring, both ways
    x = torch.full((2,), float(rank + 1), requires_grad=True)
    y = axis.ppermute(x, shift=-1)
    (y * (rank + 1)).sum().backward()
    saved["ring/y"], saved["ring/dx"] = y.detach().numpy(), x.grad.numpy()


def run_cases(rank, world, tmp):
    torch.set_num_threads(1)
    groups = {}
    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=world)
        if world == 4:
            # the pipelines are the rows of the 2 x 2 mesh, dp its columns
            rows = [dist.new_group([0, 1]), dist.new_group([2, 3])]
            cols = [dist.new_group([0, 2]), dist.new_group([1, 3])]
            groups = {"pp": rows[rank // 2], "dp": cols[rank % 2]}
    saved = {}
    collectives(rank, world, saved)
    specs = json.load(open(f"{tmp}/cases.json"))
    arrays = np.load(f"{tmp}/cases.npz")
    for spec in specs:
        name, dp = spec["name"], spec.get("dp", 1)
        group, batch_group = ((groups["pp"], groups["dp"]) if dp > 1
                              else (None, None))
        try:
            whole = {k: torch.from_numpy(arrays[f"{name}/{k}"])
                     for k in spec["keys"]}
            if spec.get("error") == "whole_params":
                params = whole  # every stage, not this rank's
            else:
                params = shard_pipeline_params(whole, group)
            params = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            x = torch.from_numpy(arrays[f"{name}/x"])
            if dp > 1:
                b = x.shape[0] // dp
                row = rank // 2
                x = x[row * b:(row + 1) * b]
            x = x.clone().requires_grad_(True)
            pipe = make_pipeline(group, STAGES[spec["stage"]], spec["m"],
                                 batch_group=batch_group)
            out = pipe(params, x)
            (out ** 2).sum().backward()
        except DMLCError as err:
            saved[f"{name}/error"] = np.array(str(err).splitlines()[0])
            continue
        saved[f"{name}/out"] = out.detach().numpy()
        saved[f"{name}/dx"] = x.grad.numpy()
        for k, v in params.items():
            saved[f"{name}/d{k}"] = v.grad.numpy()
    np.savez(f"{tmp}/rank{rank}.npz", **saved)
    if world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    run_cases(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
'''


def _case(name, stage, n, d, batch, m, seed, **extra):
    keys = ("w",) if stage in ("norm", "matmul") else ("w", "b")
    return dict(name=name, stage=stage, n=n, d=d, batch=batch, m=m,
                seed=seed, keys=keys, **extra)


def _cases(world):
    """tests/test_pipeline_parallel.py's cases with world stages (its
    8-device mesh is world ranks here); under dp × pp the stages are the
    2 of a row."""
    n = world
    cases = [_case(f"matches_sequential_oracle_m{m}", "mlp", n, 16, 32, m, 0)
             for m in (1, 4, 8)]
    cases += [
        _case("gradients_match_oracle", "mlp", n, 8, 16, 4, 2),
        _case("zero_singular_stage_keeps_finite_gradients", "norm", n, 8,
              16, 4, 4),
        _case("err_batch_does_not_divide", "mlp", n, 8, 7, 4, 3,
              error="batch", message="microbatches"),
        _case("err_whole_params", "mlp", n + 1, 8, 8, 4, 3,
              error="whole_params", message="lead dim"),
    ]
    if n > 1:
        cases.append(_case("err_stage_count", "mlp", n + 1, 8, 8, 4, 3,
                           error="stages", message="pipeline stages"))
    if n == 4:
        # tests/test_mesh_composition.py: dp 2 x pp 2
        cases += [
            _case("pipeline_with_dp_sharded_batch", "mlp", 2, 8, 16, 4, 3,
                  dp=2),
            _case("err_per_shard_microbatches", "matmul", 2, 4, 4, 4, 5,
                  dp=2, error="per_shard", message="per-shard batch 2"),
        ]
    return cases


def _case_arrays(c):
    rng = np.random.RandomState(c["seed"])
    n, d = c["n"], c["d"]
    if c["stage"] == "mlp":
        params = {"w": rng.randn(n, d, d).astype(np.float32) * 0.3,
                  "b": rng.randn(n, d).astype(np.float32) * 0.1}
    elif c["stage"] == "norm":
        params = {"w": rng.randn(n, d, d).astype(np.float32) * 0.5}
    else:
        params = {"w": np.zeros((n, d, d), np.float32)}
    x = rng.randn(c["batch"], d).astype(np.float32)
    return {**params, "x": x}


def _write_cases(world, tmp):
    cases = _cases(world)
    (tmp / "cases.json").write_text(json.dumps(cases))
    arrays = {f"{c['name']}/{k}": v for c in cases
              for k, v in _case_arrays(c).items()}
    np.savez(tmp / "cases.npz", **arrays)
    return {c["name"]: c for c in cases}


def _spawn_ranks(world, tmp):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(tmp)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: ({case name: spec}, [per-rank results])} for worlds 1, 2, 4
    (worlds 2 and 4 as rank processes, all started together; world 1 here
    with no process group)."""
    tmps = {w: tmp_path_factory.mktemp(f"pp_w{w}") for w in (1, 2, 4)}
    specs = {w: _write_cases(w, tmps[w]) for w in tmps}
    procs = [p for w in (2, 4) for p in _spawn_ranks(w, tmps[w])]
    try:
        namespace = {"__name__": "worker"}
        exec(compile(_WORKER, "worker", "exec"), namespace)
        namespace["run_cases"](0, 1, str(tmps[1]))
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return {w: (specs[w], [dict(np.load(tmps[w] / f"rank{r}.npz"))
                           for r in range(w)]) for w in tmps}


JAX_STAGES = {
    "mlp": lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
    "norm": lambda p, x: (x / jnp.linalg.norm(x, axis=-1, keepdims=True))
    @ p["w"],
}


def _jax_pipeline(spec, arrays, world):
    """The JAX package's pipeline on the world's devices (dp × pp as 2 × 2):
    out and the gradients of sum(out²) w.r.t. x and the stacked params."""
    dp = spec.get("dp", 1)
    devs = np.asarray(jax.devices()[:world])
    if dp > 1:
        mesh = Mesh(devs.reshape(dp, world // dp), ("dp", "pp"))
    else:
        mesh = Mesh(devs, ("pp",))
    batch_axis = "dp" if dp > 1 else None
    stage = JAX_STAGES[spec["stage"]]
    pipe = jpp.make_pipeline(mesh, stage, spec["m"], batch_axis=batch_axis)

    def loss(params, x):
        out = pipe(jpp.shard_pipeline_params(params, mesh),
                   jax.device_put(x, NamedSharding(mesh, P(batch_axis))))
        return jnp.sum(jnp.asarray(out) ** 2), out

    params = {k: jnp.asarray(arrays[k]) for k in spec["keys"]}
    (_, out), (dparams, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(arrays["x"]))
    oracle = jpp.pipeline_oracle(stage, params, jnp.asarray(arrays["x"]))
    want = {"out": out, "dx": dx, "oracle": oracle,
            **{f"d{k}": v for k, v in dparams.items()}}
    return {k: np.asarray(v) for k, v in want.items()}


def _gather(spec, ranks, key):
    """The whole array: the output and x's gradient are replicated over a
    pipeline (each dp row its batch shard), a stage's gradient is that
    rank's slice of the stacked params (summed over dp: every row holds
    the same bits)."""
    name, dp = spec["name"], spec.get("dp", 1)
    n = len(ranks) // dp
    parts = [r[f"{name}/{key}"] for r in ranks]
    if key in ("out", "dx"):
        rows = []
        for i in range(dp):
            row = parts[i * n:(i + 1) * n]
            for p in row[1:]:
                np.testing.assert_array_equal(p, row[0], err_msg=key)
            rows.append(row[0])
        return np.concatenate(rows, axis=0)
    for i in range(1, dp):
        for j in range(n):
            np.testing.assert_array_equal(parts[i * n + j], parts[j],
                                          err_msg=key)
    return np.concatenate(parts[:n], axis=0)


def _ids(world):
    return [(world, c["name"]) for c in _cases(world) if "error" not in c]


PIPE_CASES = _ids(1) + _ids(2) + _ids(4)
ERROR_CASES = [(w, c["name"]) for w in (1, 2, 4) for c in _cases(w)
               if "error" in c]


@pytest.mark.parametrize("world,name", PIPE_CASES,
                         ids=[f"w{w}-{n}" for w, n in PIPE_CASES])
def test_pipeline_matches_jax_forward_and_every_gradient(worlds, world,
                                                         name):
    specs, ranks = worlds[world]
    spec = specs[name]
    want = _jax_pipeline(spec, _case_arrays(spec), world)
    got_out = _gather(spec, ranks, "out")
    np.testing.assert_allclose(got_out, want["out"], **OUT_TOL)
    np.testing.assert_allclose(got_out, want["oracle"], **OUT_TOL)
    for key in ["dx"] + [f"d{k}" for k in spec["keys"]]:
        got = _gather(spec, ranks, key)
        assert np.all(np.isfinite(got)), key
        np.testing.assert_allclose(got, want[key], err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("world,name", ERROR_CASES,
                         ids=[f"w{w}-{n}" for w, n in ERROR_CASES])
def test_pipeline_rejects_on_every_rank(worlds, world, name):
    specs, ranks = worlds[world]
    for rank in ranks:
        message = str(rank[f"{name}/error"])
        assert "Check failed" in message
        assert specs[name]["message"] in message, message


@pytest.mark.parametrize("world", [1, 2, 4])
def test_stage_weights_are_sharded(worlds, world):
    """Each rank keeps one stage: its stage gradient has leading dim 1."""
    specs, ranks = worlds[world]
    for r in ranks:
        assert r["gradients_match_oracle/dw"].shape[0] == 1


@pytest.mark.parametrize("world", [2, 4])
def test_psum_and_pmean_backward_do_not_scale_by_world(worlds, world):
    """psum sums forward and passes the cotangent through unchanged:
    d/dx_r sum(c · psum(x)) = c on every rank, not world · c (what an
    all-reduce in the backward would give); pmean's is c / world."""
    _, ranks = worlds[world]
    c = np.array([1.0, 2.0, 3.0], np.float32)
    total = world * (world + 1) / 2
    for r in ranks:
        np.testing.assert_array_equal(r["psum/y"], np.full(3, total))
        np.testing.assert_array_equal(r["psum/dx"], c)
        np.testing.assert_allclose(r["pmean/y"], np.full(3, total / world),
                                   rtol=1e-7)
        np.testing.assert_allclose(r["pmean/dx"], c / world, rtol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_pvary_backward_sums_over_the_group(worlds, world):
    """A replicated input used per rank gets the sum of every rank's
    cotangent on every rank: Σ_r (r + 1)."""
    _, ranks = worlds[world]
    for r in ranks:
        np.testing.assert_array_equal(
            r["pvary/dw"], np.full(3, world * (world + 1) / 2))


@pytest.mark.parametrize("world", [2, 4])
def test_ppermute_open_pairs_and_ring(worlds, world):
    """Open pairs [(i, i + 1)]: stage 0 receives zeros and the last stage's
    value reaches no one, so its cotangent is zero; rank i's cotangent is
    what rank i + 1 weighted it by. The ring with shift -1 receives from
    the right and sends the cotangent back there."""
    _, ranks = worlds[world]
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["open/y"],
                                      np.full(2, float(i) if i else 0.0))
        want_dx = float(i + 2) if i < world - 1 else 0.0
        np.testing.assert_array_equal(r["open/dx"], np.full(2, want_dx))
        np.testing.assert_array_equal(r["ring/y"],
                                      np.full(2, float((i + 1) % world + 1)))
        np.testing.assert_array_equal(r["ring/dx"],
                                      np.full(2, float((i - 1) % world + 1)))


def test_collectives_at_world_1_are_local():
    """No process group: psum and pmean are the identity, pvary passes its
    tensors through, the open pairs of one stage are empty (zeros), the
    ring is the identity."""
    x = torch.arange(3.0, requires_grad=True)
    assert axis.psum(x) is x or torch.equal(axis.psum(x), x)
    assert torch.equal(axis.pmean(x), x)
    assert axis.pvary([x], [(None,)])[0] is x
    assert torch.equal(axis.ppermute(x, perm=[]), torch.zeros(3))
    assert axis.ppermute(x) is x


def test_ppermute_refuses_bad_pairs():
    with pytest.raises(DMLCError, match="outside"):
        axis.ppermute(torch.zeros(2), perm=[(0, 1)])
    with pytest.raises(DMLCError, match="twice"):
        axis.ppermute(torch.zeros(2), perm=[(0, 0), (0, 0)])


def test_pipeline_params_from_numpy_and_oracle_match_jax():
    """Stacked numpy params carried across keep their bits; the port's
    sequential fold equals the JAX package's within OUT_TOL."""
    spec = _case("oracle", "mlp", 3, 8, 16, 4, 9)
    arrays = _case_arrays(spec)
    params = tpp.pipeline_params_from_numpy(
        {k: arrays[k] for k in spec["keys"]}, device="cpu")
    for k in spec["keys"]:
        np.testing.assert_array_equal(params[k].numpy(), arrays[k])
    got = tpp.pipeline_oracle(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                              params, torch.from_numpy(arrays["x"]))
    want = jpp.pipeline_oracle(JAX_STAGES["mlp"],
                               {k: jnp.asarray(arrays[k])
                                for k in spec["keys"]},
                               jnp.asarray(arrays["x"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)

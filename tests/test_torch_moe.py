"""The port's expert-parallel MoE layer (``dmlc_tpu_torch/ops/moe.py``)
against ``dmlc_tpu.ops.moe`` on the same numpy inputs, forward and every
gradient.

Every case of tests/test_moe.py and the MoE case of
tests/test_mesh_composition.py runs as real ranks: one ``python -c``
process per rank over gloo on the CPU at world 2 and world 4 (the dp × ep
case as 2 × 2 sub-groups), and in this process at world 1 with no process
group. Each rank feeds its token shard (``shard_tokens``) and its experts
(``shard_moe_params``) to ``make_moe_layer`` and saves its output, aux and
the gradients of sum(out²) + aux; the test gathers the shards and holds
them against the JAX package's sharded layer (``make_moe_layer`` on a mesh
of the first n virtual CPU devices) under ``jax.value_and_grad`` of the
same loss: the output, aux, x's gradient, the experts' gradients and the
gate's (the reference compares the gate's only at top-2, and against its
dense oracle, whose gate gradient differs by design at top-1).

Tolerances. The reference's own sharded-vs-oracle limits are rtol 2e-5 /
atol 2e-6 for outputs and rtol 2e-3 / atol 2e-4 for gradients
(tests/test_moe.py). Against the JAX package's sharded layer, the same
algorithm with f32 sums in another order (torch's einsum and matmul
against XLA's dot), the outputs and aux are held to rtol 2e-5 / atol 2e-6
and every gradient to rtol 1e-4 / atol 1e-5: a gradient here sums a few
hundred f32 products, whose order alone moves the last few bits. The
routing decisions (top-k, capacity slots) are exact, so a wrong slot or a
dropped token shows as an O(1) difference, far outside these limits.
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

from dmlc_tpu.ops import moe as jmoe
from dmlc_tpu_torch.ops import moe as tmoe
from dmlc_tpu_torch.utils import DMLCError

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
KEYS = ("out", "aux", "dx", "dwg", "dw1", "dw2")

# Run by every rank: build each case's layer over this rank's groups, feed
# it this rank's shard, save out, aux and the gradients of sum(out²) + aux
# (or the error's message).
_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlc_tpu_torch.ops.moe import make_moe_layer, shard_moe_params, shard_tokens
from dmlc_tpu_torch.utils import DMLCError


def run_cases(rank, world, tmp):
    torch.set_num_threads(1)
    groups = {}
    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=world)
        if world == 4:
            # every rank makes every sub-group, in the same order: the
            # expert groups are the rows of the 2 x 2 mesh, dp its columns
            rows = [dist.new_group([0, 1]), dist.new_group([2, 3])]
            cols = [dist.new_group([0, 2]), dist.new_group([1, 3])]
            groups = {"ep": rows[rank // 2], "dp": cols[rank % 2]}
    specs = json.load(open(f"{tmp}/cases.json"))
    arrays = np.load(f"{tmp}/cases.npz")
    saved = {}
    for spec in specs:
        name = spec["name"]
        if spec.get("dp", 1) > 1:
            group, batch_group = groups["ep"], groups["dp"]
        else:
            group, batch_group = None, None
        try:
            err = spec.get("error")
            if err == "experts":
                make_moe_layer(group, world + 1, 4)
            elif err == "tokens":
                shard_tokens(torch.zeros(1, world + 1, 4), group)
            elif err == "top_k":
                make_moe_layer(group, world, 4, top_k=spec["top_k"])
            if err is not None:
                raise AssertionError(f"{name}: no error")
            params = shard_moe_params({k: torch.from_numpy(
                arrays[f"{name}/{k}"]) for k in ("wg", "w1", "w2")}, group)
            params = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            x = shard_tokens(torch.from_numpy(arrays[f"{name}/x"]), group,
                             batch_group).clone().requires_grad_(True)
            layer = make_moe_layer(group, spec["E"], spec["capacity"],
                                   batch_group=batch_group,
                                   top_k=spec["top_k"])
            out, aux = layer(params, x)
            ((out ** 2).sum() + aux).backward()
        except DMLCError as err:
            saved[f"{name}/error"] = np.array(str(err).splitlines()[0])
            continue
        saved[f"{name}/out"] = out.detach().numpy()
        saved[f"{name}/aux"] = aux.detach().numpy()
        saved[f"{name}/dx"] = x.grad.numpy()
        for k, v in params.items():
            saved[f"{name}/d{k}"] = v.grad.numpy()
    np.savez(f"{tmp}/rank{rank}.npz", **saved)
    if world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    run_cases(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
'''


def _case(name, E, D, H, B, T, seed, capacity, top_k=1, **extra):
    return dict(name=name, E=E, D=D, H=H, B=B, T=T, seed=seed,
                capacity=capacity, top_k=top_k, **extra)


def _cases(n):
    """The cases at world n: tests/test_moe.py's at an n-rank group (its
    8-device mesh is n ranks here), with and without capacity drops."""
    cases = [
        # TestMoE
        _case("sharded_matches_dense_oracle", 16, 8, 16, 2, 64, 1, 64),
        _case("aux_is_mean_of_per_shard_losses", 8, 8, 16, 1, 8 * n, 3,
              8 * n),
        _case("capacity_drops_are_zero_not_garbage", 8, 8, 16, 1, 8 * n, 4,
              1, special="route_all_to_0"),
        _case("gradients_flow_and_match_oracle", 8, 8, 8, 1, 32, 5, 32),
        # TestTopK
        _case("top2_matches_dense_oracle", 16, 8, 16, 2, 64, 6, 64, top_k=2),
        _case("top1_path_unchanged", 8, 8, 16, 1, 32, 7, 32),
        _case("top2_gradients_match_oracle", 8, 8, 8, 1, 32, 9, 32, top_k=2),
        # capacity drops on random routing, both k
        _case("top1_capacity_drops", 8, 8, 16, 2, 16 * n, 10, 2),
        _case("top2_capacity_drops", 8, 8, 16, 2, 16 * n, 11, 3, top_k=2),
    ]
    if n > 1:
        # top-2 over one expert a rank: E = n (needs n >= 2)
        cases.append(_case("capacity_admits_first_choices_before_second",
                           n, n, 16, 1, 2 * n, 8, 1, top_k=2,
                           special="choice_order"))
        cases += [
            _case("err_experts", n + 1, 4, 8, 1, n, 12, 4,
                  error="experts", message="num_experts"),
            _case("err_tokens", 2 * n, 4, 8, 1, n, 13, 4, error="tokens",
                  message="token dim"),
        ]
    cases += [
        _case("err_top_k0", n, 4, 8, 1, n, 14, 4, top_k=0, error="top_k",
              message="top_k"),
        _case("err_top_k_big", n, 4, 8, 1, n, 15, 4, top_k=n + 1,
              error="top_k", message="top_k"),
    ]
    if n == 4:
        # tests/test_mesh_composition.py: dp 2 x ep 2
        cases.append(_case("moe_with_dp_sharded_batch", 4, 8, 16, 4, 16, 2,
                           16, dp=2))
    return cases


def _case_arrays(c):
    """params (the JAX package's init) and x of one case, as numpy."""
    if "error" in c:
        return {}
    params = {k: np.asarray(v) for k, v in jmoe.init_moe_params(
        c["E"], c["D"], c["H"], seed=c["seed"]).items()}
    rng = np.random.RandomState(c["seed"])
    x = rng.randn(c["B"], c["T"], c["D"]).astype(np.float32)
    if c.get("special") == "route_all_to_0":
        # tests/test_moe.py: a gate that routes every token to expert 0
        params["wg"] = np.zeros_like(params["wg"])
        params["wg"][:, 0] = 10.0
        x = np.abs(x) + np.float32(0.1)
    elif c.get("special") == "choice_order":
        # tests/test_moe.py: identity gate, token order [Y, X] a shard
        params["wg"] = 10.0 * np.eye(c["D"], c["E"], dtype=np.float32)
        y_row = np.zeros(c["D"], np.float32)
        y_row[1], y_row[0] = 1.0, 0.5
        x_row = np.zeros(c["D"], np.float32)
        x_row[0], x_row[1] = 1.0, 0.25
        n = c["E"]
        x = np.tile(np.stack([y_row, x_row]), (n, 1))[None]
    return {**params, "x": x}


def _write_cases(world, tmp):
    cases = _cases(world)
    (tmp / "cases.json").write_text(json.dumps(cases))
    arrays = {}
    for c in cases:
        for k, v in _case_arrays(c).items():
            arrays[f"{c['name']}/{k}"] = v
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
    """{world: ({case name: spec}, [per-rank results])} for worlds 1, 2, 4:
    the ranks of worlds 2 and 4 run as processes, all started together,
    while world 1 runs here with no process group."""
    tmps = {w: tmp_path_factory.mktemp(f"moe_w{w}") for w in (1, 2, 4)}
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


def _mesh(n, dp=1):
    devs = np.asarray(jax.devices()[:n])
    if dp > 1:
        return Mesh(devs.reshape(dp, n // dp), ("dp", "ep"))
    return Mesh(devs, ("ep",))


def _jax_sharded(spec, arrays, n):
    """The JAX package's sharded layer on an n-device mesh: out, aux and
    the gradients of sum(out²) + aux w.r.t. x and the params."""
    dp = spec.get("dp", 1)
    mesh = _mesh(n, dp)
    batch_axis = "dp" if dp > 1 else None
    layer = jmoe.make_moe_layer(mesh, spec["E"], capacity=spec["capacity"],
                                batch_axis=batch_axis, top_k=spec["top_k"])
    spec_x = NamedSharding(mesh, P(batch_axis, "ep"))

    def loss(params, x):
        out, aux = layer(jmoe.shard_moe_params(params, mesh),
                         jax.device_put(x, spec_x))
        return jnp.sum(jnp.asarray(out) ** 2) + aux, (out, aux)

    params = {k: jnp.asarray(arrays[k]) for k in ("wg", "w1", "w2")}
    (_, (out, aux)), (dparams, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(arrays["x"]))
    want = {"out": out, "aux": aux, "dx": dx,
            **{f"d{k}": v for k, v in dparams.items()}}
    return {k: np.asarray(v) for k, v in want.items()}


def _gather(spec, ranks, key):
    """The whole array from the ranks' results: tokens over the expert
    group (and batch over dp), the experts' gradients over the expert
    group; replicated values (aux, the gate's gradient) from rank 0, after
    checking every rank holds the same bits."""
    name, dp = spec["name"], spec.get("dp", 1)
    ep = len(ranks) // dp
    parts = [r[f"{name}/{key}"] for r in ranks]
    if key in ("aux", "dwg"):
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0], err_msg=key)
        return parts[0]
    if key in ("dw1", "dw2"):
        # every data-parallel row holds the same experts, summed over dp
        for row in range(1, dp):
            for j in range(ep):
                np.testing.assert_array_equal(parts[row * ep + j], parts[j],
                                              err_msg=key)
        return np.concatenate(parts[:ep], axis=0)
    rows = [np.concatenate(parts[i * ep:(i + 1) * ep], axis=1)
            for i in range(dp)]
    return np.concatenate(rows, axis=0)


def _ids(world):
    return [(world, c["name"]) for c in _cases(world) if "error" not in c]


LAYER_CASES = _ids(1) + _ids(2) + _ids(4)
ERROR_CASES = [(w, c["name"]) for w in (1, 2, 4) for c in _cases(w)
               if "error" in c]


@pytest.mark.parametrize("world,name", LAYER_CASES,
                         ids=[f"w{w}-{n}" for w, n in LAYER_CASES])
def test_layer_matches_jax_forward_and_every_gradient(worlds, world, name):
    specs, ranks = worlds[world]
    spec = specs[name]
    want = _jax_sharded(spec, _case_arrays(spec), world)
    for key in KEYS:
        got = _gather(spec, ranks, key)
        assert got.shape == want[key].shape, key
        tol = OUT_TOL if key in ("out", "aux") else GRAD_TOL
        np.testing.assert_allclose(got, want[key], err_msg=key, **tol)
    assert float(want["aux"]) > 0


@pytest.mark.parametrize("world,name", ERROR_CASES,
                         ids=[f"w{w}-{n}" for w, n in ERROR_CASES])
def test_layer_rejects_on_every_rank(worlds, world, name):
    specs, ranks = worlds[world]
    for rank in ranks:
        message = str(rank[f"{name}/error"])
        assert "Check failed" in message
        assert specs[name]["message"] in message, message


@pytest.mark.parametrize("world", [1, 2, 4])
def test_capacity_drops_are_zero_not_garbage(worlds, world):
    """tests/test_moe.py's structure check on the port's output: every
    token routes to expert 0 with one slot a rank, so exactly each shard's
    first token gets through and the rest are 0."""
    specs, ranks = worlds[world]
    spec = specs["capacity_drops_are_zero_not_garbage"]
    got = _gather(spec, ranks, "out")[0]
    t_local = spec["T"] // world
    for s in range(world):
        sl = got[s * t_local:(s + 1) * t_local]
        assert np.any(sl[0] != 0.0)
        np.testing.assert_array_equal(sl[1:], 0.0)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_aux_is_mean_of_per_shard_losses(worlds, world):
    """The distributed aux = the mean over token shards of each shard's
    switch loss (the port's oracle on each shard), rtol 1e-5 as
    tests/test_moe.py."""
    specs, ranks = worlds[world]
    spec = specs["aux_is_mean_of_per_shard_losses"]
    arrays = _case_arrays(spec)
    params = tmoe.moe_params_from_numpy(arrays, device="cpu")
    t_local = spec["T"] // world
    locals_ = [float(tmoe.moe_dense_oracle(
        params, torch.from_numpy(arrays["x"][:, s * t_local:
                                             (s + 1) * t_local]))[1])
               for s in range(world)]
    np.testing.assert_allclose(float(_gather(spec, ranks, "aux")),
                               np.mean(locals_), rtol=1e-5)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_expert_weights_are_sharded(worlds, world):
    """Each rank keeps only its own E / n experts' FFNs."""
    specs, ranks = worlds[world]
    spec = specs["sharded_matches_dense_oracle"]
    for r in ranks:
        assert r[f"{spec['name']}/dw1"].shape[0] == spec["E"] // world
        assert r[f"{spec['name']}/dw2"].shape[0] == spec["E"] // world


# ---------------------------------------------------------------------------
# single process: the oracle, routing, params
# ---------------------------------------------------------------------------


def _jax_oracle_grads(params, x, top_k):
    def loss(p, x):
        y, aux = jmoe.moe_dense_oracle(p, x, top_k=top_k)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (y, aux)), (dp, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return {"out": y, "aux": aux, "dx": dx,
            **{f"d{k}": v for k, v in dp.items()}}


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_dense_oracle_matches_jax(top_k):
    """The port's per-expert oracle against the JAX package's per-token
    one: the same function, so outputs within rtol 2e-5 / atol 2e-6 and
    every gradient within GRAD_TOL (the module docstring)."""
    E, D, H, B, T = 8, 8, 16, 2, 24
    params = {k: np.asarray(v) for k, v in
              jmoe.init_moe_params(E, D, H, seed=20 + top_k).items()}
    x = np.random.RandomState(top_k).randn(B, T, D).astype(np.float32)
    want = _jax_oracle_grads(params, x, top_k)
    tp = {k: v.requires_grad_(True) for k, v in
          tmoe.moe_params_from_numpy(params, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_dense_oracle(tp, tx, top_k=top_k)
    ((out ** 2).sum() + aux).backward()
    got = {"out": out.detach(), "aux": aux.detach(), "dx": tx.grad,
           **{f"d{k}": v.grad for k, v in tp.items()}}
    for key in KEYS:
        tol = OUT_TOL if key in ("out", "aux") else GRAD_TOL
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **tol)


@pytest.mark.parametrize("top_k,capacity", [(1, 24), (2, 24), (2, 2),
                                            (3, 1)])
def test_route_topk_matches_jax(top_k, capacity):
    """dispatch and combine equal the reference's (dispatch bit for bit:
    the slots are exact), aux within rtol 1e-6."""
    E, D, T = 6, 8, 24
    rng = np.random.RandomState(30 + top_k)
    x = rng.randn(T, D).astype(np.float32)
    wg = rng.randn(D, E).astype(np.float32)
    jd, jc, ja = jmoe._route_topk(jnp.asarray(x), jnp.asarray(wg), E,
                                  capacity, top_k)
    td, tc, ta = tmoe._route_topk(torch.from_numpy(x), torch.from_numpy(wg),
                                  E, capacity, top_k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **OUT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_moe_params_from_numpy_round_trip():
    """The JAX package's params carried across keep their bits, and come
    back as the same numpy arrays."""
    params = {k: np.asarray(v) for k, v in
              jmoe.init_moe_params(4, 8, 16, seed=3).items()}
    tp = tmoe.moe_params_from_numpy(params, device="cpu")
    assert set(tp) == {"wg", "w1", "w2"}
    for k, v in params.items():
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), v)
        tp[k].add_(1.0)  # a copy: the numpy array is untouched
        np.testing.assert_array_equal(
            np.asarray(jmoe.init_moe_params(4, 8, 16, seed=3)[k]), v)


def test_init_moe_params_shapes_scales_and_seed():
    """[D, E], [E, D, H], [E, H, D], scaled by 1/√D, 1/√D and 1/√H; the
    same seed gives the same bits, another seed other bits."""
    E, D, H = 4, 64, 256
    a = tmoe.init_moe_params(E, D, H, seed=5, device="cpu")
    b = tmoe.init_moe_params(E, D, H, seed=5, device="cpu")
    c = tmoe.init_moe_params(E, D, H, seed=6, device="cpu")
    assert a["wg"].shape == (D, E) and a["w1"].shape == (E, D, H)
    assert a["w2"].shape == (E, H, D)
    for k in a:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    np.testing.assert_allclose(float(a["w1"].std()), 1 / np.sqrt(D),
                               rtol=0.05)
    np.testing.assert_allclose(float(a["w2"].std()), 1 / np.sqrt(H),
                               rtol=0.05)
    gen = torch.Generator().manual_seed(5)
    d = tmoe.init_moe_params(E, D, H, device="cpu", generator=gen)
    assert torch.equal(a["w1"], d["w1"])


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """device=None means cuda: without a card the params raise, no silent
    CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        tmoe.init_moe_params(2, 4, 8)
    with pytest.raises(DMLCError, match="no CUDA device"):
        tmoe.moe_params_from_numpy(
            {k: np.zeros((1, 1, 1), np.float32) for k in tmoe.MOE_KEYS})


def test_shard_tokens_and_params_at_world_1():
    """One rank: the whole batch and every expert."""
    x = torch.arange(24.0).reshape(1, 6, 4)
    assert torch.equal(tmoe.shard_tokens(x), x)
    params = tmoe.init_moe_params(2, 4, 8, device="cpu")
    assert tmoe.shard_moe_params(params)["w1"].shape[0] == 2


# ---------------------------------------------------------------------------
# the MoE-transformer example (dmlc_tpu_torch/examples/moe_transformer.py)
# ---------------------------------------------------------------------------


def test_example_runs_dp2_sp2_and_matches_its_reference(tmp_path):
    """``python -m dmlc_tpu_torch.examples.moe_transformer --device cpu``
    at its default toy size: four gloo ranks (dp 2 × sp 2), ring attention
    with GQA and a top-2 MoE, held by the example itself to max|Δ| < 1e-3
    against its single-rank block (the reference example's criterion)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_tpu_torch.examples.moe_transformer",
         "--device", "cpu", "--world", "4"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "groups: dp=2 x sp=2 (cpu)" in out.stdout
    assert "block matches the single-rank reference" in out.stdout


@pytest.mark.parametrize("top_k", [1, 2])
def test_example_block_matches_jax_reference_block(top_k):
    """The example's block at one rank, from the JAX package's MoE params,
    against the reference example's single-device block built from
    ``dmlc_tpu``'s ``full_attention`` + ``moe_dense_oracle``: rtol 2e-4 /
    atol 2e-5, the attention tolerance of
    tests/test_torch_sequence_parallel.py (the looser of the two layers')."""
    from dmlc_tpu.ops import sequence_parallel as jsp
    from dmlc_tpu_torch.examples import moe_transformer as ex

    b, t, d, h, hk, e = 2, 32, 32, 8, 2, 8
    params = ex.block_params(d, h, hk, e, 4 * d, "cpu")
    jparams = {k: np.asarray(v) for k, v in
               jmoe.init_moe_params(e, d, 4 * d, seed=1).items()}
    params["moe"] = tmoe.moe_params_from_numpy(jparams, device="cpu")
    x = np.random.RandomState(1).randn(b, t, d).astype(np.float32)
    block = ex.make_block(params, h, hk, t, top_k)
    with torch.no_grad():
        got, _ = block(torch.from_numpy(x))

    def rms(v):
        return v * jax.lax.rsqrt(jnp.mean(v * v, axis=-1, keepdims=True)
                                 + 1e-6)

    w = {k: jnp.asarray(params[k].numpy()) for k in ("wq", "wk", "wv", "wo")}
    hd = d // h
    xn = rms(jnp.asarray(x))
    q = (xn @ w["wq"]).reshape(b, t, h, hd)
    k = (xn @ w["wk"]).reshape(b, t, hk, hd)
    v = (xn @ w["wv"]).reshape(b, t, hk, hd)
    y1 = jnp.asarray(x) + jsp.full_attention(q, k, v, causal=True).reshape(
        b, t, d) @ w["wo"]
    ffn, _ = jmoe.moe_dense_oracle(jparams, rms(y1), top_k=top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(y1 + ffn), rtol=2e-4,
                               atol=2e-5)

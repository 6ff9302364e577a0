"""The port's long-context attention (``dmlc_tpu_torch/ops/sequence_parallel``
and ``ops/flash_attention``) against ``dmlc_tpu.ops.sequence_parallel`` on
the same numpy inputs, forward and gradients.

The sharded schedules run as real ranks: one ``python -c`` process per rank
over gloo on the CPU, at world 2 and world 4 (the latter also as
data-parallel 2 × sequence-parallel 2 on sub-groups), and in this process
at world 1 with no process group. Each rank saves its shard of the output
and of the gradients of sum(out²); the test concatenates the shards and
holds them against the JAX package's ``full_attention`` and ``jax.grad`` of
it on the whole arrays. On the CPU the flash route is the kernels' plain
version; the CUDA kernels are held against it on the card in
tests/test_torch_cuda.py.

Tolerances are those of tests/test_sequence_parallel.py: outputs rtol 2e-4
/ atol 2e-5 and gradients rtol 2e-3 / atol 2e-4 (f32 sums in another order,
and the online softmax rescales partial sums per block). The zigzag
permutation moves values without arithmetic, so it is held bit for bit.
"""

import functools
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

from dmlc_tpu.ops import sequence_parallel as jsp
from dmlc_tpu_torch.ops import kernels, sequence_parallel as tsp
from dmlc_tpu_torch.ops.flash_attention import FlashAttention, flash_attention
from dmlc_tpu_torch.utils import DMLCError

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)

# Run by every rank: build each case's schedule, feed it this rank's shard,
# save out and the gradients of sum(out**2) (or the error's message).
_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from dmlc_tpu_torch.ops import (
    make_flash_local, make_ring_attention, make_ulysses_attention,
    zigzag_shard)
from dmlc_tpu_torch.utils import DMLCError


def run_cases(rank, world, tmp):
    torch.set_num_threads(1)
    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=world)
        # every rank makes every sub-group, in the same order
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])] \
            if world == 4 else None
    specs = json.load(open(f"{tmp}/cases.json"))
    arrays = np.load(f"{tmp}/cases.npz")
    saved = {}
    for spec in specs:
        name = spec["name"]
        dp = spec.get("dp", 1)
        if dp > 1:
            group, sp, sp_rank, dp_rank = pairs[rank // 2], 2, rank % 2, rank // 2
        else:
            group, sp, sp_rank, dp_rank = None, world, rank, 0
        try:
            kw = dict(spec["kwargs"])
            if spec["schedule"] == "ring":
                fn = make_ring_attention(group, **kw)
            else:
                if spec.get("flash") is not None:
                    kw["local_attention"] = make_flash_local(spec["flash"])
                fn = make_ulysses_attention(group, **kw)
            shards = []
            for key in ("q", "k", "v"):
                x = torch.from_numpy(arrays[f"{name}/{key}"])
                if spec.get("zigzag"):
                    x = zigzag_shard(x, sp)
                b, t = x.shape[0] // dp, x.shape[1] // sp
                x = x[dp_rank * b:(dp_rank + 1) * b,
                      sp_rank * t:(sp_rank + 1) * t].contiguous()
                shards.append(x.requires_grad_(True))
            out = fn(*shards)
            (out ** 2).sum().backward()
        except DMLCError as err:
            saved[f"{name}/error"] = np.array(str(err).splitlines()[0])
            continue
        saved[f"{name}/out"] = out.detach().numpy()
        for key, x in zip(("q", "k", "v"), shards):
            saved[f"{name}/d{key}"] = x.grad.numpy()
    np.savez(f"{tmp}/rank{rank}.npz", **saved)
    if world > 1:
        dist.destroy_process_group()


if __name__ == "__main__":
    run_cases(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
'''


def _case(name, schedule, b, t, h, hk, d, seed, **extra):
    kwargs = extra.pop("kwargs", {})
    return dict(name=name, schedule=schedule, shape=(b, t, h, hk, d),
                seed=seed, kwargs=kwargs, **extra)


def _cases(n):
    """The cases at world n (shard length 4 or 8)."""
    cases = [
        _case("ring", "ring", 2, 8 * n, 4, 4, 16, 0),
        _case("ring_causal_gqa", "ring", 2, 8 * n, 8, 2, 16, 1,
              kwargs=dict(causal=True)),
        _case("ring_window3", "ring", 2, 4 * n, 4, 2, 8, 2,
              kwargs=dict(window=3)),
        # straddles the 4-long shards
        _case("ring_window5", "ring", 1, 4 * n, 4, 2, 8, 3,
              kwargs=dict(window=5)),
        _case("ring_zigzag", "ring", 2, 4 * n, 4, 2, 16, 4, zigzag=True,
              kwargs=dict(causal=True, layout="zigzag")),
        _case("ring_zigzag_window6", "ring", 2, 4 * n, 4, 2, 16, 5,
              zigzag=True,
              kwargs=dict(causal=True, window=6, layout="zigzag")),
        _case("ring_remat_window6", "ring", 1, 8 * n, 4, 2, 16, 6,
              kwargs=dict(causal=True, window=6, remat=True)),
        _case("ring_remat_zigzag", "ring", 1, 8 * n, 4, 2, 16, 7,
              zigzag=True,
              kwargs=dict(causal=True, layout="zigzag", remat=True)),
        _case("ulysses_causal", "ulysses", 2, 4 * n, 2 * n, n, 16, 8,
              kwargs=dict(causal=True)),
        _case("ulysses_window7", "ulysses", 1, 4 * n, 2 * n, n, 8, 9,
              kwargs=dict(window=7)),
        _case("ulysses_flash_causal", "ulysses", 2, 4 * n, 2 * n, n, 32, 10,
              flash=True),
        _case("ulysses_flash_mha", "ulysses", 1, 4 * n, n, n, 64, 11,
              flash=False),
    ]
    if n > 1:
        cases += [
            _case("err_heads", "ulysses", 1, 2 * n, n + 1, 1, 8, 12,
                  error="heads"),
            _case("err_kv_heads", "ulysses", 1, 4 * n, 2 * n, 1, 8, 13,
                  error="kv_heads"),
            _case("err_zigzag_t", "ring", 1, 3 * n, 2, 2, 8, 14,
                  error="zigzag", kwargs=dict(causal=True,
                                              layout="zigzag")),
            _case("err_window", "ring", 1, 2 * n, 2, 2, 8, 15,
                  error="window", kwargs=dict(window=-1)),
        ]
    if n == 4:
        cases += [
            _case("dp2_sp2_ring", "ring", 4, 16, 4, 2, 16, 16, dp=2,
                  kwargs=dict(causal=True)),
            _case("dp2_sp2_ulysses", "ulysses", 4, 8, 4, 2, 16, 17, dp=2),
        ]
    return cases


def _arrays(cases):
    arrays = {}
    for c in cases:
        b, t, h, hk, d = c["shape"]
        rng = np.random.RandomState(c["seed"])
        arrays[c["name"] + "/q"] = rng.randn(b, t, h, d).astype(np.float32)
        for key in ("k", "v"):
            arrays[f"{c['name']}/{key}"] = rng.randn(b, t, hk, d).astype(
                np.float32)
    return arrays


def _write_cases(world, tmp):
    cases = _cases(world)
    (tmp / "cases.json").write_text(json.dumps(cases))
    np.savez(tmp / "cases.npz", **_arrays(cases))
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
    tmps = {w: tmp_path_factory.mktemp(f"w{w}") for w in (1, 2, 4)}
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


def _gather(spec, ranks, key):
    """Concatenate the ranks' shards into the whole [B, T, ...] array, in
    natural sequence order."""
    dp = spec.get("dp", 1)
    sp = len(ranks) // dp
    rows = [np.concatenate([ranks[i * sp + j][f"{spec['name']}/{key}"]
                            for j in range(sp)], axis=1) for i in range(dp)]
    whole = np.concatenate(rows, axis=0)
    if spec.get("zigzag"):
        whole = np.asarray(jsp.zigzag_unshard(jnp.asarray(whole), sp))
    return whole


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_attention_and_grads(q, k, v, causal, window):
    def loss(q, k, v):
        out = jsp.full_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return out, grads


def _jax_reference(spec, arrays):
    """(out, (dq, dk, dv)) of the JAX package's full attention with the
    case's masking, and jax.grad of sum(out**2)."""
    kw = spec["kwargs"]
    if spec["schedule"] == "ulysses" and spec.get("flash") is not None:
        kw = dict(causal=spec["flash"])
    out, grads = _jax_attention_and_grads(
        *(jnp.asarray(arrays[f"{spec['name']}/{x}"]) for x in "qkv"),
        causal=kw.get("causal", False), window=kw.get("window", 0))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _ids(world):
    return [(world, c["name"]) for c in _cases(world) if "error" not in c]


SCHEDULE_CASES = _ids(1) + _ids(2) + _ids(4)
ERROR_CASES = [(w, c["name"]) for w in (2, 4) for c in _cases(w)
               if "error" in c]


@pytest.mark.parametrize("world,name", SCHEDULE_CASES,
                         ids=[f"w{w}-{n}" for w, n in SCHEDULE_CASES])
def test_schedule_matches_jax_forward_and_gradients(worlds, world, name):
    specs, ranks = worlds[world]
    spec = specs[name]
    arrays = _arrays([spec])
    want_out, want_grads = _jax_reference(spec, arrays)
    got_out = _gather(spec, ranks, "out")
    assert got_out.shape == want_out.shape
    np.testing.assert_allclose(got_out, want_out, **OUT_TOL)
    for key, want in zip(("dq", "dk", "dv"), want_grads):
        np.testing.assert_allclose(_gather(spec, ranks, key), want,
                                   err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("world,name", ERROR_CASES,
                         ids=[f"w{w}-{n}" for w, n in ERROR_CASES])
def test_schedule_rejects_on_every_rank(worlds, world, name):
    specs, ranks = worlds[world]
    for rank in ranks:
        message = str(rank[f"{name}/error"])
        assert "Check failed" in message
        assert specs[name]["error"] in message, message


# ---------------------------------------------------------------------------
# single process: full_attention, flash, zigzag
# ---------------------------------------------------------------------------


def _qkv(seed, b, t, h, hk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t, hk, d).astype(np.float32),
            rng.randn(b, t, hk, d).astype(np.float32))


def _torch_out_and_grads(fn, q, k, v):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _jax_out_and_grads(q, k, v, causal=False, window=0):
    spec = dict(name="c", schedule="ring",
                kwargs=dict(causal=causal, window=window))
    return _jax_reference(spec, {"c/q": q, "c/k": k, "c/v": v})


@pytest.mark.parametrize("hk", [1, 2, 4])
@pytest.mark.parametrize("causal,window", [
    (False, 0), (True, 0), (False, 1), (False, 5), (False, 16),
    (False, 1000)])
def test_full_attention_matches_jax(causal, window, hk):
    q, k, v = _qkv(20 + hk, 2, 24, 4, hk, 8)
    got, got_grads = _torch_out_and_grads(
        lambda q, k, v: tsp.full_attention(q, k, v, causal, window), q, k, v)
    want, want_grads = _jax_out_and_grads(q, k, v, causal, window)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("route", ["flash_attention", "make_flash_local",
                                   "FlashAttention"])
@pytest.mark.parametrize("h,hk,d", [(4, 4, 32), (4, 2, 64), (4, 1, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_route_matches_jax(causal, h, hk, d, route):
    """The CPU route of every flash entry point (FlashAttention is the
    Function the card runs; on CPU tensors its wrappers take the plain
    version) against the JAX package's full_attention, which is what its
    own on-chip test holds the TPU flash kernel to."""
    q, k, v = _qkv(30 + d + hk, 2, 40, h, hk, d)
    fns = {
        "flash_attention": lambda q, k, v: flash_attention(q, k, v, causal),
        "make_flash_local": tsp.make_flash_local(causal),
        "FlashAttention": lambda q, k, v: FlashAttention.apply(
            q, k, v, causal),
    }
    got, got_grads = _torch_out_and_grads(fns[route], q, k, v)
    want, want_grads = _jax_out_and_grads(q, k, v, causal)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_flash_fwd_lse_is_the_row_logsumexp():
    q, k, v = _qkv(40, 1, 33, 4, 2, 32)
    out, lse = kernels.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), True)
    assert out.shape == (1, 33, 4, 32) and lse.shape == (1, 4, 33)
    kk = np.repeat(k, 2, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(32)
    s = np.where(np.tril(np.ones((33, 33), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_rejects_what_the_kernels_do_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(41, 1, 8, 4, 2, 32))
    with pytest.raises(DMLCError, match="head dim 48"):
        flash_attention(torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48),
                        torch.zeros(1, 8, 2, 48))
    with pytest.raises(DMLCError, match="float32"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(DMLCError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(DMLCError, match="divide"):
        flash_attention(torch.zeros(1, 8, 3, 32), k[:, :, :2], v[:, :, :2])
    with pytest.raises(DMLCError, match="k must be"):
        flash_attention(q, k[:, :4], v)
    with pytest.raises(DMLCError, match="local_attention"):
        tsp.make_ulysses_attention(causal=True,
                                   local_attention=tsp.make_flash_local())


@pytest.mark.parametrize("t,n", [(48, 4), (16, 2), (24, 3)])
def test_zigzag_shard_matches_jax(t, n):
    x = np.random.RandomState(t).randn(2, t, 3, 4).astype(np.float32)
    got = tsp.zigzag_shard(torch.from_numpy(x), n).numpy()
    want = np.asarray(jsp.zigzag_shard(jnp.asarray(x), n))
    assert np.array_equal(got, want)
    back = tsp.zigzag_unshard(torch.from_numpy(got), n).numpy()
    assert np.array_equal(back, x)
    with pytest.raises(DMLCError):
        tsp.zigzag_shard(torch.from_numpy(x[:, :t - 1]), n)


def test_flash_plain_route_counts_no_launch():
    kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _qkv(42, 1, 16, 2, 2, 32))
    tsp.make_ulysses_attention(local_attention=tsp.make_flash_local(True))(
        q, k, v)
    assert all(fn.launches == 0 for fn in kernels.KERNELS.values())

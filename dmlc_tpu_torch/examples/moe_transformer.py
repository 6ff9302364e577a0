"""A sharded MoE-transformer block from the port's parallel layers (the
counterpart of ``examples/moe_transformer.py``).

Composes, over process groups (data-parallel × sequence-parallel rows of
ranks made with ``dist.new_group``):

- causal RING attention with GQA (the sequence sharded over a row, the
  batch over the rows),
- a switch- or GShard-MoE FFN (experts sharded over the same row: one
  group serves both schedules, the tokens ride the same sharding),
- residual connections and RMSNorm,

and checks the whole block, end to end, against a single-rank reference
built from ``full_attention`` + ``moe_dense_oracle``::

    python -m dmlc_tpu_torch.examples.moe_transformer [--world 4]
        [--device cpu] [--seq 64] [--d-model 32] [--heads 8]
        [--kv-heads 2] [--experts 8] [--top-k 2]

``--world`` rank processes (gloo; 1 or even: dp = 2 × sp = world / 2, or
one rank) are started on this host, on ``--device`` (default the card:
several ranks then share it over gloo). Exit 0 iff max|Δ| < 1e-3, as the
reference prints it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from dmlc_tpu_torch.ops.moe import (init_moe_params, make_moe_layer,
                                    moe_dense_oracle, shard_moe_params,
                                    shard_tokens)
from dmlc_tpu_torch.ops.sequence_parallel import (full_attention,
                                                  make_ring_attention)
from dmlc_tpu_torch.parallel.axis import axis_size
from dmlc_tpu_torch.utils.device import resolve_device

#: the reference's criterion: the sharded block against the single-rank one
MAX_ABS_DIFF = 1e-3
#: seconds the rank processes may take together
RANK_TIMEOUT_S = 600


def block_params(d: int, heads: int, kv_heads: int, experts: int,
                 d_hidden: int, device, seed: int = 0) -> dict:
    """The attention projections (numpy draws from ``seed``, as the
    reference's, scaled by 1/√d) and the MoE's params
    (``init_moe_params(seed=seed + 1)`` on ``device``)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    hd = d // heads

    def proj(rows, cols):
        w = rng.randn(rows, cols).astype(np.float32) / np.sqrt(d)
        return torch.tensor(w.astype(np.float32), device=dev)

    return {"wq": proj(d, heads * hd), "wk": proj(d, kv_heads * hd),
            "wv": proj(d, kv_heads * hd), "wo": proj(heads * hd, d),
            "moe": init_moe_params(experts, d, d_hidden, seed=seed + 1,
                                   device=dev)}


def rmsnorm(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt((v * v).mean(dim=-1, keepdim=True) + 1e-6)


def _qkv(params, v, heads, kv_heads):
    b, t, d = v.shape
    hd = d // heads
    vn = rmsnorm(v)
    return ((vn @ params["wq"]).reshape(b, t, heads, hd),
            (vn @ params["wk"]).reshape(b, t, kv_heads, hd),
            (vn @ params["wv"]).reshape(b, t, kv_heads, hd))


def make_block(params, heads: int, kv_heads: int, seq: int, top_k: int,
               sp_group=None, dp_group=None):
    """f(x_shard[B/dp, T/sp, D]) -> (y_shard, aux): ring attention and the
    MoE FFN over ``sp_group`` (this rank's row), the batch over
    ``dp_group``. The MoE capacity is the local token count: top-k ids
    are distinct per token, so an expert takes at most one claim a token
    and ``T / sp`` is the tight no-drop bound for any k."""
    sp = axis_size(sp_group)
    ring = make_ring_attention(sp_group, causal=True)
    moe = make_moe_layer(sp_group, params["moe"]["wg"].shape[1],
                         capacity=seq // sp, batch_group=dp_group,
                         top_k=top_k)
    moe_params = shard_moe_params(params["moe"], sp_group)

    def block(xs):
        b, t, d = xs.shape
        q, k, v = _qkv(params, xs, heads, kv_heads)
        attn = ring(q, k, v).reshape(b, t, d)
        y1 = xs + attn @ params["wo"]
        ffn, aux = moe(moe_params, rmsnorm(y1))
        return y1 + ffn, aux

    return block


def reference_block(params, x, heads: int, kv_heads: int, top_k: int):
    """The single-rank block: ``full_attention`` + ``moe_dense_oracle``."""
    b, t, d = x.shape
    q, k, v = _qkv(params, x, heads, kv_heads)
    y1 = x + full_attention(q, k, v, causal=True).reshape(b, t, d) \
        @ params["wo"]
    ffn, _ = moe_dense_oracle(params["moe"], rmsnorm(y1), top_k=top_k)
    return y1 + ffn


def _layout(world: int) -> tuple:
    if world == 1:
        return 1, 1
    return 2, world // 2


def run_rank(rank: int, world: int, init: str, args) -> int:
    """One rank: join the gloo world, make the dp × sp sub-groups, run the
    block on this rank's shard, gather the shards on rank 0 and hold them
    against the single-rank block there."""
    dev = resolve_device(args.device)
    if world > 1:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
    try:
        dp, sp = _layout(world)
        sp_group = dp_group = None
        if world > 1:
            # every rank makes every sub-group, in the same order: the
            # rows of the dp x sp mesh are the sequence groups
            rows = [dist.new_group(list(range(i * sp, (i + 1) * sp)))
                    for i in range(dp)]
            cols = [dist.new_group(list(range(j, world, sp)))
                    for j in range(sp)]
            sp_group, dp_group = rows[rank // sp], cols[rank % sp]
        d, h, hk = args.d_model, args.heads, args.kv_heads
        t = args.seq - args.seq % (2 * sp)
        e = args.experts - args.experts % sp
        params = block_params(d, h, hk, e, args.d_hidden or 4 * d, dev)
        x = torch.tensor(np.random.RandomState(1).randn(
            args.batch, t, d).astype(np.float32), device=dev)
        block = make_block(params, h, hk, t, args.top_k, sp_group, dp_group)
        with torch.no_grad():
            y, aux = block(shard_tokens(x, sp_group, dp_group))
            shards = [y]
            if world > 1:
                shards = [torch.empty_like(y) for _ in range(world)]
                dist.all_gather(shards, y.contiguous())
            if rank != 0:
                return 0
            got = torch.cat([torch.cat(shards[i * sp:(i + 1) * sp], dim=1)
                             for i in range(dp)], dim=0)
            want = reference_block(params, x, h, hk, args.top_k)
        err = float((got - want).abs().max())
        print(f"groups: dp={dp} x sp={sp} ({dev.type})")
        print(f"block: ring-attn(GQA {h}q/{hk}kv, causal) + "
              f"MoE(E={e}, top-{args.top_k}) + residuals/RMSNorm over T={t}")
        print(f"max|Δ| sharded vs single-rank = {err:.2e} "
              f"(aux={float(aux):.3f})")
        ok = err < MAX_ABS_DIFF
        print("block matches the single-rank reference" if ok
              else "MISMATCH", flush=True)
        return 0 if ok else 1
    finally:
        if world > 1:
            dist.destroy_process_group()


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_tpu_torch.examples.moe_transformer",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--d-hidden", type=int, default=0,
                    help="expert hidden width (default 4 x d-model)")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--top-k", type=int, default=2,
                    help="experts per token (1=switch, 2=GShard)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    world = args.world
    if world < 1 or (world > 1 and world % 2):
        print(f"--world {world}: need 1 or an even count", file=sys.stderr)
        return 2
    dp, sp = _layout(world)
    if args.seq < 2 * sp or args.experts < sp:
        print(f"--seq {args.seq} / --experts {args.experts} too small for "
              f"sp={sp} (need seq >= {2 * sp}, experts >= {sp})",
              file=sys.stderr)
        return 2
    if args.rank is not None or world == 1:
        return run_rank(args.rank or 0, world, args.init, args)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "dmlc_tpu_torch.examples.moe_transformer"
               ] + list(argv if argv is not None else sys.argv[1:])
        procs = [subprocess.Popen(
            cmd + ["--rank", str(r), "--init", f"file://{tmp}/pg"], env=env)
            for r in range(world)]
        try:
            codes = [p.wait(timeout=RANK_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return max(codes, key=abs)


if __name__ == "__main__":
    sys.exit(main())

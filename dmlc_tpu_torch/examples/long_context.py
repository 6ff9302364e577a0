"""Long-context attention over a sequence-parallel group, the counterpart
of ``examples/long_context.py``: each schedule against exact attention
(``full_attention``) at max|Δ| < 1e-3::

    python -m dmlc_tpu_torch.examples.long_context [--seq 512] \\
        [--heads 8] [--kv-heads 2] [--head-dim 32] [--device cpu]

Ring (contiguous and zigzag layouts, causal, sliding window) and Ulysses
all-to-all, with grouped-query attention, over a one-rank gloo group
where the JAX package takes a mesh of every device; then Ulysses with the
hand-written flash kernels as its local attention (``make_flash_local``:
``flash_attention_fwd`` on the card, its plain version on the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=32)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from dmlc_tpu_torch.ops import (full_attention, make_flash_local,
                                    make_ring_attention,
                                    make_ulysses_attention, zigzag_shard,
                                    zigzag_unshard)
    from dmlc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    own_group = not dist.is_initialized()
    tmp = tempfile.mkdtemp()
    if own_group:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        n = dist.get_world_size(group)
        print(f"mesh: {n} x {dev.type} over group 'sp'")

        t = args.seq - args.seq % (2 * n)  # zigzag needs T % 2N == 0
        if t <= 0:
            print(f"--seq {args.seq} is smaller than 2*num_devices "
                  f"({2 * n}); need at least one sequence chunk per device "
                  f"pair", file=sys.stderr)
            return 2
        rng = np.random.RandomState(0)

        def draw(heads):
            return torch.tensor(rng.randn(1, t, heads, args.head_dim)
                                .astype(np.float32), device=dev)

        q, k, v = draw(args.heads), draw(args.kv_heads), draw(args.kv_heads)
        print(f"shapes: q[1,{t},{args.heads},{args.head_dim}] "
              f"kv[1,{t},{args.kv_heads},{args.head_dim}] (GQA ratio "
              f"{args.heads // args.kv_heads})")

        def report(name, got, want):
            err = float((got - want).abs().max())
            ok = err < 1e-3
            print(f"  {name:<42} max|Δ| vs exact = {err:.2e} "
                  f"{'ok' if ok else 'MISMATCH'}")
            return ok

        ok = True
        with torch.no_grad():
            want = full_attention(q, k, v, causal=True)
            ring = make_ring_attention(group, causal=True)
            ok &= report("ring, contiguous, causal", ring(q, k, v), want)

            ring_zz = make_ring_attention(group, causal=True,
                                          layout="zigzag")
            got = zigzag_unshard(ring_zz(zigzag_shard(q, n),
                                         zigzag_shard(k, n),
                                         zigzag_shard(v, n)), n)
            ok &= report("ring, zigzag (load-balanced), causal", got, want)

            want_w = full_attention(q, k, v, window=args.window)
            ring_w = make_ring_attention(group, window=args.window)
            ok &= report(f"ring, sliding window W={args.window}",
                         ring_w(q, k, v), want_w)

            if args.heads % n == 0 and args.kv_heads % n == 0:
                want_u = full_attention(q, k, v)
                ulysses = make_ulysses_attention(group)
                ok &= report("ulysses all-to-all", ulysses(q, k, v), want_u)
                flash = make_ulysses_attention(
                    group, local_attention=make_flash_local(causal=False))
                ok &= report("ulysses all-to-all + flash kernels",
                             flash(q, k, v), want_u)
            else:
                print(f"  ulysses skipped (heads {args.heads}/"
                      f"{args.kv_heads} do not divide over {n} devices)")

        print("all schedules match exact attention" if ok else "MISMATCH")
        return 0 if ok else 1
    finally:
        if own_group:
            dist.destroy_process_group()
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)


if __name__ == "__main__":
    sys.exit(main())

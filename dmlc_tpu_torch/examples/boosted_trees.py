"""Histogram gradient-boosted trees, the xgboost-over-rabit workload: the
counterpart of ``examples/boosted_trees.py``::

    python -m dmlc_tpu_torch.examples.boosted_trees data.svm \\
        --num-features 29 [--device cpu]
    python -m dmlc_tpu_torch.examples.boosted_trees --synthetic
    python -m dmlc_tpu_torch.examples.boosted_trees --synthetic --dp 2

1. ingest: a data uri streams through the parser (its text tokenized by
   the ``tokenize_boundaries`` kernel on ``--device``, the card unless
   ``--device cpu``) in ``fit_uri``'s two passes (reservoir edges, then
   binning block by block), or the seeded synthetic matrix is fit in
   core;
2. quantile binning on the device (``fit_bins`` / ``apply_bins``);
3. level-wise growth: per level a (grad, hess) histogram; under ``--dp N``
   N rank processes over a gloo group each hold their rows and ONE
   all-reduce a level sums the histograms (rabit's allreduce), where the
   JAX package takes an N-way mesh;
4. vectorized split finding and leaf values.

Prints the JAX package's line: trees, depth, rows, the loss from the
first tree to the last, train accuracy and fit seconds.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: seconds the --dp rank processes may take together
RANK_TIMEOUT_S = 600


def _load_dense(uri: str, num_features: int, part: int, nparts: int,
                device):
    """A parser uri as dense x [N, F], y [N] (one in-core pass)."""
    from dmlc_tpu_torch.data import create_parser

    xs, ys = [], []
    parser = create_parser(uri, part, nparts, device=device)
    try:
        for block in parser:
            xs.append(block.to_dense(num_features))
            ys.append(np.asarray(block.label, dtype=np.float32))
    finally:
        parser.close()
    return np.concatenate(xs), np.concatenate(ys)


def _synthetic_multiclass(k: int, n: int = 8192, f: int = 12):
    rng = np.random.RandomState(19)
    x = rng.rand(n, f).astype(np.float32)
    y = np.minimum(
        (x[:, 0] > 0.5) * 2 + (x[:, 1] > 0.5), k - 1
    ).astype(np.float32)
    flip = rng.rand(n) < 0.04
    y[flip] = rng.randint(0, k, int(flip.sum()))
    return x, y


def _synthetic(n: int = 8192, f: int = 16):
    rng = np.random.RandomState(11)
    x = rng.rand(n, f).astype(np.float32)
    logit = (
        5.0 * (x[:, 0] > 0.6)
        - 4.0 * ((x[:, 1] > 0.25) & (x[:, 2] < 0.75))
        + 2.0 * x[:, 3]
        - 1.0
    )
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return x, y


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("uri", nargs="?", help="training data uri (any parser)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-features", type=int, default=0)
    ap.add_argument("--num-trees", type=int, default=20)
    ap.add_argument("--max-depth", type=int, default=5)
    ap.add_argument("--learning-rate", type=float, default=0.4)
    ap.add_argument("--num-bins", type=int, default=64)
    ap.add_argument("--objective", default="logistic",
                    choices=("logistic", "squared", "softmax"))
    ap.add_argument("--num-class", type=int, default=0,
                    help="class count for --objective softmax (labels "
                         "are class ids); --synthetic then generates a "
                         "4-class problem")
    ap.add_argument("--dp", type=int, default=0,
                    help="rank processes over a gloo group, each with its "
                         "rows (histograms all-reduce once a level)")
    ap.add_argument("--save", help="checkpoint uri (any Stream backend)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    return ap


def _run(args, ap) -> int:
    import torch
    import torch.distributed as dist

    from dmlc_tpu_torch.models.gbdt import GBDTLearner, fit_bins
    from dmlc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    group, rank = None, 0
    if args.dp:
        rank = args.rank
        dist.init_process_group("gloo", init_method=args.init, rank=rank,
                                world_size=args.dp)
        group = dist.group.WORLD
    try:
        softmax = args.objective == "softmax"
        if softmax and args.num_class < 2:
            # a real uri's class count is the user's to declare
            if args.uri and not args.synthetic:
                ap.error("--objective softmax with a data uri requires "
                         "--num-class")
            args.num_class = 4  # the synthetic multiclass default
        learner = GBDTLearner(
            device=dev, group=group, objective=args.objective,
            num_class=args.num_class, num_trees=args.num_trees,
            max_depth=args.max_depth, learning_rate=args.learning_rate,
            num_bins=args.num_bins)
        log_every = max(1, args.num_trees // 5)
        t0 = time.time()
        if args.synthetic or not args.uri:
            x, y = _synthetic_multiclass(args.num_class) if softmax \
                else _synthetic()
            edges = None
            xs, ys = x, y
            if group is not None:
                n = (x.shape[0] // args.dp) * args.dp
                x, y = x[:n], y[:n]
                # every rank bins with the whole matrix's edges
                edges = fit_bins(torch.as_tensor(x, device=dev),
                                 args.num_bins)
                per = n // args.dp
                xs, ys = (x[rank * per:(rank + 1) * per],
                          y[rank * per:(rank + 1) * per])
            history = learner.fit(xs, ys, log_every=log_every, edges=edges)
            dt = time.time() - t0
        else:
            if args.num_features <= 0:
                ap.error("--num-features is required with a data uri")
            edges = None
            if group is not None:
                whole, _ = _load_dense(args.uri, args.num_features, 0, 1,
                                       dev)
                edges = fit_bins(torch.as_tensor(whole, device=dev),
                                 args.num_bins)
            history = learner.fit_uri(
                args.uri, args.num_features, part_index=rank,
                num_parts=max(1, args.dp), log_every=log_every,
                drop_remainder=group is not None, edges=edges)
            dt = time.time() - t0  # the fit only, not the eval reload
            x, y = _load_dense(args.uri, args.num_features, 0, 1, dev)
        if rank != 0:
            return 0
        prob = learner.predict(x)
        acc = float(np.mean(prob.argmax(axis=1) == y)) if softmax \
            else float(np.mean((prob > 0.5) == (y > 0.5)))
        print(
            f"trees={args.num_trees} depth={args.max_depth} "
            f"rows={x.shape[0]} loss {history[0]:.4f} -> {history[-1]:.4f} "
            f"train-acc {acc:.4f} fit {dt:.2f}s"
            + (f" (dp={args.dp} histogram psum)" if group is not None
               else ""), flush=True)
        if args.save:
            learner.save(args.save)
            print(f"saved -> {args.save}")
        return 0
    finally:
        if group is not None:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.dp or args.rank is not None:
        return _run(args, ap)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "dmlc_tpu_torch.examples.boosted_trees"
               ] + list(argv if argv is not None else sys.argv[1:])
        procs = [subprocess.Popen(
            cmd + ["--rank", str(r), "--init", f"file://{tmp}/pg"], env=env)
            for r in range(args.dp)]
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

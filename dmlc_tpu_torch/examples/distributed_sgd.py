"""Distributed allreduce-SGD on LibSVM data, the counterpart of
``examples/distributed_sgd.py``. Runs under the port's launcher, which
exports the DMLC_* env contract::

    python -m dmlc_tpu_torch.tracker.submit --cluster local -n 2 \\
        --host-ip 127.0.0.1 python -m dmlc_tpu_torch.examples.distributed_sgd \\
        data.svm [--device cpu]

or alone (world size 1)::

    python -m dmlc_tpu_torch.examples.distributed_sgd data.svm [--epochs N]

Each worker reads its own InputSplit part (part = rank of world), its
text tokenized on ``--device`` (the ``tokenize_boundaries`` kernel on the
card unless ``--device cpu``), computes a local logistic-regression
gradient per block in float64 numpy, allreduces it (the socket engine's
tree under the launcher) and steps. ``checkpoint`` / ``load_checkpoint``
let a restarted worker resume at the last committed epoch. Rank 0 prints
``epoch N: loss=... examples=...`` through the tracker, as the JAX
package's example does.
"""

import argparse
import sys

import numpy as np

from dmlc_tpu_torch import collective as rabit
from dmlc_tpu_torch.data import create_parser


def sigmoid(x):
    return 0.5 * (1.0 + np.tanh(0.5 * x))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("uri")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--num-features", type=int, default=0,
                    help="0 = discover from the data (epoch-0 max index + 1)")
    ap.add_argument("--checkpoint-uri", default="")
    ap.add_argument("--shuffle", type=int, default=None, metavar="SEED",
                    help="visit each epoch's chunks in seeded random "
                         "order (?shuffle_chunks=SEED+epoch)")
    ap.add_argument("--device", default=None,
                    help="where the text is tokenized (default: the card)")
    args = ap.parse_args(argv)

    def epoch_uri(epoch: int) -> str:
        if args.shuffle is None:
            return args.uri
        sep = "&" if "?" in args.uri else "?"
        return f"{args.uri}{sep}shuffle_chunks={args.shuffle + epoch}"

    rabit.init()
    rank, world = rabit.rank(), rabit.world_size()

    start_epoch = 0
    ckpt = rabit.load_checkpoint(args.checkpoint_uri or None)
    if ckpt is not None:
        # the checkpoint fixes w, and so the feature-space width
        start_epoch, w = ckpt
        if rank == 0:
            rabit.tracker_print(f"resumed at epoch {start_epoch}")
    else:
        num_features = args.num_features
        if num_features == 0:
            parser = create_parser(args.uri, rank, world, device=args.device)
            local_max = 0
            for block in parser:
                if len(block.index):
                    local_max = max(local_max, int(block.index.max()))
            parser.close()
            num_features = int(
                rabit.allreduce(np.array([local_max], np.int64), op="max")[0]
            ) + 1
        w = np.zeros(num_features + 1, dtype=np.float64)  # [weights, bias]

    for epoch in range(start_epoch, args.epochs):
        parser = create_parser(epoch_uri(epoch), rank, world,
                               device=args.device)
        grad = np.zeros_like(w)
        loss = 0.0
        weight_sum = 0.0
        for block in parser:
            # the CSR block's margins by segment sums (the numpy twin of
            # the learner's csr step)
            n = len(block)
            vals = (block.value if block.value is not None
                    else np.ones_like(block.index, np.float32))
            row_ids = np.repeat(np.arange(n), np.diff(block.offset))
            margins = np.bincount(
                row_ids, weights=vals * w[block.index], minlength=n
            ) + w[-1]
            y = (block.label > 0).astype(np.float64)
            g = sigmoid(margins) - y
            np.add.at(grad[:-1], block.index, g[row_ids] * vals)
            grad[-1] += g.sum()
            loss += float(
                np.sum(np.maximum(margins, 0) - margins * y
                       + np.log1p(np.exp(-np.abs(margins)))))
            weight_sum += len(block)
        parser.close()

        # one allreduce of [grad, loss, count]
        packed = np.concatenate([grad, [loss, weight_sum]])
        packed = rabit.allreduce(packed, op="sum")
        grad, loss, weight_sum = packed[:-2], packed[-2], packed[-1]
        denom = max(weight_sum, 1e-12)
        w -= args.lr * grad / denom
        if rank == 0:
            rabit.tracker_print(
                f"epoch {epoch}: loss={loss / denom:.6f} "
                f"examples={int(weight_sum)}")
        # only rank 0 writes the shared uri (w is the same on every rank)
        rabit.checkpoint(
            (epoch + 1, w),
            (args.checkpoint_uri or None) if rank == 0 else None)

    rabit.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())

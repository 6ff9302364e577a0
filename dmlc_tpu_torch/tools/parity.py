"""Bit-parity harness for the allreduce-SGD loop: a world of socket-engine
processes on the CPU against one process on the card (or the CPU), the
port of ``dmlc_tpu/tools/parity.py``.

1. **Reduction-order control: bit-exact by construction on one device.**
   Gradients cross the socket engine as a ``[W, N]`` slot exchange: rank r
   contributes its packed gradients in row r and zeros elsewhere, so under
   any fold order (tree, ring, any world) row r of the sum is rank r's
   bytes (``0.0 + x == x`` bitwise for every x but -0.0, which lands as
   +0.0; both criteria treat ±0 as equal). Every path then folds rows 0..W-1
   left to right in f32 and applies the SGD update in host numpy. The
   single process computes the same W per-part gradients (the same
   InputSplit parts, the same kernel) and folds them the same way, so on
   one device the two paths give bit-identical trajectories for any W and
   either topology. Gradients are computed with one CPU thread on both
   paths, so that the CPU's sums do not depend on a thread count.

2. **Across devices: a measurement.** The card's gradients sum in another
   order than the host's; by construction that is the only difference
   left. The harness reports the per-step ``[W, N]`` gradient matrices'
   largest ulp distance and holds the loss trajectory to ``--rtol``.

Usage::

    python -m dmlc_tpu_torch.tools.parity [--world 2] [--steps 5] [--uri U]
        [--force-ring] [--single-backend default|cpu] [--rtol 1e-5]
        [--single-kernel default|reordered|perturbed]
        [--criterion auto|bitexact|rtol]

``--single-backend default`` runs the single process on the card (and
raises without one); ``cpu`` on the host. Prints ONE JSON line: the
bit-exact flag, the largest gradient ulp distance, parameter difference and
loss relative difference, both paths' per-step losses and devices. Exit 0
iff parity holds (bit-exact on one device, within rtol across devices).
Trackers bind ports 21500-21599.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing as mp
import os
import sys
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.ops.objectives import margin_loss_grad
from dmlc_tpu_torch.utils.device import resolve_device

_PACK_TAIL = 3  # gb, loss_sum, wsum appended to gw
TRACKER_PORTS = (21500, 21600)


def _part_dense(uri: str, part: int, nparts: int, num_features: int,
                device) -> Tuple[np.ndarray, np.ndarray]:
    """Part k/n of the libsvm uri as dense [rows, F] f32 + labels. Both
    paths use this same partition, so the per-part row sets match."""
    from dmlc_tpu_torch.data import create_parser

    parser = create_parser(uri, part, nparts, nthread=1, device=device)
    try:
        blocks = list(parser)
    finally:
        parser.close()
    return (np.concatenate([b.to_dense(num_features) for b in blocks]),
            np.concatenate([np.asarray(b.label, np.float32)
                            for b in blocks]))


def _make_grad_fn(kernel: str = "default"):
    """The local-gradient kernel both paths share: (w, b, x, y) tensors →
    (gw, gb, loss_sum, rows).

    ``reordered`` computes the same math with another accumulation order
    and precision (float64 products and sums, cast to f32): a stand-in for
    a second device's summation order, so that the rtol arm can be tested
    on a host without a card. ``perturbed`` shifts the margin by 1e-4,
    which moves the loss trajectory itself."""
    if kernel == "reordered":
        def grads(w, b, x, y):
            x64 = x.double()
            margin = (x64 @ w.double() + b.double()).float()
            loss, gmargin = margin_loss_grad("logistic", margin, y)
            gw = (x64.T @ gmargin.double()).float()
            return gw, gmargin.sum(), loss.sum(), float(x.shape[0])
        return grads
    shift = 1e-4 if kernel == "perturbed" else 0.0

    def grads(w, b, x, y):
        margin = x @ w + b
        if shift:
            margin = margin + shift
        loss, gmargin = margin_loss_grad("logistic", margin, y)
        return x.T @ gmargin, gmargin.sum(), loss.sum(), float(x.shape[0])

    return grads


@contextlib.contextmanager
def _one_cpu_thread():
    """torch's CPU sums split over threads: one thread fixes their order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _pack(gw, gb, loss_sum, wsum) -> np.ndarray:
    return np.concatenate([
        np.asarray(gw.cpu(), np.float32),
        np.asarray([float(gb), float(loss_sum), wsum], np.float32),
    ])


def _fold_update(mat: np.ndarray, w: np.ndarray, b: np.float32,
                 lr: float) -> Tuple[np.ndarray, np.float32, float]:
    """Left fold of the [W, N] rows + SGD update, all host numpy f32: the
    same arithmetic on every path."""
    acc = mat[0].copy()
    for r in range(1, mat.shape[0]):
        acc = acc + mat[r]
    gw = acc[:-_PACK_TAIL]
    gb, loss_sum, wsum = acc[-_PACK_TAIL:]
    denom = np.float32(max(wsum, np.float32(1e-12)))
    w = w - np.float32(lr) * (gw / denom)
    b = np.float32(b - np.float32(lr) * (gb / denom))
    return w, b, float(loss_sum / denom)


def _grad_row(grad_fn, w, b, x, y, device) -> np.ndarray:
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return _pack(*grad_fn(t(w), t(np.float32(b)), t(x), t(y)))


def _run_steps(part_data, grad_fn, steps: int, lr: float, device):
    """The single process: per-part grads → [W, N] matrix → fold/update.
    Returns (per-step losses, per-step grad matrices, final w, b)."""
    num_features = part_data[0][0].shape[1]
    w = np.zeros(num_features, np.float32)
    b = np.float32(0.0)
    losses, mats = [], []
    for _ in range(steps):
        mat = np.stack([_grad_row(grad_fn, w, b, x, y, device)
                        for x, y in part_data])
        mats.append(mat)
        w, b, loss = _fold_update(mat, w, b, lr)
        losses.append(loss)
    return losses, mats, w, b


def _worker(uri, rank, world, steps, lr, num_features, tracker_port,
            force_ring, q):
    """One socket-engine rank on the CPU."""
    from dmlc_tpu_torch.collective.socket_engine import SocketEngine

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    x, y = _part_dense(uri, rank, world, num_features, cpu)
    engine = SocketEngine(tracker_uri="127.0.0.1",
                          tracker_port=tracker_port, world_size=world)
    if force_ring:
        engine.ring_threshold_bytes = 0
    try:
        grad_fn = _make_grad_fn()
        w = np.zeros(num_features, np.float32)
        b = np.float32(0.0)
        losses, mats = [], []
        for _ in range(steps):
            row = _grad_row(grad_fn, w, b, x, y, cpu)
            slot = np.zeros((world, row.shape[0]), np.float32)
            slot[rank] = row  # the part's row, whatever rank the tracker gave
            mat = engine.allreduce(slot)  # rows travel bit-exactly
            mats.append(mat)
            w, b, loss = _fold_update(mat, w, b, lr)
            losses.append(loss)
        if rank == 0:
            q.put({"losses": losses, "w": w, "b": float(b), "mats": mats})
    finally:
        engine.shutdown()


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Max ulp distance between two f32 arrays: bit patterns mapped to a
    total order (positive floats keep their bits; negative floats mirror
    below zero so ±0.0 coincide and the line is monotonic), then diffed."""
    def ordinal(x):
        bits = x.astype(np.float32).view(np.uint32).astype(np.int64)
        return np.where(bits < (1 << 31), bits, (1 << 31) - bits)

    if a.size == 0:
        return 0
    return int(np.max(np.abs(ordinal(a) - ordinal(b))))


def _ensure_default_data(num_features: int) -> str:
    """The default data set (2000 rows, seed 11) in the temp directory."""
    path = os.path.join(tempfile.gettempdir(),
                        f"dmlc_tpu_torch_parity_{num_features}.svm")
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return path
    rng = np.random.RandomState(11)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        for _ in range(2000):
            label = rng.randint(0, 2)
            vals = rng.rand(num_features)
            fh.write(str(label) + " " + " ".join(
                f"{j}:{vals[j]:.6f}" for j in range(num_features)) + "\n")
    os.replace(tmp, path)
    return path


def run_parity(uri: Optional[str] = None, world: int = 2, steps: int = 5,
               lr: float = 0.5, num_features: int = 12,
               force_ring: bool = False, single_backend: str = "default",
               rtol: float = 1e-5, single_kernel: str = "default",
               criterion: str = "auto") -> dict:
    """Run both paths; → the report dict (the JSON line's content).

    ``single_backend`` "default" runs the single process on the card
    (``device=None``: raises without one), "cpu" on the host.
    ``criterion`` "auto" is bit-exact when both paths run on the CPU with
    the default kernel, rtol otherwise; "rtol" forces the cross-device
    arm (with ``single_kernel="reordered"`` it proves the rtol machinery
    end to end on a host without a card)."""
    from dmlc_tpu_torch.tracker import RabitTracker

    if single_backend not in ("default", "cpu"):
        raise ValueError(f"single_backend must be default or cpu, got "
                         f"{single_backend!r}")
    device = resolve_device(None if single_backend == "default" else "cpu")
    if uri is None:
        uri = _ensure_default_data(num_features)

    # the socket world on the CPU
    tracker = RabitTracker("127.0.0.1", world, port=TRACKER_PORTS[0],
                           port_end=TRACKER_PORTS[1])
    tracker.start(world)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(uri, r, world, steps, lr, num_features,
                               tracker.port, force_ring, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        socket_out = q.get(timeout=300)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        tracker.close()

    # the single process, on the card unless asked for the CPU
    part_data = [_part_dense(uri, k, world, num_features, device)
                 for k in range(world)]
    with _one_cpu_thread():
        losses, mats, w, b = _run_steps(
            part_data, _make_grad_fn(single_kernel), steps, lr, device)

    max_grad_ulp = max(
        _ulp_diff(sm, dm) for sm, dm in zip(socket_out["mats"], mats))
    loss_rel = [abs(a - c) / max(abs(c), 1e-12)
                for a, c in zip(socket_out["losses"], losses)]
    bitexact = (
        max_grad_ulp == 0
        and np.array_equal(socket_out["w"], w)
        and socket_out["b"] == float(b)
        and socket_out["losses"] == losses
    )
    same_device = device.type == "cpu" and single_kernel == "default"
    if criterion == "auto":
        criterion = "bitexact" if same_device else "rtol"
    return {
        "world": world,
        "steps": steps,
        "topology": "ring" if force_ring else "tree",
        "socket_backend": "cpu",
        "single_backend": device.type,
        "single_device_name": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
        "single_kernel": single_kernel,
        "bitexact": bitexact,
        "max_grad_ulp": max_grad_ulp,
        "max_param_abs_diff": float(np.max(np.abs(socket_out["w"] - w))),
        "max_loss_rel": max(loss_rel) if loss_rel else 0.0,
        "rtol": rtol,
        "criterion": criterion,
        "socket_losses": socket_out["losses"],
        "single_losses": losses,
        "pass": bool(
            bitexact if criterion == "bitexact"
            else (bool(loss_rel) and max(loss_rel) <= rtol)),
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--uri", default=None)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--features", type=int, default=12)
    ap.add_argument("--force-ring", action="store_true")
    ap.add_argument("--single-backend", default="default",
                    choices=["default", "cpu"],
                    help="default: the single process on the card")
    ap.add_argument("--rtol", type=float, default=1e-5)
    ap.add_argument("--single-kernel", default="default",
                    choices=["default", "reordered", "perturbed"],
                    help="'reordered' = another accumulation order, the "
                         "stand-in for a second device on a host")
    ap.add_argument("--criterion", default="auto",
                    choices=["auto", "bitexact", "rtol"],
                    help="force the comparison arm (auto: bitexact on one "
                         "device, rtol across)")
    args = ap.parse_args(argv)
    out = run_parity(
        uri=args.uri, world=args.world, steps=args.steps, lr=args.lr,
        num_features=args.features, force_ring=args.force_ring,
        single_backend=args.single_backend, rtol=args.rtol,
        single_kernel=args.single_kernel, criterion=args.criterion,
    )
    print(json.dumps(out))
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())

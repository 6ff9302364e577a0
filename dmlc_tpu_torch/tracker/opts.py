"""Command-line options of ``python -m dmlc_tpu_torch.tracker.submit``:
the part of ``dmlc_tpu/tracker/opts.py`` (tracker/dmlc_tracker/opts.py)
that the local launcher reads, under the same names and defaults, with
the ``DMLC_SUBMIT_CLUSTER`` env default of ``--cluster`` (opts.py:
168-174). The cluster list is the JAX package's: naming a cluster the
port has no launcher for fails in ``launchers.get_launcher``.
``--status-port`` waits for the status plane."""

from __future__ import annotations

import argparse
import os

CLUSTERS = ("local", "ssh", "mpi", "sge", "slurm", "yarn", "mesos",
            "kubernetes", "tpu")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m dmlc_tpu_torch.tracker.submit",
        description="Submit a distributed dmlc_tpu_torch job.")
    cluster_default = os.environ.get("DMLC_SUBMIT_CLUSTER")
    parser.add_argument(
        "--cluster", type=str, choices=list(CLUSTERS),
        default=cluster_default, required=cluster_default is None,
        help="Cluster backend to submit the job to (default from "
        "DMLC_SUBMIT_CLUSTER); only local is ported.")
    parser.add_argument(
        "-n", "--num-workers", required=True, type=int,
        help="Number of worker processes to launch.")
    parser.add_argument(
        "-s", "--num-servers", default=0, type=int,
        help="Number of parameter-server processes (the PS scheduler is "
        "not ported: must be 0).")
    parser.add_argument(
        "--log-level", default="INFO", type=str, choices=["INFO", "DEBUG"],
        help="Logging level.")
    parser.add_argument("--log-file", default=None, type=str,
                        help="Also append tracker logs to this file.")
    parser.add_argument(
        "--host-ip", default=None, type=str,
        help="Tracker IP the workers connect back to.")
    parser.add_argument(
        "--env", action="append", default=[],
        help="Extra NAME=VALUE env vars to forward to tasks.")
    parser.add_argument(
        "--max-attempts", default=None, type=int,
        help="Per-task restart attempts (DMLC_NUM_ATTEMPT / "
        "DMLC_MAX_ATTEMPT).")
    parser.add_argument(
        "--elastic", action="store_true", default=False,
        help="Enable elastic membership (sets DMLC_TPU_ELASTIC): workers "
        "may join, be evicted, and be replaced mid-run at rendezvous "
        "boundaries instead of failing the job.")
    parser.add_argument(
        "--spares", default=0, type=int,
        help="Warm-spare worker tasks to launch beyond --num-workers; they "
        "park on the tracker's join handshake until a membership "
        "transition calls them up (local cluster only).")
    parser.add_argument(
        "command", nargs=argparse.REMAINDER,
        help="Command to launch on every task.")
    return parser


def get_opts(argv=None) -> argparse.Namespace:
    """Parse ``argv``: the command is what follows the options (a leading
    ``--`` dropped), and ``--env`` pairs become ``args.env_map``. Raises
    ValueError for no command or a malformed ``--env``."""
    args, unknown = build_parser().parse_known_args(argv)
    rem = list(args.command or [])
    if rem and rem[0] == "--":
        rem = rem[1:]
    args.command = rem + list(unknown)
    if not args.command:
        raise ValueError("no command to launch — pass it after the options")
    env_pairs = {}
    for item in args.env:
        if "=" not in item:
            raise ValueError(f"--env expects NAME=VALUE, got {item!r}")
        k, v = item.split("=", 1)
        env_pairs[k] = v
    args.env_map = env_pairs
    return args

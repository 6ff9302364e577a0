"""Command-line options of ``python -m dmlc_tpu_torch.tracker.submit``, the
port of ``dmlc_tpu/tracker/opts.py`` (tracker/dmlc_tracker/opts.py): the
same option names, defaults and cluster list, memory-string parsing
(opts.py:39-57), the automatic file caching that rewrites local paths in
the command to shipped ``./basename`` paths (get_cache_file_set,
opts.py:6-36), and the ``DMLC_SUBMIT_CLUSTER`` env default of
``--cluster`` (opts.py:168-174).

The JAX package's ``tpu`` cluster is ``gpu`` here (one process per card,
``tracker/launchers/gpu.py``), and its ``--tpu-hosts`` /
``--tpu-coordinator-port`` are ``--gpu-hosts`` / ``--gpu-coordinator-port``
(same default, 8476), with ``--gpus-per-host`` (default 1) for the card a
host's k-th entry sees.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Set, Tuple

CLUSTERS = (
    "local",
    "ssh",
    "mpi",
    "sge",
    "slurm",
    "yarn",
    "mesos",
    "kubernetes",
    "gpu",
)


def get_memory_mb(mem_str: str) -> int:
    """Parse '1g'/'512m'/'2048' into MB (opts.py:39-57)."""
    s = str(mem_str).strip().lower()
    if s.endswith("g"):
        return int(float(s[:-1]) * 1024)
    if s.endswith("m"):
        return int(float(s[:-1]))
    return int(s)


def get_cache_file_set(args) -> Tuple[Set[str], List[str]]:
    """Scan the command for local files to auto-ship (opts.py:6-36).

    Returns (fileset, rewritten_command): each command token naming an
    existing local file is added to the cache set and rewritten to its
    basename (the launcher ships it into the task working directory).
    """
    fset: Set[str] = set()
    for fname in args.files:
        fset.add(fname)
    command: List[str] = []
    for i, tok in enumerate(args.command):
        if args.auto_file_cache and os.path.exists(tok) and os.path.isfile(tok):
            fset.add(tok)
            if i == 0 and tok.endswith(".py"):
                command.append(f"python {os.path.basename(tok)}")
            else:
                command.append(f"./{os.path.basename(tok)}")
        else:
            command.append(tok)
    return fset, command


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m dmlc_tpu_torch.tracker.submit",
        description="Submit a distributed dmlc_tpu_torch job to a cluster.",
    )
    cluster_default = os.environ.get("DMLC_SUBMIT_CLUSTER")
    parser.add_argument(
        "--cluster",
        type=str,
        choices=list(CLUSTERS),
        default=cluster_default,
        required=cluster_default is None,
        help="Cluster backend to submit the job to "
        "(default from DMLC_SUBMIT_CLUSTER).",
    )
    parser.add_argument(
        "-n", "--num-workers", required=True, type=int,
        help="Number of worker processes to launch.",
    )
    parser.add_argument(
        "--worker-cores", default=1, type=int,
        help="CPU cores requested per worker.",
    )
    parser.add_argument(
        "--worker-memory", default="1g", type=str,
        help="Memory per worker, e.g. 1g / 512m.",
    )
    parser.add_argument(
        "-s", "--num-servers", default=0, type=int,
        help="Number of parameter-server processes.",
    )
    parser.add_argument(
        "--server-cores", default=1, type=int,
        help="CPU cores requested per server.",
    )
    parser.add_argument(
        "--server-memory", default="1g", type=str,
        help="Memory per server, e.g. 1g / 512m.",
    )
    parser.add_argument("--jobname", default=None, type=str, help="Job name.")
    parser.add_argument(
        "--queue", default="default", type=str, help="Cluster queue to submit to."
    )
    parser.add_argument(
        "--log-level", default="INFO", type=str,
        choices=["INFO", "DEBUG"], help="Logging level.",
    )
    parser.add_argument("--log-file", default=None, type=str,
                        help="Also append tracker logs to this file.")
    parser.add_argument(
        "--host-ip", default=None, type=str,
        help="Tracker IP the workers connect back to.",
    )
    parser.add_argument(
        "-H", "--host-file", default=None, type=str,
        help="Hostfile (one 'ip[:port]' per line) for ssh/mpi/gpu clusters.",
    )
    parser.add_argument(
        "--sge-log-dir", default=None, type=str,
        help="Directory for SGE stdout/stderr logs.",
    )
    parser.add_argument(
        "--auto-file-cache", default=True, type=lambda s: s not in ("0", "false"),
        help="Auto-ship local files named in the command.",
    )
    parser.add_argument(
        "--files", default=[], action="append",
        help="Extra files to ship to the task directory.",
    )
    parser.add_argument(
        "--archives", default=[], action="append",
        help="Archives to ship and unpack in the task directory.",
    )
    parser.add_argument(
        "--env", action="append", default=[],
        help="Extra NAME=VALUE env vars to forward to tasks.",
    )
    parser.add_argument(
        "--hdfs-tempdir", default="/tmp", type=str,
        help="Temp directory on the shared FS for shipped files.",
    )
    parser.add_argument(
        "--ship-libcxx", default=None, type=str,
        help="Path to a libstdc++ directory to ship with the job.",
    )
    parser.add_argument(
        "--sync-dst-dir", default=None, type=str,
        help="rsync the current directory to this path on every host first.",
    )
    parser.add_argument(
        "--slurm-worker-nodes", default=None, type=int,
        help="Node count for the worker srun allocation.",
    )
    parser.add_argument(
        "--slurm-server-nodes", default=None, type=int,
        help="Node count for the server srun allocation.",
    )
    parser.add_argument(
        "--mesos-master", default=None, type=str, help="Mesos master URI."
    )
    parser.add_argument(
        "--kube-namespace", default="default", type=str,
        help="Kubernetes namespace.",
    )
    parser.add_argument(
        "--kube-worker-image", default="python:3.11", type=str,
        help="Container image for workers.",
    )
    parser.add_argument(
        "--kube-server-image", default="python:3.11", type=str,
        help="Container image for servers.",
    )
    parser.add_argument(
        "--yarn-app-classpath", default=None, type=str,
        help="Override YARN application classpath.",
    )
    # --- gpu cluster options ---
    parser.add_argument(
        "--gpu-coordinator-port", default=8476, type=int,
        help="Port of the torch.distributed store on host 0 "
        "(DMLC_TPU_COORDINATOR).",
    )
    parser.add_argument(
        "--gpu-hosts", default=None, type=str,
        help="Comma-separated host list, one entry per card "
        "(localhost,localhost: two processes on this host); default from "
        "--host-file, else localhost.",
    )
    parser.add_argument(
        "--gpus-per-host", default=1, type=int,
        help="Cards a host has: a host's k-th entry gets "
        "CUDA_VISIBLE_DEVICES=k mod this.",
    )
    parser.add_argument(
        "--max-attempts", default=None, type=int,
        help="Per-task restart attempts (DMLC_NUM_ATTEMPT / DMLC_MAX_ATTEMPT).",
    )
    parser.add_argument(
        "--status-port", default=None, type=int,
        help="Start the tracker HTTP status server on this port "
        "(0 = ephemeral; sets DMLC_TPU_STATUS_PORT). Serves /healthz, "
        "/workers, /metrics, /trace, /data, /goodput, /audit, /xla and "
        "/profile.",
    )
    parser.add_argument(
        "--elastic", action="store_true", default=False,
        help="Enable elastic membership (sets DMLC_TPU_ELASTIC): workers "
        "may join, be evicted, and be replaced mid-run at rendezvous "
        "boundaries instead of failing the job.",
    )
    parser.add_argument(
        "--spares", default=0, type=int,
        help="Warm-spare worker tasks to launch beyond --num-workers; they "
        "park on the tracker's join handshake until a membership "
        "transition calls them up (local cluster only).",
    )
    parser.add_argument(
        "command", nargs=argparse.REMAINDER,
        help="Command to launch on every task.",
    )
    return parser


def get_opts(argv=None) -> argparse.Namespace:
    """Parse argv into a namespace; normalizes env list and memory fields."""
    args, unknown = build_parser().parse_known_args(argv)
    # argparse.REMAINDER can swallow a leading '--' separator; drop only
    # that one — inner '--' tokens belong to the user's command
    rem = list(args.command or [])
    if rem and rem[0] == "--":
        rem = rem[1:]
    args.command = rem + list(unknown)
    if not args.command:
        raise ValueError("no command to launch — pass it after the options")
    args.worker_memory_mb = get_memory_mb(args.worker_memory)
    args.server_memory_mb = get_memory_mb(args.server_memory)
    env_pairs = {}
    for item in args.env:
        if "=" not in item:
            raise ValueError(f"--env expects NAME=VALUE, got {item!r}")
        k, v = item.split("=", 1)
        env_pairs[k] = v
    args.env_map = env_pairs
    return args

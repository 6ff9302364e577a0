"""MPI launcher, the port of ``dmlc_tpu/tracker/launchers/mpi.py``
(tracker/dmlc_tracker/mpi.py).

Builds ``mpirun -n N`` with env forwarding in the flavor of the detected
MPI: OpenMPI uses repeated ``-x NAME=VALUE`` and MPICH uses ``-env NAME
VALUE`` (mpi.py:12-36). Workers and servers are two mpirun invocations with
different DMLC_ROLE.
"""

from __future__ import annotations

import subprocess
import threading
from typing import Dict, List, Optional

from dmlc_tpu_torch.tracker.launchers.common import task_env
from dmlc_tpu_torch.tracker.rendezvous import submit_with_tracker


def detect_mpi_flavor() -> str:
    """'openmpi' | 'mpich' from `mpirun --version` (mpi.py:14-24)."""
    try:
        out = subprocess.run(
            ["mpirun", "--version"], capture_output=True, text=True, timeout=10
        ).stdout.lower()
    except (OSError, subprocess.TimeoutExpired):
        return "openmpi"
    return "mpich" if ("mpich" in out or "hydra" in out) else "openmpi"


def plan_mpirun(
    n: int,
    role: str,
    env: Dict[str, str],
    command: List[str],
    flavor: str = "openmpi",
    hostfile: Optional[str] = None,
) -> List[str]:
    """One mpirun invocation for n tasks of a role (mpi.py:26-36)."""
    argv: List[str] = ["mpirun", "-n", str(n)]
    if hostfile:
        argv += ["--hostfile", hostfile]
    if flavor == "openmpi":
        for k, v in sorted(env.items()):
            argv += ["-x", f"{k}={v}"]
    else:  # mpich
        for k, v in sorted(env.items()):
            argv += ["-env", k, str(v)]
    return argv + list(command)


def plan(args, nworker: int, nserver: int, envs: Dict[str, object],
         flavor: Optional[str] = None):
    flavor = flavor or detect_mpi_flavor()
    out = []
    if nworker > 0:
        # DMLC_TASK_ID comes from the MPI rank downstream; pass 0 as base
        env = task_env(envs, 0, "worker", "mpi", extra=args.env_map)
        del env["DMLC_TASK_ID"]
        out.append(plan_mpirun(nworker, "worker", env, args.command,
                               flavor, args.host_file))
    if nserver > 0:
        env = task_env(envs, 0, "server", "mpi", extra=args.env_map)
        del env["DMLC_TASK_ID"]
        out.append(plan_mpirun(nserver, "server", env, args.command,
                               flavor, args.host_file))
    return out


def submit(args) -> None:
    threads: List[threading.Thread] = []

    def fun_submit(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        for argv in plan(args, nworker, nserver, envs):
            t = threading.Thread(
                target=lambda a=argv: subprocess.Popen(a).wait(), daemon=True
            )
            t.start()
            threads.append(t)

    submit_with_tracker(
        args.num_workers, args.num_servers, fun_submit,
        host_ip=args.host_ip or "auto",
    )
    for t in threads:
        t.join()

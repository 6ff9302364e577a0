"""Slurm launcher, the port of ``dmlc_tpu/tracker/launchers/slurm.py``
(tracker/dmlc_tracker/slurm.py).

Workers and servers each get an ``srun`` allocation with the DMLC env
exported through ``--export`` (the reference uses an env-prefix; --export is
the srun-native equivalent). Node counts come from --slurm-worker-nodes /
--slurm-server-nodes when given.
"""

from __future__ import annotations

import subprocess
import threading
from typing import Dict, List, Optional

from dmlc_tpu_torch.tracker.launchers.common import task_env
from dmlc_tpu_torch.tracker.rendezvous import submit_with_tracker


def plan_srun(
    n: int,
    env: Dict[str, str],
    command: List[str],
    nodes: Optional[int] = None,
    cores: int = 1,
    memory_mb: int = 1024,
) -> List[str]:
    # env-prefix form (the reference's style): srun propagates the caller's
    # environment by default, and unlike --export=k=v,... it is safe for
    # values containing commas (CUDA_VISIBLE_DEVICES, LD_LIBRARY_PATH)
    argv = ["env"] + [f"{k}={v}" for k, v in sorted(env.items())]
    argv += ["srun", f"--ntasks={n}", f"--cpus-per-task={cores}",
             f"--mem-per-cpu={memory_mb}M"]
    if nodes:
        argv.append(f"--nodes={nodes}")
    return argv + list(command)


def plan(args, nworker: int, nserver: int, envs: Dict[str, object]):
    out = []
    if nworker > 0:
        env = task_env(envs, 0, "worker", "slurm", extra=args.env_map)
        del env["DMLC_TASK_ID"]  # derived from SLURM_PROCID downstream
        out.append(plan_srun(nworker, env, args.command,
                             args.slurm_worker_nodes, args.worker_cores,
                             args.worker_memory_mb))
    if nserver > 0:
        env = task_env(envs, 0, "server", "slurm", extra=args.env_map)
        del env["DMLC_TASK_ID"]
        out.append(plan_srun(nserver, env, args.command,
                             args.slurm_server_nodes, args.server_cores,
                             args.server_memory_mb))
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

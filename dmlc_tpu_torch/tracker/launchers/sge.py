"""Sun Grid Engine launcher, the port of
``dmlc_tpu/tracker/launchers/sge.py`` (tracker/dmlc_tracker/sge.py).

Writes a generated ``rundmlc.sh`` that computes the task's role and id from
the SGE array-task id (the reference derives role from task id in
launcher.py:41-47) and submits it as ``qsub -t 1-N`` array job.
"""

from __future__ import annotations

import os
import stat
import subprocess
from typing import Dict, List

from dmlc_tpu_torch.tracker.launchers.common import export_prefix, task_env
from dmlc_tpu_torch.tracker.rendezvous import submit_with_tracker

RUN_SCRIPT = "rundmlc.sh"


def plan_run_script(
    env: Dict[str, str], command: str, nworker: int, nserver: int
) -> str:
    """The array-task bootstrap script: role/task-id from SGE_TASK_ID."""
    lines = [
        "#!/bin/bash",
        export_prefix(env),
        # SGE_TASK_ID is 1-based; tasks [1, nworker] are workers
        f"TID=$((SGE_TASK_ID - 1))",
        f"if [ $TID -lt {nworker} ]; then",
        "  export DMLC_ROLE=worker",
        "  export DMLC_TASK_ID=$TID",
        "else",
        "  export DMLC_ROLE=server",
        f"  export DMLC_TASK_ID=$((TID - {nworker}))",
        "fi",
        command,
    ]
    return "\n".join(lines) + "\n"


def plan_qsub(
    script: str, ntasks: int, queue: str, cores: int, log_dir: str, jobname: str
) -> List[str]:
    argv = ["qsub", "-cwd", "-t", f"1-{ntasks}", "-S", "/bin/bash",
            "-q", queue, "-pe", "smp", str(cores), "-N", jobname]
    if log_dir:
        argv += ["-o", log_dir, "-e", log_dir]
    argv.append(script)
    return argv


def submit(args) -> None:
    def fun_submit(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        env = task_env(envs, 0, "worker", "sge", extra=args.env_map)
        # role/task-id are decided inside the script, drop the placeholders
        for k in ("DMLC_TASK_ID", "DMLC_ROLE"):
            env.pop(k, None)
        text = plan_run_script(env, " ".join(args.command), nworker, nserver)
        with open(RUN_SCRIPT, "w") as fh:
            fh.write(text)
        os.chmod(RUN_SCRIPT, os.stat(RUN_SCRIPT).st_mode | stat.S_IEXEC)
        argv = plan_qsub(
            RUN_SCRIPT, nworker + nserver, args.queue, args.worker_cores,
            args.sge_log_dir, args.jobname or "dmlc-job",
        )
        subprocess.check_call(argv)

    submit_with_tracker(
        args.num_workers, args.num_servers, fun_submit,
        host_ip=args.host_ip or "auto",
    )

"""Local launcher: N worker processes on this host, the port of
``dmlc_tpu/tracker/launchers/local.py`` (tracker/dmlc_tracker/local.py).

Each task runs the command with the DMLC_* env contract (DMLC_TASK_ID,
DMLC_ROLE, DMLC_JOB_CLUSTER=local: local.py:12-23) in a retry loop of
``--max-attempts`` tries (else DMLC_NUM_ATTEMPT, else 1; each try sees
its number in DMLC_NUM_ATTEMPT: local.py:25-44). A task that exits with
``EXIT_PREEMPTED`` (75) committed a snapshot before it stopped: it is
relaunched without spending a try, up to ``MAX_PREEMPT_RELAUNCHES``
times. ``--spares K`` adds K warm-spare tasks, worker ids past the base
world with DMLC_TPU_SPARE=1, which park in ``collective.init`` until the
tracker calls them up. The tracker learns from the task threads whether
any task still runs, so a job whose workers all die before rendezvous
fails instead of hanging.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List

from dmlc_tpu_torch.resilience.preempt import EXIT_PREEMPTED
from dmlc_tpu_torch.tracker.launchers.common import task_env
from dmlc_tpu_torch.tracker.rendezvous import submit_with_tracker

#: relaunches after exit 75 a task may take: they spend no try (a
#: preempted task did nothing wrong), but a task that keeps exiting 75
#: must not loop for ever
MAX_PREEMPT_RELAUNCHES = 32


def submit(args) -> None:
    nrepeat = args.max_attempts or int(os.environ.get("DMLC_NUM_ATTEMPT", 1))
    cmd = " ".join(args.command)
    threads: List[threading.Thread] = []

    def run_task(task_id: int, role: str, envs: Dict[str, object],
                 spare: bool = False) -> None:
        extra = dict(args.env_map)
        if spare:
            extra["DMLC_TPU_SPARE"] = "1"
        env = task_env(envs, task_id, role, "local", extra=extra)
        attempts = max(1, nrepeat)
        preempt_relaunches = 0
        while attempts > 0:
            full = os.environ.copy()
            full.update(env)
            full["DMLC_NUM_ATTEMPT"] = str(max(1, nrepeat) - attempts)
            code = subprocess.Popen(cmd, env=full, shell=True).wait()
            if code == 0:
                return
            if (code == EXIT_PREEMPTED
                    and preempt_relaunches < MAX_PREEMPT_RELAUNCHES):
                preempt_relaunches += 1
                print(f"{role} {task_id} preempted (exit {code}); "
                      f"relaunching to resume from its job snapshot "
                      f"(relaunch {preempt_relaunches})", flush=True)
                continue
            attempts -= 1
            if attempts > 0:
                print(f"{role} {task_id} exited {code}; retrying "
                      f"({attempts} attempts left)", flush=True)

    def fun_submit(nworker: int, nserver: int,
                   envs: Dict[str, object]) -> None:
        for i in range(nworker + nserver):
            role = "worker" if i < nworker else "server"
            tid = i if i < nworker else i - nworker
            t = threading.Thread(target=run_task, args=(tid, role, envs),
                                 daemon=True)
            t.start()
            threads.append(t)
        # warm spares: worker tasks past the base world, with task ids (the
        # rabit jobids) no real worker has
        for j in range(max(0, args.spares or 0)):
            t = threading.Thread(target=run_task,
                                 args=(nworker + j, "worker", envs),
                                 kwargs={"spare": True}, daemon=True)
            t.start()
            threads.append(t)

    submit_with_tracker(
        args.num_workers, args.num_servers, fun_submit,
        host_ip=args.host_ip or "auto",
        tasks_alive=lambda: any(t.is_alive() for t in threads))
    for t in threads:
        t.join()

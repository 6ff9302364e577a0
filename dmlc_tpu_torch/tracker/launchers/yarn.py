"""YARN launcher, the port of ``dmlc_tpu/tracker/launchers/yarn.py``
(tracker/dmlc_tracker/yarn.py).

The reference builds a Java ApplicationMaster jar and submits via
``hadoop jar`` with the job description in env vars (yarn.py:36-129). This
launcher reproduces the submission surface — the ``hadoop jar`` command
line, file/archive localization, per-role cores+memory env — against any
dmlc-compatible YARN AM jar (``DMLC_YARN_JAR`` env or --yarn-app-classpath);
it does not vendor the Java AM itself. The AM's retry/blacklist policy
(ApplicationMaster.java:76,212-213,332-354) exists in-repo too:
``yarn_controller.RetryController`` is the pure policy, ``drive_app``
polls the RM REST API for application-level retries, and this submit
retries the blocking submission itself up to DMLC_MAX_ATTEMPT.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List

from dmlc_tpu_torch.tracker.launchers.common import task_env
from dmlc_tpu_torch.tracker.opts import get_cache_file_set
from dmlc_tpu_torch.tracker.rendezvous import submit_with_tracker


def plan_hadoop_jar(
    args, nworker: int, nserver: int, envs: Dict[str, object], jar: str
) -> List[str]:
    env = task_env(envs, 0, "worker", "yarn", extra=args.env_map)
    for k in ("DMLC_TASK_ID", "DMLC_ROLE"):
        env.pop(k, None)
    env.update({
        "DMLC_NUM_WORKER": str(nworker),
        "DMLC_NUM_SERVER": str(nserver),
        "DMLC_WORKER_CORES": str(args.worker_cores),
        "DMLC_WORKER_MEMORY_MB": str(args.worker_memory_mb),
        "DMLC_SERVER_CORES": str(args.server_cores),
        "DMLC_SERVER_MEMORY_MB": str(args.server_memory_mb),
        "DMLC_MAX_ATTEMPT": str(args.max_attempts or 3),
        "DMLC_JOB_CLUSTER": "yarn",
    })
    fset, command = get_cache_file_set(args)
    if args.archives:
        env["DMLC_JOB_ARCHIVES"] = ",".join(args.archives)
    argv = ["hadoop", "jar", jar, "org.apache.hadoop.yarn.dmlc.Client"]
    if args.queue:
        argv += ["-queue", args.queue]
    if args.jobname:
        argv += ["-jobname", args.jobname]
    for f in sorted(fset):
        argv += ["-file", f]
    argv += ["-env", ",".join(f"{k}={v}" for k, v in sorted(env.items()))]
    argv += command
    return argv


def submit(args) -> None:
    jar = os.environ.get("DMLC_YARN_JAR") or args.yarn_app_classpath
    if not jar:
        raise RuntimeError(
            "yarn cluster needs a dmlc YARN ApplicationMaster jar: set "
            "DMLC_YARN_JAR or --yarn-app-classpath to its path"
        )

    from dmlc_tpu_torch.tracker.launchers.yarn_controller import default_max_attempt
    from dmlc_tpu_torch.utils.logging import log_info

    budget = args.max_attempts or default_max_attempt()

    def fun_submit(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        argv = plan_hadoop_jar(args, nworker, nserver, envs, jar)
        for attempt in range(budget):
            try:
                subprocess.check_call(argv)
                return
            except subprocess.CalledProcessError as err:
                if attempt + 1 >= budget:
                    raise
                log_info(
                    "yarn submission failed (rc=%d), attempt %d/%d",
                    err.returncode, attempt + 1, budget,
                )

    submit_with_tracker(
        args.num_workers, args.num_servers, fun_submit,
        host_ip=args.host_ip or "auto",
    )

"""Mesos launcher, the port of ``dmlc_tpu/tracker/launchers/mesos.py``
(tracker/dmlc_tracker/mesos.py).

The reference drives one task per worker/server with cpus/mem resources
through pymesos.subprocess (mesos.py:17-57) under a started tracker
(mesos.py:66-104). Same structure here: ``plan()`` is the pure task list
(surface-tested without a cluster), ``submit()`` starts the tracker and
drives every task on a daemon thread through the runner: pymesos, imported
at first use (a missing pymesos raises DMLCError; the JAX package's
``mesos-execute`` fallback is not ported). The runner is injectable
(``runner=``) so the drive loop itself is testable with a fake
scheduler.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

from dmlc_tpu_torch.tracker.launchers.common import task_env
from dmlc_tpu_torch.tracker.rendezvous import submit_with_tracker
from dmlc_tpu_torch.utils.logging import DMLCError

# env passed through to tasks beyond the DMLC_* contract (mesos.py:60-63)
_PASSTHROUGH = ("OMP_NUM_THREADS", "KMP_AFFINITY", "LD_LIBRARY_PATH")


def plan(args, nworker: int, nserver: int, envs: Dict[str, object]) -> List[Dict]:
    """[{name, role, task_id, cpus, mem_mb, env, command}] per task."""
    tasks = []
    for i in range(nworker + nserver):
        role = "worker" if i < nworker else "server"
        tid = i if i < nworker else i - nworker
        env = task_env(envs, tid, role, "mesos", extra=args.env_map)
        for key in _PASSTHROUGH:
            if key in os.environ:
                env.setdefault(key, os.environ[key])
        tasks.append({
            "name": f"{args.jobname or 'dmlc-job'}-{role}-{tid}",
            "role": role,
            "task_id": tid,
            "cpus": args.worker_cores if role == "worker" else args.server_cores,
            "mem_mb": (args.worker_memory_mb if role == "worker"
                       else args.server_memory_mb),
            "env": env,
            "command": " ".join(args.command),
        })
    return tasks


def _run_pymesos(task: Dict) -> None:
    import pymesos.subprocess  # noqa: PLC0415 — optional dependency

    env = {str(k): str(v) for k, v in task["env"].items()}
    pymesos.subprocess.check_call(
        task["command"], shell=True, env=env, cwd=os.getcwd(),
        cpus=task["cpus"], mem=task["mem_mb"],
    )


def _pick_runner() -> Callable[[Dict], None]:
    """The pymesos runner, its package imported here at first use. The
    JAX package falls back to the ``mesos-execute`` CLI without pymesos;
    the port does not: a missing pymesos raises."""
    try:
        import pymesos.subprocess  # noqa: F401
    except ImportError as err:
        raise DMLCError(
            "the mesos launcher needs the pymesos package, which is not "
            "installed; pass runner= to drive the tasks another way") \
            from err
    return _run_pymesos


def submit(args, runner: Optional[Callable[[Dict], None]] = None) -> None:
    if not (args.mesos_master or os.environ.get("MESOS_MASTER")):
        raise ValueError("mesos cluster needs --mesos-master")
    if args.mesos_master:
        os.environ["MESOS_MASTER"] = args.mesos_master
    run_task = runner if runner is not None else _pick_runner()
    threads: List[threading.Thread] = []
    errors: List[tuple] = []

    def run_wrapped(task: Dict) -> None:
        # a swallowed launch failure would leave the tracker waiting for
        # a worker that never comes — record it so submit() can raise
        try:
            run_task(task)
        except BaseException as err:  # noqa: BLE001 — crosses the thread
            errors.append((task["name"], err))

    def fun_submit(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        for task in plan(args, nworker, nserver, envs):
            t = threading.Thread(target=run_wrapped, args=(task,), daemon=True)
            t.start()
            threads.append(t)

    from dmlc_tpu_torch.tracker.rendezvous import RabitTracker, get_host_ip

    if args.num_servers:
        # PS jobs keep the reference's tracker composition
        submit_with_tracker(
            args.num_workers, args.num_servers, fun_submit,
            host_ip=args.host_ip or "auto",
            tasks_alive=lambda: any(t.is_alive() for t in threads),
        )
        for t in threads:
            t.join()
    else:
        # rabit jobs: join the TASK threads before the tracker so a failed
        # launch raises instead of hanging the tracker's rendezvous wait
        ip = get_host_ip(args.host_ip or "auto")
        tracker = RabitTracker(host_ip=ip, num_workers=args.num_workers)
        try:
            envs: Dict[str, object] = {
                "DMLC_NUM_WORKER": args.num_workers,
                "DMLC_NUM_SERVER": 0,
            }
            envs.update(tracker.worker_envs())
            tracker.start(args.num_workers)
            fun_submit(args.num_workers, 0, envs)
            for t in threads:
                t.join()
            if not errors:
                # all task threads are done here; if rendezvous never
                # completed the join aborts instead of hanging
                tracker.join(
                    tasks_alive=lambda: any(t.is_alive() for t in threads))
        finally:
            tracker.close()
    if errors:
        name, err = errors[0]
        raise RuntimeError(
            f"mesos task {name} failed ({len(errors)} task(s) total): {err}"
        ) from err

"""GPU launcher: ``python -m dmlc_tpu_torch.tracker.submit --cluster gpu``,
the port of ``dmlc_tpu/tracker/launchers/tpu.py``.

Spawns one worker process per **card** and exports both the classic
``DMLC_*`` contract (so rabit-style control-plane code keeps working
through the tracker) and the ``torch.distributed`` bootstrap triple that
``parallel.distributed.initialize_from_env`` reads:

- ``DMLC_TPU_COORDINATOR``  host0:port of the store rank 0 serves
- ``DMLC_TPU_NUM_PROC``     number of processes (host entries)
- ``DMLC_TPU_PROC_ID``      this process's index (== DMLC_TASK_ID)

The JAX package's contract is one process per TPU host; its counterpart
here is one process per card: a host is listed once per card it lends
the job (``--gpu-hosts a,a,b`` = two processes on host a, one on b), and
a host's k-th entry gets ``CUDA_VISIBLE_DEVICES`` = k mod
``--gpus-per-host`` (default 1), so two entries of a one-card host share
card 0 (two ranks on one card need ``backend="gloo"``: NCCL refuses
them).

The tracker's ``recover`` path (tracker.py:279-291) maps to the per-task
restart loop below plus the workers' re-initialization and checkpoint
restore: every terminated worker exits nonzero (exit 41 from
``reinit_recover``'s hung-re-init watchdog included) and ``run_task``
relaunches it with ``DMLC_NUM_ATTEMPT`` bumped, up to ``--max-attempts``;
the relaunched process rendezvouses in ``initialize_from_env`` on the same
coordinator and resumes from the shared checkpoint uri
(``collective.run_with_recovery``).

Host discovery order: ``--gpu-hosts``, ``--host-file``, else one local
process. Local entries run as local processes, others over ``ssh`` with
the env exported in the remote command.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import threading
from typing import Dict, List, Tuple

from dmlc_tpu_torch.tracker.launchers.common import export_prefix, task_env
from dmlc_tpu_torch.tracker.launchers.ssh import parse_hostfile
from dmlc_tpu_torch.tracker.rendezvous import submit_with_tracker

LOCAL_HOSTS = ("localhost", "127.0.0.1", "::1")


def discover_hosts(args) -> List[Tuple[str, int]]:
    """[(host, ssh_port)], one entry per card of the job."""
    if getattr(args, "gpu_hosts", None):
        return [(h.strip(), 22) for h in args.gpu_hosts.split(",")
                if h.strip()]
    if getattr(args, "host_file", None):
        return parse_hostfile(args.host_file)
    return [("localhost", 22)]


def coordination_env(hosts: List[Tuple[str, int]], proc_id: int,
                     port: int) -> Dict[str, str]:
    """The ``torch.distributed`` bootstrap triple for one process."""
    coord_host = hosts[0][0]
    if coord_host in LOCAL_HOSTS:
        coord_host = "127.0.0.1"
    return {
        "DMLC_TPU_COORDINATOR": f"{coord_host}:{port}",
        "DMLC_TPU_NUM_PROC": str(len(hosts)),
        "DMLC_TPU_PROC_ID": str(proc_id),
    }


def visible_devices(hosts: List[Tuple[str, int]],
                    gpus_per_host: int) -> List[str]:
    """``CUDA_VISIBLE_DEVICES`` of each entry: a host's k-th entry sees
    card k mod ``gpus_per_host`` (local aliases count as one host)."""
    seen: Dict[str, int] = {}
    out = []
    for host, _port in hosts:
        key = "localhost" if host in LOCAL_HOSTS else host
        k = seen.get(key, 0)
        seen[key] = k + 1
        out.append(str(k % max(1, gpus_per_host)))
    return out


def plan(args, nworker: int, nserver: int, envs: Dict[str, object]):
    """[(host, ssh_port, task_id, env, argv_or_none)]; argv None means a
    local process."""
    if nserver != 0:
        raise ValueError(
            "--cluster=gpu does not run parameter servers: state is "
            "sharded over the ranks' process group (use --num-servers=0)")
    hosts = discover_hosts(args)
    if nworker != len(hosts):
        # one process per card is the contract; a mismatch is an error the
        # user should see early, not a silent reshard
        raise ValueError(
            f"--cluster=gpu launches one worker per card entry: "
            f"--num-workers={nworker} but {len(hosts)} entries "
            f"({[h for h, _ in hosts]})")
    cards = visible_devices(hosts, args.gpus_per_host)
    out = []
    for i, (host, port) in enumerate(hosts):
        env = task_env(envs, i, "worker", "gpu", extra=args.env_map)
        env.update(coordination_env(hosts, i, args.gpu_coordinator_port))
        env["CUDA_VISIBLE_DEVICES"] = cards[i]
        if host in LOCAL_HOSTS:
            out.append((host, port, i, env, None))
        else:
            argv = ssh_argv(host, port, env, " ".join(args.command))
            out.append((host, port, i, env, argv))
    return out


def ssh_argv(host: str, port: int, env: Dict[str, str],
             cmd: str) -> List[str]:
    remote = f"{export_prefix(env)} cd {shlex.quote(os.getcwd())}; {cmd}"
    return ["ssh", "-o", "StrictHostKeyChecking=no", "-p", str(port), host,
            remote]


def submit(args) -> None:
    attempts_per_task = max(1, args.max_attempts or 1)
    cmd = " ".join(args.command)
    threads: List[threading.Thread] = []

    def run_task(host: str, port: int, env: Dict[str, str],
                 local: bool) -> None:
        remaining = attempts_per_task
        while remaining > 0:
            env = dict(env)
            env["DMLC_NUM_ATTEMPT"] = str(attempts_per_task - remaining)
            if local:
                full = os.environ.copy()
                full.update(env)
                code = subprocess.Popen(cmd, env=full, shell=True).wait()
            else:
                # rebuilt each attempt: the remote sees the attempt count
                code = subprocess.Popen(ssh_argv(host, port, env,
                                                 cmd)).wait()
            if code == 0:
                return
            remaining -= 1
            if remaining > 0:
                print(f"gpu task exited {code}; restarting "
                      f"({remaining} attempts left)", flush=True)

    def fun_submit(nworker: int, nserver: int,
                   envs: Dict[str, object]) -> None:
        for host, port, _tid, env, argv in plan(args, nworker, nserver,
                                                envs):
            t = threading.Thread(target=run_task,
                                 args=(host, port, env, argv is None),
                                 daemon=True)
            t.start()
            threads.append(t)

    submit_with_tracker(
        args.num_workers, args.num_servers, fun_submit,
        host_ip=args.host_ip or "auto",
        # the task threads own the processes: once none is left while the
        # tracker still waits for rendezvous, the job cannot finish
        tasks_alive=lambda: any(t.is_alive() for t in threads))
    for t in threads:
        t.join()

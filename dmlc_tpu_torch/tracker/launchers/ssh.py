"""SSH launcher, the port of ``dmlc_tpu/tracker/launchers/ssh.py``
(tracker/dmlc_tracker/ssh.py).

Round-robins tasks over a hostfile of ``ip[:port]`` lines (ssh.py:38-53),
optionally rsyncs the working directory to every host first (sync_dir,
ssh.py:13-21), and launches each task as
``ssh -p port host 'export ENV…; cd dir; cmd'`` (ssh.py:72-79).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import threading
from typing import Dict, List, Tuple

from dmlc_tpu_torch.tracker.launchers.common import export_prefix, task_env
from dmlc_tpu_torch.tracker.rendezvous import submit_with_tracker


def parse_hostfile(path: str) -> List[Tuple[str, int]]:
    """Hostfile lines 'ip[:port]' → [(host, ssh_port)] (ssh.py:38-53)."""
    hosts: List[Tuple[str, int]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if ":" in line:
                host, port = line.rsplit(":", 1)
                hosts.append((host, int(port)))
            else:
                hosts.append((line, 22))
    if not hosts:
        raise ValueError(f"hostfile {path} has no hosts")
    return hosts


def sync_dir(local_dir: str, host: str, port: int, dst_dir: str) -> List[str]:
    """rsync command shipping local_dir to host:dst_dir (ssh.py:13-21)."""
    return [
        "rsync", "-az", "--rsh", f"ssh -o StrictHostKeyChecking=no -p {port}",
        local_dir + "/", f"{host}:{dst_dir}",
    ]


def plan_ssh_command(
    host: str,
    port: int,
    env: Dict[str, str],
    command: str,
    workdir: str,
) -> List[str]:
    """The ssh invocation for one task (ssh.py:72-79)."""
    remote = f"{export_prefix(env)} cd {shlex.quote(workdir)}; {command}"
    return [
        "ssh", "-o", "StrictHostKeyChecking=no", "-p", str(port), host, remote,
    ]


def plan(args, nworker: int, nserver: int, envs: Dict[str, object]):
    """Pure command plan: [(role, task_id, argv)] for tests and execution."""
    hosts = parse_hostfile(args.host_file)
    workdir = (
        args.sync_dst_dir if args.sync_dst_dir else os.getcwd()
    )
    cmd = " ".join(args.command)
    out = []
    for i in range(nworker + nserver):
        role = "worker" if i < nworker else "server"
        tid = i if i < nworker else i - nworker
        host, port = hosts[i % len(hosts)]
        env = task_env(envs, tid, role, "ssh", extra=args.env_map)
        out.append((role, tid, plan_ssh_command(host, port, env, cmd, workdir)))
    return out


def submit(args) -> None:
    if not args.host_file:
        raise ValueError("ssh cluster needs --host-file")
    if args.sync_dst_dir:
        for host, port in parse_hostfile(args.host_file):
            subprocess.check_call(sync_dir(os.getcwd(), host, port,
                                           args.sync_dst_dir))
    threads: List[threading.Thread] = []

    def fun_submit(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        for role, tid, argv in plan(args, nworker, nserver, envs):
            t = threading.Thread(
                target=lambda a=argv: subprocess.Popen(a).wait(), daemon=True
            )
            t.start()
            threads.append(t)

    submit_with_tracker(
        args.num_workers, args.num_servers, fun_submit,
        host_ip=args.host_ip or "auto",
        # every ssh session exiting while rendezvous is incomplete means the
        # job can never start — abort instead of hanging (rendezvous.join)
        tasks_alive=lambda: any(t.is_alive() for t in threads),
    )
    for t in threads:
        t.join()

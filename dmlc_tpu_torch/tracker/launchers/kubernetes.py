"""Kubernetes launcher, the port of
``dmlc_tpu/tracker/launchers/kubernetes.py``
(tracker/dmlc_tracker/kubernetes.py).

Builds Job manifests for workers/servers (+ a scheduler Service when
num_servers > 0, sched port 9091 — kubernetes.py:29) and applies them with
the kubernetes Python client when available, else ``kubectl apply -f -``.
The manifest builders are pure for testability.
"""

from __future__ import annotations

import json
import subprocess
from typing import Dict, List

from dmlc_tpu_torch.tracker.launchers.common import task_env
from dmlc_tpu_torch.tracker.rendezvous import submit_with_tracker

SCHED_PORT = 9091


def plan_job_manifest(
    args,
    role: str,
    count: int,
    envs: Dict[str, object],
    image: str,
) -> Dict:
    """A batch/v1 Job with `completions=count` indexed pods for one role."""
    env = task_env(envs, 0, role, "kubernetes", extra=args.env_map)
    env.pop("DMLC_TASK_ID", None)
    env_list = [{"name": k, "value": str(v)} for k, v in sorted(env.items())]
    # JOB_COMPLETION_INDEX (indexed Jobs) becomes DMLC_TASK_ID in-container
    env_list.append({
        "name": "DMLC_TASK_ID",
        "valueFrom": {"fieldRef": {
            "fieldPath": "metadata.annotations['batch.kubernetes.io/job-completion-index']"
        }},
    })
    name = f"{args.jobname or 'dmlc-job'}-{role}"
    resources = {
        "requests": {
            "cpu": str(args.worker_cores if role == "worker" else args.server_cores),
            "memory": f"{args.worker_memory_mb if role == 'worker' else args.server_memory_mb}Mi",
        }
    }
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "namespace": args.kube_namespace},
        "spec": {
            "completions": count,
            "parallelism": count,
            "completionMode": "Indexed",
            "backoffLimit": (args.max_attempts or 3) * count,
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": role,
                        "image": image,
                        "command": ["/bin/sh", "-c", " ".join(args.command)],
                        "env": env_list,
                        "resources": resources,
                    }],
                },
            },
        },
    }


def plan_scheduler_service(args) -> Dict:
    """Service exposing the PS scheduler port (kubernetes.py:29)."""
    name = f"{args.jobname or 'dmlc-job'}-sched"
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": args.kube_namespace},
        "spec": {
            "selector": {"app": f"{args.jobname or 'dmlc-job'}-server"},
            "ports": [{"port": SCHED_PORT, "targetPort": SCHED_PORT}],
        },
    }


def plan(args, nworker: int, nserver: int, envs: Dict[str, object]) -> List[Dict]:
    manifests = []
    if nserver > 0:
        manifests.append(plan_scheduler_service(args))
        manifests.append(
            plan_job_manifest(args, "server", nserver, envs,
                              args.kube_server_image)
        )
    if nworker > 0:
        manifests.append(
            plan_job_manifest(args, "worker", nworker, envs,
                              args.kube_worker_image)
        )
    return manifests


def submit(args) -> None:
    def fun_submit(nworker: int, nserver: int, envs: Dict[str, object]) -> None:
        manifests = plan(args, nworker, nserver, envs)
        payload = "\n---\n".join(json.dumps(m) for m in manifests)
        subprocess.run(
            ["kubectl", "apply", "-f", "-"],
            input=payload.encode(), check=True,
        )

    submit_with_tracker(
        args.num_workers, args.num_servers, fun_submit,
        host_ip=args.host_ip or "auto",
    )

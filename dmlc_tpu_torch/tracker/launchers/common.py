"""Env assembly for launched tasks (the port of
``dmlc_tpu/tracker/launchers/common.py``): every task gets the tracker's
env, DMLC_TASK_ID / DMLC_ROLE / DMLC_JOB_CLUSTER / DMLC_NUM_ATTEMPT
(local.py:12-44, ssh.py:55-79) and the submitter's values of
``PASS_ENV_KEYS`` (ssh.py:26-31); ``export_prefix`` is the shell prefix
that carries an env to a remote task (ssh.py:72-79)."""

from __future__ import annotations

import os
import shlex
from typing import Dict, Optional

#: forwarded from the submitter's environment when set (ssh.py:26-31); the
#: JAX package's list without its JAX and XLA settings
PASS_ENV_KEYS = (
    "OMP_NUM_THREADS",
    "KMP_AFFINITY",
    "LD_LIBRARY_PATH",
    "PYTHONPATH",
    "AWS_ACCESS_KEY_ID",
    "AWS_SECRET_ACCESS_KEY",
    "GOOGLE_APPLICATION_CREDENTIALS",
    "DMLC_INTERFACE",
)


def task_env(base_envs: Dict[str, object], task_id: int, role: str,
             cluster: str, extra: Optional[Dict[str, str]] = None,
             attempt: int = 0) -> Dict[str, str]:
    """The env of one task (local.py:12-30): ``base_envs`` as strings, the
    task's id, role, cluster and attempt, the set ``PASS_ENV_KEYS`` the
    base does not name, then ``extra`` over all of it."""
    env = {k: str(v) for k, v in base_envs.items()}
    env["DMLC_TASK_ID"] = str(task_id)
    env["DMLC_ROLE"] = role
    env["DMLC_JOB_CLUSTER"] = cluster
    env["DMLC_NUM_ATTEMPT"] = str(attempt)
    for key in PASS_ENV_KEYS:
        if key in os.environ and key not in env:
            env[key] = os.environ[key]
    if extra:
        env.update(extra)
    return env


def export_prefix(env: Dict[str, str]) -> str:
    """``export k=v; ...`` shell prefix for remote execution
    (ssh.py:72-79), in key order."""
    parts = [f"export {k}={shlex.quote(str(v))};"
             for k, v in sorted(env.items())]
    return " ".join(parts)

"""YARN retry/blacklist controller (the port of
``dmlc_tpu/tracker/launchers/yarn_controller.py``) — the Java ApplicationMaster's failure
policy, in-repo (ApplicationMaster.java:76 maxNumAttempt, :212-213
DMLC_MAX_ATTEMPT, :332-354 onContainersCompleted: attempt counter + node
blacklist + re-queue + abort past the budget).

Two layers, both usable without the AM jar:

- ``RetryController``: the pure policy. Task records carry attempt counts;
  a failure blacklists the node it ran on and re-queues the task; a task
  exceeding ``max_attempt`` aborts the job. Cluster-agnostic — the local
  and gpu launchers could drive it too.
- ``drive_app``: an application-level driver that polls the YARN
  ResourceManager REST API (``/ws/v1/cluster/apps/{id}``) the way the AM
  polls the RM callbacks: submit → watch state → on failure, blacklist
  the failing attempt's nodes and resubmit (fresh attempt), up to the
  budget. This is how the behavior exists here even when the cluster only
  accepts plain app submissions.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from dmlc_tpu_torch.utils.logging import DMLCError, log_info


def default_max_attempt() -> int:
    """DMLC_MAX_ATTEMPT, default 3 (ApplicationMaster.java:76,212-213)."""
    return int(os.environ.get("DMLC_MAX_ATTEMPT", 3))


@dataclass
class TaskRecord:
    task_id: int
    role: str = "worker"
    attempts: int = 0
    node: Optional[str] = None
    done: bool = False


@dataclass
class RetryController:
    """Pure AM failure policy: blacklist + bounded per-task retries."""

    num_tasks: int
    max_attempt: int = field(default_factory=default_max_attempt)
    blacklist: Set[str] = field(default_factory=set)
    aborted: Optional[str] = None  # abort reason, None while healthy

    def __post_init__(self):
        self.records: Dict[int, TaskRecord] = {
            i: TaskRecord(i) for i in range(self.num_tasks)
        }
        self._pending: List[int] = list(range(self.num_tasks))

    # ---- scheduling side ----------------------------------------------

    def pending(self) -> List[int]:
        """Task ids awaiting (re)launch, in order."""
        return list(self._pending)

    def allowed_node(self, node: str) -> bool:
        return node not in self.blacklist

    def assigned(self, task_id: int, node: str) -> None:
        """A task was placed on ``node`` (container allocated)."""
        if task_id in self._pending:
            self._pending.remove(task_id)
        self.records[task_id].node = node

    # ---- completion side ----------------------------------------------

    def completed(self, task_id: int, exit_code: int) -> None:
        """Container finished. Success retires the task; failure counts the
        attempt, blacklists the node, re-queues — or aborts past budget
        (onContainersCompleted, ApplicationMaster.java:332-354)."""
        rec = self.records[task_id]
        if exit_code == 0:
            rec.done = True
            return
        rec.attempts += 1
        if rec.node is not None:
            self.blacklist.add(rec.node)
            log_info(
                "yarn-controller: task %d failed on %s (attempt %d); "
                "node blacklisted", task_id, rec.node, rec.attempts,
            )
        rec.node = None
        if rec.attempts >= self.max_attempt:
            self.aborted = (
                f"task {task_id} failed {rec.attempts} times "
                f"(max_attempt={self.max_attempt})"
            )
            return
        self._pending.append(rec.task_id)

    @property
    def finished(self) -> bool:
        return all(r.done for r in self.records.values())

    def check_healthy(self) -> None:
        if self.aborted:
            raise DMLCError(f"[DMLC] job aborted: {self.aborted}")


# ---------------------------------------------------------------------------
# Application-level REST driver
# ---------------------------------------------------------------------------


def _rest_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def app_state(rm_url: str, app_id: str) -> dict:
    """{state, finalStatus, diagnostics} for one application."""
    doc = _rest_json(f"{rm_url.rstrip('/')}/ws/v1/cluster/apps/{app_id}")
    return doc.get("app", {})


def app_attempt_nodes(rm_url: str, app_id: str) -> List[str]:
    """Hosts of the application's attempts (the nodes to blacklist when the
    app failed there)."""
    doc = _rest_json(
        f"{rm_url.rstrip('/')}/ws/v1/cluster/apps/{app_id}/appattempts"
    )
    attempts = (doc.get("appAttempts") or {}).get("appAttempt") or []
    return [a["nodeHttpAddress"] for a in attempts if a.get("nodeHttpAddress")]


def drive_app(
    rm_url: str,
    submit_fn: Callable[[Set[str]], str],
    max_attempt: Optional[int] = None,
    poll_interval_s: float = 5.0,
    timeout_s: float = 24 * 3600,
) -> str:
    """Submit and babysit a YARN application with AM-style retries.

    ``submit_fn(blacklist) -> app_id`` performs one submission, honoring
    the blacklisted hosts (e.g. via the node-label/placement args of the
    submission command). The driver polls the RM REST API until the app
    finishes; a FAILED/KILLED attempt adds its nodes to the blacklist and
    resubmits, up to ``max_attempt`` (DMLC_MAX_ATTEMPT). Returns the
    succeeding app id, or raises DMLCError with the final diagnostics.
    """
    budget = max_attempt if max_attempt is not None else default_max_attempt()
    blacklist: Set[str] = set()
    deadline = time.monotonic() + timeout_s
    last_diag = ""
    for attempt in range(budget):
        app_id = submit_fn(set(blacklist))
        log_info("yarn-controller: submitted %s (attempt %d/%d)",
                 app_id, attempt + 1, budget)
        while True:
            if time.monotonic() > deadline:
                raise DMLCError(
                    f"[DMLC] yarn app {app_id} timed out after {timeout_s}s"
                )
            info = app_state(rm_url, app_id)
            state = info.get("state")
            if state in ("FINISHED", "FAILED", "KILLED"):
                break
            time.sleep(poll_interval_s)
        final = info.get("finalStatus")
        if state == "FINISHED" and final == "SUCCEEDED":
            return app_id
        last_diag = info.get("diagnostics", "")
        try:
            failed_nodes = app_attempt_nodes(rm_url, app_id)
        except Exception:  # attempts endpoint is best-effort
            failed_nodes = []
        for node in failed_nodes:
            blacklist.add(node)
        log_info(
            "yarn-controller: app %s %s/%s; blacklisting %s",
            app_id, state, final, failed_nodes,
        )
    raise DMLCError(
        f"[DMLC] yarn job failed {budget} times "
        f"(max_attempt={budget}); last diagnostics: {last_diag}"
    )

"""In-container bootstrap shim, the port of ``dmlc_tpu/tracker/shim.py``
(tracker/dmlc_tracker/launcher.py).

Runs *inside* a scheduled container/array task before the user command:
unpacks shipped archives (DMLC_JOB_ARCHIVES, launcher.py:60-70), derives the
task's role/id from the scheduler's task index when the launcher could not
set them directly (SGE role calc, launcher.py:41-47), extends
LD_LIBRARY_PATH/CLASSPATH for HDFS when present (launcher.py:20-39), then
execs the user command (launcher.py:76).

Usage: ``python -m dmlc_tpu_torch.tracker.shim user-cmd args…``
"""

from __future__ import annotations

import os
import subprocess
import sys
import zipfile


def unpack_archives() -> None:
    archives = os.environ.get("DMLC_JOB_ARCHIVES", "")
    for item in archives.split(","):
        item = item.strip()
        if not item:
            continue
        base = os.path.basename(item)
        name = base.rsplit(".", 1)[0]
        if os.path.exists(base) and not os.path.exists(name):
            with zipfile.ZipFile(base) as zf:
                zf.extractall(name)


def derive_role_from_scheduler_env() -> None:
    """SGE/Slurm array tasks: role+task-id from the array index when the
    launcher couldn't export them per-task (launcher.py:41-47)."""
    if "DMLC_ROLE" in os.environ and "DMLC_TASK_ID" in os.environ:
        return
    raw = os.environ.get("SGE_TASK_ID") or os.environ.get("SLURM_PROCID")
    if raw is None:
        return
    tid = int(raw)
    if os.environ.get("SGE_TASK_ID"):
        tid -= 1  # SGE is 1-based
    nworker = int(os.environ.get("DMLC_NUM_WORKER", 1))
    if tid < nworker:
        os.environ["DMLC_ROLE"] = "worker"
        os.environ["DMLC_TASK_ID"] = str(tid)
    else:
        os.environ["DMLC_ROLE"] = "server"
        os.environ["DMLC_TASK_ID"] = str(tid - nworker)


def extend_hadoop_env() -> None:
    hadoop_home = os.environ.get("HADOOP_HDFS_HOME") or os.environ.get(
        "HADOOP_HOME"
    )
    if not hadoop_home:
        return
    lib = os.path.join(hadoop_home, "lib", "native")
    if os.path.isdir(lib):
        prev = os.environ.get("LD_LIBRARY_PATH", "")
        os.environ["LD_LIBRARY_PATH"] = f"{lib}:{prev}" if prev else lib


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m dmlc_tpu_torch.tracker.shim CMD [ARGS…]",
              file=sys.stderr)
        return 2
    unpack_archives()
    derive_role_from_scheduler_env()
    extend_hadoop_env()
    # single token ⇒ a pre-built shell command line (how launchers invoke the
    # shim); multiple tokens ⇒ a faithful argv, re-quoted per token
    import shlex

    cmd = argv[0] if len(argv) == 1 else " ".join(shlex.quote(t) for t in argv)
    return subprocess.call(cmd, shell=True)


if __name__ == "__main__":
    raise SystemExit(main())

"""Per-cluster launchers for ``python -m dmlc_tpu_torch.tracker.submit``
(tracker/dmlc_tracker/{local,ssh,mpi,sge,slurm,yarn,mesos,kubernetes}.py),
the port of ``dmlc_tpu/tracker/launchers``, with ``gpu`` in place of the
JAX package's ``tpu``: one process per card with the ``torch.distributed``
coordination env (``launchers/gpu.py``).

Each module has ``submit(args)``; every launcher that shells out builds
its commands through pure ``plan*`` functions that tests can read without
a cluster.
"""

from __future__ import annotations

from importlib import import_module

from dmlc_tpu_torch.tracker.opts import CLUSTERS

_LAUNCHERS = {name: f"dmlc_tpu_torch.tracker.launchers.{name}"
              for name in CLUSTERS}


def get_launcher(cluster: str):
    """The launcher module of a cluster name (submit.py:43-56)."""
    if cluster not in _LAUNCHERS:
        raise ValueError(f"unknown cluster {cluster!r}; choose from "
                         f"{sorted(_LAUNCHERS)}")
    return import_module(_LAUNCHERS[cluster])

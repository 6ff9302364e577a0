"""Per-cluster launchers for ``python -m dmlc_tpu_torch.tracker.submit``
(tracker/dmlc_tracker/{local,ssh,...}.py). Each module has
``submit(args)``. Only ``local`` is ported; the other clusters of the JAX
package's ``dmlc-submit`` are not, and naming one raises."""

from __future__ import annotations

from importlib import import_module

from dmlc_tpu_torch.tracker.opts import CLUSTERS

_LAUNCHERS = {"local": "dmlc_tpu_torch.tracker.launchers.local"}


def get_launcher(cluster: str):
    """The launcher module of a cluster name (submit.py:43-56)."""
    if cluster not in _LAUNCHERS:
        if cluster in CLUSTERS:
            raise ValueError(f"cluster {cluster!r} is not ported to "
                             f"dmlc_tpu_torch yet; ported: "
                             f"{sorted(_LAUNCHERS)}")
        raise ValueError(f"unknown cluster {cluster!r}; choose from "
                         f"{list(CLUSTERS)}")
    return import_module(_LAUNCHERS[cluster])

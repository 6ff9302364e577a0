"""Input resharding after a membership change: ``reshard_split``, the one
function of ``dmlc_tpu/data/service.py`` the port has. The rest of the
data service (the dispatcher, block services and remote parsers) waits
for the host modules of the roadmap's queue 1 item 13."""

from __future__ import annotations

import threading
from typing import Optional

_lock = threading.Lock()
_reshards = 0


def reshard_split(split, rank: Optional[int] = None,
                  world: Optional[int] = None):
    """Recompute an ``InputSplit``'s partition for a new membership
    generation: after ``collective.reenter_elastic`` gives this worker a
    new rank and world, it calls this at its next epoch boundary so the
    parts tile the new world exactly once. ``reset_partition`` depends
    only on ``(rank, world)``: the same boundaries a static launch at that
    world reads, which keeps a shrink-then-regrow run bit-identical to a
    static one. ``rank``/``world`` default to the live collective's.
    Returns the split; :func:`reshard_count` counts the calls."""
    global _reshards
    if rank is None or world is None:
        from dmlc_tpu_torch import collective

        rank = collective.rank() if rank is None else rank
        world = collective.world_size() if world is None else world
    split.reset_partition(rank, world)
    with _lock:
        _reshards += 1
    return split


def reshard_count() -> int:
    """Partitions recomputed by :func:`reshard_split` in this process."""
    with _lock:
        return _reshards

"""epoch_restart_ms.fm: milliseconds an FM epoch of the window takes to
restart: the feed's ``restart_ns`` (``DeviceFeed.stats()``, from entering
``before_first()`` to handing out the epoch's first batch), the mean over
the window's epochs that have one."""

from __future__ import annotations


def read(r: dict):
    restarts = [s.get("restart_ns") for s in r.get("epoch_stats") or []]
    restarts = [ns for ns in restarts if ns]
    if not restarts:
        return None
    return sum(restarts) / len(restarts) / 1e6

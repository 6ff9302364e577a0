"""epoch_restart_ms.fm.text: ``epoch_restart_ms.fm`` in the text cell,
whose rate is ``rows_per_s.text`` (one metric a moved end-to-end metric):
the feed's mean ``restart_ns`` over the window's epochs that have one."""

from __future__ import annotations


def read(r: dict):
    restarts = [s.get("restart_ns") for s in r.get("epoch_stats") or []]
    restarts = [ns for ns in restarts if ns]
    if not restarts:
        return None
    return sum(restarts) / len(restarts) / 1e6

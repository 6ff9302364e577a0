"""ingest_wait_share.fm: the share of the FM window (%) in which the
learner waited for its next batch: the feed's ``host_wait_ns``
(``DeviceFeed.stats()``, the consumer's wait on the producer thread),
summed over the window's epochs, over the window's time."""

from __future__ import annotations


def read(r: dict):
    stats = r.get("epoch_stats") or []
    waits = [s.get("host_wait_ns") for s in stats]
    if not waits or any(w is None for w in waits):
        return None
    return 100.0 * sum(waits) / (r["window_s"] * 1e9)

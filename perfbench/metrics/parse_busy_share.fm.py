"""parse_busy_share.fm: the share (%) of the parse workers' time spent
parsing in the FM window: the native pipeline's ``parse_ns`` (its
``stats()``, through ``DeviceFeed.stats()["pipeline"]``), summed over the
window's epochs, over the window's time times the parse threads."""

from __future__ import annotations


def read(r: dict):
    stats = r.get("epoch_stats") or []
    parse = [(s.get("pipeline") or {}).get("parse_ns") for s in stats]
    if not parse or any(p is None for p in parse):
        return None
    return 100.0 * sum(parse) / (r["window_s"] * 1e9 * r["parse_threads"])

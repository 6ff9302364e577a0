"""Hedged requests: one backup attempt after a latency threshold, the
port of ``dmlc_tpu/resilience/hedge.py``.

A straggling object-store GET is a failure retries never see: nothing
errored, the reply is just slow, and an ordered readahead window stalls
behind it. The fix of "The Tail at Scale" is to hedge: after
``threshold_s`` without a reply, issue one duplicate request and take
whichever finishes first.

- ``threshold_s <= 0`` (the ``DMLC_TPU_HEDGE_S`` default) calls ``fn()``
  inline: no thread, no cost.
- ``fn`` must be safe to run twice (an idempotent range GET into a buffer
  of its own). A caller that writes into a buffer it was handed (the
  ``into=`` reads) must not hedge: two winners racing one buffer corrupt
  it, which is why only the allocating fetch of ``io/readahead.py`` opts
  in.
- The loser is abandoned, not cancelled (urllib has no cancel): it ends on
  its daemon thread and its result is dropped.

Hedges and hedge wins are counted as ``dmlc_readahead_hedges_total`` and
``dmlc_readahead_hedge_wins_total``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, TypeVar

T = TypeVar("T")


def _metrics(site: str):
    from dmlc_tpu_torch import obs  # deferred: resilience is a low layer

    reg = obs.registry()
    return (
        reg.counter("dmlc_readahead_hedges_total",
                    "backup requests issued after the hedge threshold",
                    site=site),
        reg.counter("dmlc_readahead_hedge_wins_total",
                    "hedged backups that beat the primary request",
                    site=site),
    )


def hedged_call(fn: Callable[[], T], threshold_s: float,
                site: str = "readahead.fetch") -> T:
    """Run ``fn()``; if it takes longer than ``threshold_s``, launch one
    duplicate and return the first result (the first error only if both
    fail)."""
    if threshold_s <= 0:
        return fn()

    results: "queue.Queue[tuple]" = queue.Queue()

    def run(is_backup: bool) -> None:
        try:
            results.put((is_backup, ("ok", fn())))
        except BaseException as err:  # noqa: BLE001 (relayed to the caller)
            results.put((is_backup, ("err", err)))

    threading.Thread(target=run, args=(False,), daemon=True,
                     name=f"hedge-primary-{site}").start()
    try:
        first_is_backup, outcome = results.get(timeout=threshold_s)
    except queue.Empty:
        m_hedges, m_wins = _metrics(site)
        m_hedges.inc()
        threading.Thread(target=run, args=(True,), daemon=True,
                         name=f"hedge-backup-{site}").start()
        first_is_backup, outcome = results.get()
        if outcome[0] == "err":
            # the first to finish failed; the other may still succeed
            first_is_backup, outcome = results.get()
        if first_is_backup and outcome[0] == "ok":
            m_wins.inc()
    if outcome[0] == "err":
        raise outcome[1]
    return outcome[1]

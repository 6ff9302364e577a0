"""Bounded ordered thread-pool map, the concurrency core of
``dmlc_tpu/io/readahead.py`` (``OrderedWindow``, ``fetch_ordered``).

Work fans out over ``workers`` threads and comes back strictly in
submission order behind a window of at most ``window`` items in flight or
buffered, so memory stays at ~window × item size. The pipelined chunk
parser (``data/pipeline.PipelinedParser``) is built on it, and it counts
``dmlc_readahead_{submitted,completed,cancelled}_total``. The JAX
package's remote range reader (``RemotePartitionReader``) waits for the
remote filesystems.
"""

from __future__ import annotations

import concurrent.futures
import os
from collections import deque
from typing import Callable, Iterable, Iterator

from dmlc_tpu_torch.utils.logging import check

#: default worker threads: extra threads only add contention past the
#: cores that run them (the JAX package's measured default)
DEFAULT_CONNECTIONS = max(1, min(4, os.cpu_count() or 1))


class OrderedWindow:
    """``submit`` fans work onto ``workers`` threads; ``pop`` blocks on and
    returns the OLDEST submission's result, so delivery order is exactly
    submission order whichever worker finishes first. At most ``window``
    (default 2×workers) items are in flight or buffered: the caller tops
    the window up while ``free_slots`` > 0 (backpressure). A failed call
    raises from ``pop`` at its in-order position; ``close`` cancels
    everything still pending."""

    def __init__(self, fn: Callable, workers: int = DEFAULT_CONNECTIONS,
                 window: int = 0, name: str = "readahead"):
        self._fn = fn
        self.workers = max(1, workers)
        if window <= 0:
            window = 2 * self.workers
        self.window = max(window, self.workers)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix=name)
        self._pending: deque = deque()
        self._closed = False
        # process-wide stage counters (all windows share them: windows are
        # transient, and totals are what skew reports want)
        from dmlc_tpu_torch import obs  # deferred: io is a low layer

        reg = obs.registry()
        self._m_submitted = reg.counter(
            "dmlc_readahead_submitted_total",
            "items submitted to ordered windows")
        self._m_completed = reg.counter(
            "dmlc_readahead_completed_total",
            "items delivered in order from ordered windows")
        self._m_cancelled = reg.counter(
            "dmlc_readahead_cancelled_total",
            "pending items cancelled at window close")

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def free_slots(self) -> int:
        return self.window - len(self._pending)

    def submit(self, item) -> None:
        check(not self._closed, "OrderedWindow is closed")
        self._m_submitted.inc()
        self._pending.append(self._pool.submit(self._fn, item))

    def pop(self):
        """Oldest submission's result (blocks). Errors re-raise here, in
        order, and poison the window: everything behind the failure is
        cancelled, so a consumer that catches and retries cannot observe
        out-of-order survivors."""
        fut = self._pending.popleft()
        try:
            out = fut.result()
        except BaseException:
            self.close()
            raise
        self._m_completed.inc()
        return out

    def close(self) -> None:
        """Cancel pending work and release the pool (idempotent). Work
        already running finishes on its thread; nothing waits for it."""
        if self._closed:
            return
        self._closed = True
        if self._pending:
            self._m_cancelled.inc(len(self._pending))
        for fut in self._pending:
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)


def fetch_ordered(fetch: Callable, items: Iterable,
                  workers: int = DEFAULT_CONNECTIONS,
                  window: int = 0) -> Iterator:
    """Map ``fetch`` over ``items`` on a thread pool, yielding results in
    submission order. At most ``window`` (default 2×workers) calls are in
    flight or buffered; a failed fetch propagates at its in-order position
    and cancels the rest."""
    win = OrderedWindow(fetch, workers=workers, window=window)
    try:
        for item in items:
            win.submit(item)
            if win.free_slots <= 0:
                yield win.pop()
        while len(win):
            yield win.pop()
    finally:
        win.close()

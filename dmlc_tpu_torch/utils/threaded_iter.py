"""Bounded producer/consumer prefetch iterator (``dmlc::ThreadedIter``,
include/dmlc/threadediter.h), copied from ``dmlc_tpu/utils/threaded_iter.py``.

A background producer thread fills a bounded queue (default capacity 8)
ahead of the consumer; ``before_first`` restarts the producer for a new
epoch; an exception raised in the producer is re-raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Generic, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")

_END = object()


class _Exc:
    def __init__(self, err: BaseException):
        self.err = err


class ThreadedIter(Generic[T]):
    """Prefetch items of ``make_iter()`` in a background thread.

    ``make_iter`` is called once per epoch (at construction and at each
    ``before_first``) and must return a fresh iterator.
    """

    def __init__(
        self,
        make_iter: Callable[[], Iterable[T]],
        max_capacity: int = 8,
        name: str = "threaded-iter",
    ):
        self._make_iter = make_iter
        self._cap = max_capacity
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._finished = False
        self.before_first()

    # ---- producer ------------------------------------------------------
    def _put(self, q: "queue.Queue", stop: threading.Event, item) -> bool:
        """Put ``item`` unless ``stop`` is set first; True when it went in."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, q: "queue.Queue", stop: threading.Event) -> None:
        try:
            for item in self._make_iter():
                if not self._put(q, stop, item):
                    return
            self._put(q, stop, _END)
        except BaseException as err:  # noqa: BLE001 — re-raised in next()
            self._put(q, stop, _Exc(err))

    def _shutdown_producer(self) -> None:
        if self._thread is not None:
            self._stop.set()
            # drain so a blocked put() notices the stop flag promptly
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join()
            self._thread = None

    # ---- consumer API --------------------------------------------------
    def before_first(self) -> None:
        """Restart the producer for a fresh epoch."""
        self._shutdown_producer()
        self._queue = queue.Queue(self._cap)
        self._stop = threading.Event()
        self._finished = False
        self._thread = threading.Thread(
            target=self._run,
            args=(self._queue, self._stop),
            name=self._name,
            daemon=True,
        )
        self._thread.start()

    def next(self) -> Optional[T]:
        """Next item, or None at end of epoch. Re-raises producer errors."""
        if self._finished:
            return None
        item = self._queue.get()
        if item is _END:
            self._finished = True
            return None
        if isinstance(item, _Exc):
            self._finished = True
            raise item.err
        return item

    def __iter__(self) -> Iterator[T]:
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    def close(self) -> None:
        self._shutdown_producer()

"""Managed thread lifecycle helpers (the port of
``dmlc_tpu/utils/thread_group.py``).

Capability parity with include/dmlc/thread_group.h:

- ``ManualEvent``: manual-reset gate (thread_group.h:31-69) — ``set`` wakes
  every waiter and stays signalled until ``reset``.
- ``ThreadGroup``: named, joinable thread registry (thread_group.h:92-520)
  with auto-remove on exit, group shutdown request, and join-all.
- ``BlockingQueueThread``: a thread pumping items off a blocking queue into
  an item handler (thread_group.h:527-640).
- ``TimerThread``: periodic callback until stopped (thread_group.h:642-795).

They are the host-side lifecycle layer around ingest pipelines and
trackers; the card's concurrency belongs to CUDA streams, not threads.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

from dmlc_tpu_torch.utils.logging import check

__all__ = [
    "ManualEvent",
    "ThreadGroup",
    "GroupThread",
    "BlockingQueueThread",
    "TimerThread",
]


class ManualEvent:
    """Manual-reset event (thread_group.h ManualEvent :31-69)."""

    def __init__(self, signaled: bool = False):
        self._event = threading.Event()
        if signaled:
            self._event.set()

    def set(self) -> None:
        self._event.set()

    def reset(self) -> None:
        self._event.clear()

    def is_set(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class GroupThread:
    """One managed thread (thread_group.h ThreadGroup::Thread :98-420).

    The run function receives this object; long-running loops should poll
    ``stop_requested`` (the CreateThread launch contract) so group shutdown
    can interrupt them.
    """

    def __init__(
        self,
        name: str,
        group: "ThreadGroup",
        target: Callable[..., Any],
        args: Iterable[Any] = (),
        auto_remove: bool = True,
    ):
        self.name = name
        self._group = group
        self._stop_requested = threading.Event()
        self._auto_remove = auto_remove
        run_args = tuple(args)

        def _run():
            try:
                target(self, *run_args)
            finally:
                if self._auto_remove:
                    group._remove(self)

        self._thread = threading.Thread(target=_run, name=name, daemon=True)
        self._thread.start()

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested.is_set()

    def request_shutdown(self) -> None:
        self._stop_requested.set()

    def wait_for_shutdown(self, timeout: Optional[float] = None) -> bool:
        """Block until a shutdown request arrives (worker-side idle wait)."""
        return self._stop_requested.wait(timeout)

    def join(self, timeout: Optional[float] = None) -> bool:
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def is_alive(self) -> bool:
        return self._thread.is_alive()


class ThreadGroup:
    """Named thread registry with group-wide shutdown and join
    (thread_group.h:92-520)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._threads: Dict[str, GroupThread] = {}

    def create(
        self,
        name: str,
        target: Callable[..., Any],
        *args: Any,
        auto_remove: bool = True,
    ) -> GroupThread:
        """Launch a named thread; names are unique within the group."""
        with self._lock:
            check(name not in self._threads, "duplicate thread name %s", name)
            thread = GroupThread(name, self, target, args, auto_remove)
            self._threads[name] = thread
            return thread

    def get(self, name: str) -> Optional[GroupThread]:
        with self._lock:
            return self._threads.get(name)

    def size(self) -> int:
        with self._lock:
            return len(self._threads)

    def _remove(self, thread: GroupThread) -> None:
        with self._lock:
            if self._threads.get(thread.name) is thread:
                del self._threads[thread.name]

    def request_shutdown_all(self) -> None:
        with self._lock:
            threads = list(self._threads.values())
        for t in threads:
            t.request_shutdown()

    def join_all(self, timeout: Optional[float] = None) -> bool:
        """Request shutdown and join every thread; True when all exited."""
        self.request_shutdown_all()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads.values())
        ok = True
        for t in threads:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            ok = t.join(left) and ok
        return ok


class BlockingQueueThread:
    """Thread pumping a blocking queue into an item handler
    (thread_group.h BlockingQueueThread :527-640)."""

    _SENTINEL = object()

    def __init__(
        self,
        name: str,
        handler: Callable[[Any], None],
        group: Optional[ThreadGroup] = None,
        max_size: int = 0,
    ):
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=max_size)
        self._handler = handler
        self._group = group or ThreadGroup()
        self._thread = self._group.create(name, self._pump, auto_remove=True)

    def _pump(self, thread: GroupThread) -> None:
        # Poll with a timeout so a group-wide request_shutdown (which cannot
        # enqueue the sentinel) still terminates the pump; shutdown() keeps
        # drain semantics by queueing the sentinel behind pending items.
        while True:
            try:
                item = self._queue.get(timeout=0.05)
            except queue.Empty:
                if thread.stop_requested:
                    return
                continue
            if item is BlockingQueueThread._SENTINEL:
                return
            self._handler(item)

    def enqueue(self, item: Any) -> None:
        self._queue.put(item)

    def shutdown(self, timeout: Optional[float] = None) -> bool:
        """Drain-then-exit: the sentinel queues behind pending items."""
        self._queue.put(BlockingQueueThread._SENTINEL)
        return self._thread.join(timeout)


class TimerThread:
    """Periodic callback every ``interval`` seconds until stopped
    (thread_group.h TimerThread :642-795)."""

    def __init__(
        self,
        name: str,
        interval: float,
        callback: Callable[[], None],
        group: Optional[ThreadGroup] = None,
    ):
        check(interval > 0, "timer interval must be positive")
        self.interval = interval
        self._callback = callback
        self._group = group or ThreadGroup()
        self._thread = self._group.create(name, self._loop, auto_remove=True)

    def _loop(self, thread: GroupThread) -> None:
        while not thread.wait_for_shutdown(self.interval):
            self._callback()

    def stop(self, timeout: Optional[float] = None) -> bool:
        self._thread.request_shutdown()
        return self._thread.join(timeout)

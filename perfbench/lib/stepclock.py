"""The job's feed wrapper: a CUDA event on the consumer's stream each time
the job comes back for a batch, with no synchronize, and the window's
end.

The event recorded as batch i+1 is handed out completes once everything
enqueued before it has run: step i and the copies the feed queued ahead;
the window's last event, behind the final step, marks that step's end,
and the window's first, before any step, is the zero. Where the host
falls behind, an event is recorded late and completes at once, so the gap
between two events is the time from one step's completion on the stream
to the next, the host's stalls and the epoch boundaries included. The
wrapper stops handing out batches once the window's seconds have passed
(or after ``budget`` batches), which ends the learner's epoch there.
With a ``digest``, it also sums a digest of each window batch on the
device, an epoch at a time, for the job to compare with its rows.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch


class StepClock:
    """Wraps a ``DeviceFeed``: iterate it as the feed (``spec``,
    ``device``, ``before_first`` and ``stats`` pass through), one pass
    a call of the learner's fit. The feed's own epoch iterator is kept
    across passes, so a pass cut short by ``budget`` is continued by the
    next one."""

    def __init__(self, feed, digest=None):
        self.feed = feed
        #: digest(batch, position) -> a device tensor, summed an epoch
        self.digest = digest
        self.spec = feed.spec
        self.device = feed.device
        self._it = None
        self.budget: Optional[int] = None  # batches the next pass hands out
        self.deadline: Optional[float] = None  # perf_counter() to stop at
        self.marks: List = []  # events (host times on the CPU)
        self.rows = 0  # rows handed out since start()
        self._first = False  # the next batch is the window's first
        self.epoch_stats: List[dict] = []  # feed.stats() of each epoch
        self.batches: List[dict] = []  # the first batches, kept
        self.keep = 0  # how many batches to keep
        self.cut = False  # the last pass ended at the deadline
        self.position = 0  # the next batch's index in its epoch
        self.window_positions: List[int] = []  # of each window batch
        self.active = False  # between start() and stop()
        #: (batches, summed digest or None) of each window epoch
        self.epoch_digests: List[tuple] = []
        self._epoch_batches = 0
        self._epoch_digest = None

    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def start(self) -> None:
        """Record the window's first event (the clock's zero)."""
        self.marks = [self._mark()]
        self.rows = 0
        self._first = True
        self.epoch_stats = []
        self.window_positions = []
        self.epoch_digests = []
        self._epoch_batches, self._epoch_digest = 0, None
        self.active = True

    def __iter__(self):
        if self._it is None:
            self._it = iter(self.feed)
        left = self.budget
        self.cut = False
        while left is None or left > 0:
            if self.deadline is not None and \
                    time.perf_counter() >= self.deadline:
                self.cut = True
                return
            try:
                batch = next(self._it)
            except StopIteration:
                self._it = None
                return
            if len(self.batches) < self.keep:
                self.batches.append(batch)
            if self.active:
                if not self._first:
                    self.marks.append(self._mark())
                self._first = False
                self.rows += int(batch["num_rows"])
                self.window_positions.append(self.position)
                self._epoch_batches += 1
                if self.digest is not None:
                    d = self.digest(batch, self.position)
                    self._epoch_digest = d if self._epoch_digest is None \
                        else self._epoch_digest + d
            self.position += 1
            if left is not None:
                left -= 1
            yield batch

    def _end_epoch(self) -> None:
        self.epoch_stats.append(self.feed.stats())
        if self.active:
            self.epoch_digests.append((self._epoch_batches,
                                       self._epoch_digest))
        self._epoch_batches, self._epoch_digest = 0, None

    def close_epoch(self) -> None:
        """Keep the feed's stats (and in the window the digest) of the
        epoch that ends, then rewind."""
        self._end_epoch()
        self._it = None
        self.position = 0
        self.feed.before_first()

    def stop(self) -> None:
        """The window's end: a last event behind the final step."""
        self.marks.append(self._mark())
        self._end_epoch()
        self.active = False

    def step_ms(self) -> List[float]:
        """Each step's milliseconds, from the previous step's completion
        (the window's zero for the first) to its own (synchronizes
        once)."""
        marks = self.marks
        if self.device.type == "cuda":
            marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

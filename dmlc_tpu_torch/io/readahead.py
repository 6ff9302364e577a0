"""Parallel range readahead for remote data, the port of
``dmlc_tpu/io/readahead.py``.

- :class:`OrderedWindow` / :func:`fetch_ordered`: a bounded ordered
  thread-pool map. Work fans out over ``workers`` threads and comes back
  strictly in submission order behind a window of at most ``window``
  items in flight or buffered, so memory stays at ~window × item size.
  The pipelined chunk parser (``data/pipeline.PipelinedParser``) is built
  on it, and it counts ``dmlc_readahead_{submitted,completed,
  cancelled}_total``.
- :class:`RemotePartitionReader`: part k of n of a remote dataset as an
  in-order byte stream, fetched as fixed ``range_bytes`` spans over
  ``connections`` concurrent bounded range requests (the
  multi-connection generalization of the reference's reconnecting
  range-GET stream, src/io/s3_filesys.cc:219-445). Part k covers global
  bytes [adj(k·step), adj((k+1)·step)) of the concatenated files, adj
  moving a boundary to the next record start (input_split_base.cc:30-64,
  line_split.cc:9-26, recordio_split.cc:9-25), so its bytes are those
  the InputSplit of part k reads.

``data/parsers.NativePipelineParser`` feeds the reader into the native
push pipeline through :meth:`RemotePartitionReader.feed_into`, which
pushes the in-order buffers. :class:`PushRejected` tells a refused push
(the pipeline already failed) from a failed fetch.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import inspect
import os
import threading
from collections import deque
from typing import Callable, Iterable, Iterator, List, Sequence, Tuple

from dmlc_tpu_torch.utils.logging import DMLCError, check

#: the reference's 8 MiB chunk buffer
DEFAULT_RANGE_BYTES = 8 << 20

#: default worker threads: extra threads only add contention past the
#: cores that run them (the JAX package's measured default)
DEFAULT_CONNECTIONS = max(1, min(4, os.cpu_count() or 1))


class PushRejected(Exception):
    """The native pipeline refused a push (it already failed or closed):
    kept apart from fetch errors, so that the feeder lets the pipeline's
    own error reach the consumer instead of masking it."""


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


class RemotePartitionReader:
    """The in-order byte stream of part ``part`` of ``nparts`` over remote
    files.

    ``files`` is the [(path URI, size)] list in dataset order; ``fs``
    serves ``read_range``. Iterating yields buffers whose concatenation is
    exactly the part's adjusted byte range, fetched over ``connections``
    parallel bounded range requests (``record_format`` "text" or
    "recordio"; recordio steps stay 4-byte aligned, as the splits' are).
    :meth:`feed_into` pushes the same stream into a native push
    pipeline."""

    def __init__(self, fs, files: Sequence[Tuple[object, int]], part: int,
                 nparts: int, range_bytes: int = DEFAULT_RANGE_BYTES,
                 connections: int = DEFAULT_CONNECTIONS,
                 record_format: str = "text"):
        check(0 <= part < nparts, "bad part %d/%d", part, nparts)
        check(record_format in ("text", "recordio"),
              "unknown record_format %r", record_format)
        self._record_format = record_format
        self._fs = fs
        self._cancel = threading.Event()
        # a duck-typed filesystem may not take the cancelled argument
        try:
            self._supports_cancel = (
                "cancelled" in inspect.signature(fs.read_range).parameters)
        except (TypeError, ValueError):
            self._supports_cancel = False
        self._paths = [f[0] for f in files]
        self._sizes = [int(f[1]) for f in files]
        self._offsets = [0]
        for size in self._sizes:
            self._offsets.append(self._offsets[-1] + size)
        self._range_bytes = max(64 << 10, int(range_bytes))
        self._connections = max(1, int(connections))
        total = self._offsets[-1]
        nstep = (total + nparts - 1) // nparts
        align = 4 if record_format == "recordio" else 1
        nstep = (nstep + align - 1) // align * align
        raw_begin = min(nstep * part, total)
        raw_end = min(nstep * (part + 1), total)
        if raw_begin >= raw_end:
            self.begin = self.end = total
        else:
            self.begin = self._adjust_boundary(raw_begin)
            self.end = self._adjust_boundary(raw_end)

    # ---- the part's boundaries --------------------------------------------
    def _global_read(self, pos: int, n: int) -> bytes:
        """Up to ``n`` bytes at global offset ``pos``, across files."""
        out = bytearray()
        total = self._offsets[-1]
        while n > 0 and pos < total:
            idx = bisect.bisect_right(self._offsets, pos) - 1
            local = pos - self._offsets[idx]
            got = self._fs.read_range(self._paths[idx], local,
                                      min(n, self._sizes[idx] - local))
            if not got:
                break
            out.extend(got)
            pos += len(got)
            n -= len(got)
        return bytes(out)

    def _adjust_boundary(self, pos: int) -> int:
        """adj(x): the first record start at global offset >= x (0 stays
        0). Text probes forward past the next end-of-line run; recordio
        scans aligned words for a head frame."""
        if pos <= 0:
            return 0
        total = self._offsets[-1]
        if pos >= total:
            return total
        if self._record_format == "recordio":
            return self._adjust_boundary_recordio(pos, total)
        seen_eol = False
        while pos < total:
            probe = self._global_read(pos, 4096)
            if not probe:
                return total
            for i, c in enumerate(probe):
                if c in (0x0A, 0x0D):
                    seen_eol = True
                elif seen_eol:
                    return pos + i
            pos += len(probe)
        return total

    def _adjust_boundary_recordio(self, pos: int, total: int) -> int:
        import numpy as np

        from dmlc_tpu_torch.io.recordio import RECORDIO_MAGIC

        base = (pos + 3) & ~3  # heads sit on 4-byte alignment
        carry = b""
        while base + len(carry) < total:
            probe = self._global_read(base + len(carry), 1 << 16)
            if not probe:
                break
            buf = carry + probe
            words = np.frombuffer(buf[:len(buf) & ~3], dtype="<u4")
            if len(words) >= 2:
                hits = np.nonzero(words[:-1] == RECORDIO_MAGIC)[0]
                flags = (words[hits + 1] >> 29) & 7
                good = hits[(flags == 0) | (flags == 1)]
                if good.size:
                    return base + (int(good[0]) << 2)
            # keep the aligned tail not yet scanned (< 8 bytes)
            processed = max(0, (len(buf) - 4) & ~3)
            carry = buf[processed:]
            base += processed
        return total

    # ---- the fetch plan ---------------------------------------------------------
    def ranges(self) -> List[Tuple[int, int, int]]:
        """[(file index, offset in the file, length)] covering [begin,
        end) in ``range_bytes`` spans cut at file boundaries."""
        out: List[Tuple[int, int, int]] = []
        pos = self.begin
        while pos < self.end:
            idx = bisect.bisect_right(self._offsets, pos) - 1
            local = pos - self._offsets[idx]
            length = min(self._range_bytes, self.end - pos,
                         self._sizes[idx] - local)
            out.append((idx, local, length))
            pos += length
        return out

    @property
    def nbytes(self) -> int:
        return self.end - self.begin

    def cancel(self) -> None:
        """Stop the fetches' retries promptly (teardown): pending fetches
        fail at their next retry or cancellation check instead of running
        out their retry budgets."""
        self._cancel.set()

    # ---- the native feed ------------------------------------------------
    def feed_into(self, pipe) -> None:
        """Push the part's bytes, in order, into the native push pipeline
        ``pipe``: the ranges are fetched over the connections as
        iteration fetches them, and each buffer is pushed (``push`` blocks
        while the parse workers are behind, and cuts chunks as the
        pipeline's own reader does). Raises :class:`PushRejected` when the
        pipeline itself failed; a fetch error raises as it is, so that the
        feeder aborts the pipeline."""
        for buf in self:
            try:
                pipe.push(buf)
            except DMLCError as err:
                raise PushRejected(str(err)) from err

    def __iter__(self) -> Iterator[bytes]:
        from dmlc_tpu_torch import obs
        from dmlc_tpu_torch.params.env import get_env
        from dmlc_tpu_torch.resilience import faultpoint, hedged_call

        hedge_s = max(0.0, float(get_env("DMLC_TPU_HEDGE_S", 0.0)))

        def fetch_once(rng: Tuple[int, int, int]) -> bytes:
            idx, local, length = rng
            if self._cancel.is_set():
                raise DMLCError("readahead cancelled")
            faultpoint("readahead.fetch")
            if self._supports_cancel:
                data = self._fs.read_range(self._paths[idx], local, length,
                                           cancelled=self._cancel.is_set)
            else:
                data = self._fs.read_range(self._paths[idx], local, length)
            check(len(data) == length,
                  "short range read on %s at %d: got %d of %d bytes "
                  "(file changed during ingest?)",
                  self._paths[idx].str_full(), local, len(data), length)
            return data

        def fetch(rng: Tuple[int, int, int]):
            # hedging is safe here only: each attempt allocates its own
            # buffer, so a duplicate request races no shared destination
            fid = obs.new_flow()
            with obs.span("readahead_fetch", nbytes=rng[2], flow=fid):
                data = hedged_call(lambda: fetch_once(rng), hedge_s)
                obs.flow_start(fid, "range")
            return fid, data

        def deliver() -> Iterator[bytes]:
            # a flow arrow from the fetch worker's slice to the consumer's
            # pop: which connection served which range
            for fid, data in fetch_ordered(fetch, self.ranges(),
                                           workers=self._connections):
                with obs.span("readahead_deliver", nbytes=len(data),
                              flow=fid):
                    obs.flow_end(fid, "range")
                yield data

        return deliver()

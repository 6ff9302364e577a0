"""Cross-chunk pipelined parsing: N worker threads behind a bounded ordered
window, the port of ``dmlc_tpu/data/pipeline.py``.

The base :class:`~dmlc_tpu_torch.data.parsers.Parser` parallelizes WITHIN
one chunk and is synchronous ACROSS chunks: while the consumer holds block
k, no part of chunk k+1 is being parsed. :class:`PipelinedParser` makes
each chunk one parse task on an :class:`~dmlc_tpu_torch.io.readahead.
OrderedWindow`, which keeps up to ``window`` chunks in flight or parsed
ahead of the consumer and delivers blocks strictly in chunk order. So the
rows and their order are those of serial iteration, the parse of chunks
k+1..k+W overlaps the consumer's work on chunk k, and a full window stops
the chunk reads (backpressure).

Each worker calls the base's ``parse_chunk``: a libsvm chunk is tokenized
by the ``tokenize_boundaries`` kernel on the parser's device, from several
threads at once.

The JAX package's process pool (``DMLC_TPU_PARSE_PROCS``), its audit
chain and its flow tracing are not ported; ``stats()`` keeps the stage
counters as plain numbers.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

from dmlc_tpu_torch.data.parsers import DEFAULT_NTHREAD, Parser
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io.readahead import OrderedWindow
from dmlc_tpu_torch.utils.logging import check


class PipelinedParser:
    """Parse chunks of ``base`` on ``nthread`` worker threads, delivered
    in order.

    ``base`` must be a :class:`Parser` (it supplies ``next_chunk`` and
    ``parse_chunk``); its own intra-chunk pool stays idle, since each chunk
    goes whole to one worker. ``window`` bounds chunks in flight or parsed
    but unconsumed (default 2×nthread). An exception raised by a worker
    surfaces from ``next_block`` at the failed chunk's in-order position
    and poisons the window; ``close`` (and ``before_first``) cancel all
    pending work.
    """

    def __init__(self, base: Parser, nthread: Optional[int] = None,
                 window: int = 0):
        check(isinstance(base, Parser),
              "PipelinedParser requires a Parser base (got %s)",
              type(base).__name__)
        self._base = base
        self._nthread = max(1, DEFAULT_NTHREAD if nthread is None
                            else nthread)
        self._window_arg = window
        # lifetime stage counters (ns): parse time summed over the workers
        # (it can exceed wall time), and the time next_block waited on the
        # window's head
        self._lock = threading.Lock()
        self._chunks = 0
        self._parse_ns = 0
        self._wait_ns = 0
        self._win: Optional[OrderedWindow] = None
        self._eof = False
        self._closed = False
        self._open()

    def _open(self) -> None:
        self._win = OrderedWindow(self._parse_timed, workers=self._nthread,
                                  window=self._window_arg,
                                  name="pipelined-parse")
        self._eof = False

    def _parse_timed(self, chunk: bytes):
        t0 = time.monotonic_ns()
        try:
            return self._base.parse_chunk(chunk)
        finally:
            with self._lock:
                self._parse_ns += time.monotonic_ns() - t0

    def _fill(self) -> None:
        """Top the window up with fresh chunks (the producer half; it runs
        on the consumer's thread, so a full window simply stops the
        chunk reads)."""
        while not self._eof and self._win.free_slots > 0:
            chunk = self._base.next_chunk()
            if chunk is None:
                self._eof = True
                return
            self._chunks += 1
            self._win.submit(chunk)

    # ---- Parser surface -------------------------------------------------
    @property
    def device(self):
        return self._base.device

    @property
    def bytes_read(self) -> int:
        return self._base.bytes_read

    def next_block(self) -> Optional[RowBlock]:
        check(not self._closed, "parser is closed")
        while True:
            self._fill()
            if len(self._win) == 0:
                return None
            t0 = time.monotonic_ns()
            try:
                container = self._win.pop()
            finally:
                self._wait_ns += time.monotonic_ns() - t0
            if len(container):
                return container.to_block()
            # empty chunk (blank lines): keep pulling

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block

    def before_first(self) -> None:
        """Restart for a fresh epoch: cancel in-flight work, rewind the
        source, reopen the window. Counters keep accumulating (like
        ``bytes_read``, they describe the parser's lifetime)."""
        check(not self._closed, "parser is closed")
        self._win.close()
        self._base.before_first()
        self._open()

    def stats(self) -> dict:
        """Stage counters over the parser's lifetime: chunks submitted,
        worker parse ns (summed over workers), consumer wait ns."""
        with self._lock:
            parse_ns = self._parse_ns
        return {"chunks": self._chunks, "parse_ns": parse_ns,
                "consumer_wait_ns": self._wait_ns,
                "nthread": self._nthread, "window": self._win.window}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._win.close()
        self._base.close()

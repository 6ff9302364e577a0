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

Stage accounting lives in the obs registry under the reference's names:
``dmlc_pipeline_chunks_total``, the worker parse time
``dmlc_pipeline_parse_ns`` and the consumer's wait on the window's head
``dmlc_pipeline_consumer_wait_ns``; ``stats()`` reads them back (chunks
off the in-order seq, so it stays live under ``DMLC_TPU_METRICS=0``).

When tracing is armed each chunk gets a flow id (``obs.new_flow``) at
read time: the ``io_read`` span starts the flow, the worker's ``parse``
span steps it — the id rides the task, since ``current_flow`` is per
thread — and the id rides the emitted RowBlock (``block.flow_id``) so the
DeviceFeed extends the chain. The determinism auditor digests each
chunk's bytes at read (``io_read``) and its parsed container on the
worker (``parse``), keyed by the epoch-relative chunk seq; the
``audit.corrupt`` faultpoint flips one digit after the io_read digest, so
only the parse chain forks.

This is the Python stack's cross-chunk stage: ``create_parser`` takes it
where the native route (``data/parsers.NativePipelineParser``) declines.
The JAX package's process pool (``DMLC_TPU_PARSE_PROCS``) is not ported.
"""

from __future__ import annotations

import itertools
import time
from typing import Iterator, Optional

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.data.parsers import DEFAULT_NTHREAD, Parser
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io.readahead import OrderedWindow
from dmlc_tpu_torch.obs import audit
from dmlc_tpu_torch.resilience import InjectedFault, faultpoint
from dmlc_tpu_torch.utils.logging import check

_PIPE_IDS = itertools.count()  # per-instance obs label (pipe="c0")


def _corrupt_chunk(chunk):
    """``audit.corrupt`` payload: nudge the first ASCII digit so the chunk
    stays parseable but its content forks — the parse-stage digest
    diverges while the io_read digest (taken before this point) stays
    clean, localizing the fault to ``parse``."""
    text = isinstance(chunk, str)
    try:
        buf = bytearray(chunk.encode() if text else chunk)
    except (TypeError, ValueError):
        return chunk
    for i, c in enumerate(buf):
        if 0x30 <= c <= 0x38:  # '0'..'8': +1 keeps it a digit
            buf[i] = c + 1
            return buf.decode() if text else bytes(buf)
    return chunk


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
        # stage counters in the obs registry (docs/observability.md);
        # parse time is summed across workers (it can exceed wall time),
        # consumer_wait is time next_block blocked on the window's head
        pid = "c%d" % next(_PIPE_IDS)
        reg = obs.registry()
        self._m_chunks = reg.counter(
            "dmlc_pipeline_chunks_total", "chunks submitted to the window",
            pipe=pid)
        self._h_parse = reg.histogram(
            "dmlc_pipeline_parse_ns", "per-chunk worker parse time",
            pipe=pid)
        self._h_wait = reg.histogram(
            "dmlc_pipeline_consumer_wait_ns",
            "per-pop consumer wait on the queue head", pipe=pid)
        self._seq = 0  # in-order chunk id (span labels, audit keys)
        # the auditor keys chunk digests on the epoch-relative seq
        # (self._seq - _epoch_base) so chains line up across epochs and
        # ranks; the no-op child when DMLC_TPU_AUDIT is off
        self._audit = audit.auditor()
        self._epoch_base = 0
        self._win: Optional[OrderedWindow] = None
        self._eof = False
        self._closed = False
        self._open()

    def _open(self) -> None:
        self._win = OrderedWindow(self._parse_timed, workers=self._nthread,
                                  window=self._window_arg,
                                  name="pipelined-parse")
        self._eof = False

    def _parse_timed(self, task):
        seq, fid, chunk = task
        t0 = time.monotonic_ns()
        try:
            with obs.span("parse", chunk=seq, flow=fid):
                obs.flow_step(fid, "chunk")
                faultpoint("parse.chunk")
                # audit fault: flip one byte AFTER the io_read digest so
                # only the parse chain forks (localization)
                try:
                    faultpoint("audit.corrupt")
                except InjectedFault:
                    chunk = _corrupt_chunk(chunk)
                container = self._base.parse_chunk(chunk)
            container.flow_id = fid
            self._audit.note_parse(seq - self._epoch_base, container)
            return container
        finally:
            self._h_parse.observe(time.monotonic_ns() - t0)

    def _fill(self) -> None:
        """Top the window up with fresh chunks (the producer half; it runs
        on the consumer's thread, so a full window simply stops the
        chunk reads)."""
        while not self._eof and self._win.free_slots > 0:
            fid = obs.new_flow()
            with obs.span("io_read", chunk=self._seq, flow=fid):
                chunk = self._base.next_chunk()
                if chunk is not None:
                    obs.flow_start(fid, "chunk")
            if chunk is None:
                self._eof = True
                return
            self._m_chunks.inc()
            self._audit.note_chunk(self._seq - self._epoch_base, chunk)
            self._win.submit((self._seq, fid, chunk))
            self._seq += 1

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
                self._h_wait.observe(time.monotonic_ns() - t0)
            if len(container):
                block = container.to_block()
                fid = getattr(container, "flow_id", 0)
                if fid:
                    block.flow_id = fid
                return block
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
        self._epoch_base = self._seq

    def stats(self) -> dict:
        """Stage counters over the parser's lifetime, shaped like the
        reference's (ns): chunks submitted, worker parse ns (summed over
        workers), consumer wait ns — timings read off the obs registry
        children, chunks off the in-order seq."""
        return {"chunks": int(self._seq),
                "parse_ns": int(self._h_parse.sum),
                "consumer_wait_ns": int(self._h_wait.sum),
                "nthread": self._nthread, "window": self._win.window}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._win.close()
        self._base.close()

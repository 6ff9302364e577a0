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
where the native route (``data/parsers.NativePipelineParser``) declines,
and where the call asks for a process pool.

``procs=N`` (N > 0; the JAX package's ``DMLC_TPU_PARSE_PROCS``, an
argument here as ``nthread`` is) moves the parse off the interpreter's
lock: each worker thread ships its chunk to a pool of N processes,
all started with ``spawn`` at the first chunk (the parent holds a CUDA
context, which ``fork`` would copy) with one torch and one BLAS thread
each (``_PROC_ENV``), and blocks on the future. The window
still owns ordering, backpressure, poisoning, the flow ids and the audit
digests, and the ``parse.chunk`` and ``audit.corrupt`` faultpoints fire on
the parent's worker thread, so nothing the consumer sees depends on where
a chunk was parsed. A child rebuilds a replica of the base parser from
its class path and params (:func:`_proc_spec`) on the base's device and
runs the same ``parse_chunk``: on a CUDA device it opens its own context
on that card and launches ``tokenize_boundaries`` there (a child that
finds no CUDA raises DMLCError at its chunk's position; it never
tokenizes on the host), and returns the launches it made with the
container, which the parent adds to its own counts. The parent loads the
kernels' library before it starts the pool, so a child only loads a built
library. A parser whose class has no import path parses on the threads
(``stats()["procs"] == 0``). The pool survives ``before_first`` and
``close`` shuts it down and waits for its processes.
"""

from __future__ import annotations

import concurrent.futures
import importlib
import itertools
import multiprocessing
import os
import threading
import time
from typing import Iterator, Optional

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.data.parsers import DEFAULT_NTHREAD, Parser
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io.readahead import OrderedWindow
from dmlc_tpu_torch.obs import audit
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.resilience import InjectedFault, faultpoint
from dmlc_tpu_torch.utils.logging import check

_PIPE_IDS = itertools.count()  # per-instance obs label (pipe="c0")


class _NullSource:
    """Chunk-less InputSplit stand-in for a pool process's parser replica:
    ``parse_chunk`` never touches the source, which could not cross a
    process boundary anyway (open files, sockets)."""

    def next_chunk(self):
        return None

    def before_first(self):
        pass

    def close(self):
        pass


# a pool process's parser replica per recipe, built at its first chunk
_PROC_PARSERS: dict = {}


#: the environment a pool process starts with: one thread for torch's
#: intra-op pool and for BLAS. A process parses one chunk at a time (the
#: numpy parse's matrix-vector products, and on the CPU the tokenizer's
#: elementwise plain version: no thread count changes their bits), and N
#: processes that each ran a pool of a thread a core would oversubscribe
#: the host: on an H100's host of 8 cores, 4 processes parsed 8 MiB libsvm
#: chunks at 62.4-65.0 MB/s with one thread each and 30.4-31.2 with the
#: libraries' defaults (``chip_smoke.py --pool-threads``).
_PROC_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
             "MKL_NUM_THREADS": "1"}


def _proc_parse(spec, chunk):
    """Parse one chunk in a pool process: (container, {kernel: launches})
    — the launches this parse made, for the parent to add to its counts (a
    pool process runs one task at a time, so the difference is this
    chunk's). ``spec`` is :func:`_proc_spec`'s recipe; module-level, so
    that it pickles by import path under ``spawn``."""
    parser = _PROC_PARSERS.get(spec)
    if parser is None:
        mod_name, cls_name, args, device = spec
        cls = getattr(importlib.import_module(mod_name), cls_name)
        try:
            parser = cls(_NullSource(), dict(args), nthread=1, device=device)
        except TypeError:  # the (source, nthread, device) signature
            parser = cls(_NullSource(), nthread=1, device=device)
        _PROC_PARSERS[spec] = parser
    before = {name: fn.launches for name, fn in kernels.KERNELS.items()}
    container = parser.parse_chunk(chunk)
    return container, {name: fn.launches - before[name]
                       for name, fn in kernels.KERNELS.items()
                       if fn.launches != before[name]}


def _proc_spec(base: Parser):
    """The picklable recipe of a replica of ``base``: (module, class,
    sorted params, device), or None when the class has no import path
    (nested or local) — then its chunks stay on the worker threads."""
    cls = type(base)
    if cls.__qualname__ != cls.__name__:
        return None
    param = getattr(base, "param", None)
    args = tuple(sorted(param.to_dict().items())) if param is not None else ()
    return (cls.__module__, cls.__name__, args, str(base.device))


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
    but unconsumed (default 2×nthread). With ``procs`` > 0 the workers
    hand their chunks to a pool of that many processes (the module
    docstring); the window then runs at least ``procs`` workers, so that
    every process can have a chunk. An exception raised by a worker, or in
    a pool process (its type kept), surfaces from ``next_block`` at the
    failed chunk's in-order position and poisons the window; ``close``
    (and ``before_first``) cancel all pending work.
    """

    def __init__(self, base: Parser, nthread: Optional[int] = None,
                 window: int = 0, procs: int = 0):
        check(isinstance(base, Parser),
              "PipelinedParser requires a Parser base (got %s)",
              type(base).__name__)
        check(procs >= 0, "procs must be >= 0, got %d", procs)
        self._base = base
        self._proc_recipe = _proc_spec(base) if procs > 0 else None
        self._procs = procs if self._proc_recipe is not None else 0
        self._nthread = max(1, self._procs, DEFAULT_NTHREAD if nthread is None
                            else nthread)
        self._executor = None  # the pool, started at the first chunk
        self._pool_lock = threading.Lock()
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
                if self._procs > 0:
                    container, launches = self._pool().submit(
                        _proc_parse, self._proc_recipe, chunk).result()
                    kernels.add_launches(launches)
                else:
                    container = self._base.parse_chunk(chunk)
            container.flow_id = fid
            self._audit.note_parse(seq - self._epoch_base, container)
            return container
        finally:
            self._h_parse.observe(time.monotonic_ns() - t0)

    def _pool(self) -> concurrent.futures.ProcessPoolExecutor:
        """The process pool, started by the first worker that asks."""
        with self._pool_lock:
            check(not self._closed, "parser is closed")
            if self._executor is None:
                if self._base.device.type == "cuda":
                    kernels._lib()  # built here, only loaded by the children
                executor = concurrent.futures.ProcessPoolExecutor(
                    max_workers=self._procs,
                    mp_context=multiprocessing.get_context("spawn"))
                # a submit made while no process is idle starts one, so
                # these start all of them, now, with _PROC_ENV (their
                # results are pids: a broken pool fails the chunks too)
                saved = {k: os.environ.get(k) for k in _PROC_ENV}
                os.environ.update(_PROC_ENV)
                try:
                    for _ in range(self._procs):
                        executor.submit(os.getpid)
                finally:
                    for k, v in saved.items():
                        if v is None:
                            del os.environ[k]
                        else:
                            os.environ[k] = v
                self._executor = executor
            return self._executor

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
                "nthread": self._nthread, "procs": self._procs,
                "window": self._win.window}

    def close(self) -> None:
        """Cancel pending work, shut the process pool down and wait for
        its processes to exit, then close the base."""
        if self._closed:
            return
        with self._pool_lock:
            self._closed = True
            executor, self._executor = self._executor, None
        self._win.close()
        if executor is not None:
            executor.shutdown(wait=True, cancel_futures=True)
        self._base.close()

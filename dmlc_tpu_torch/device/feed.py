"""DeviceFeed: host parse → fixed-shape batch → device tensors.

The single-device port of ``dmlc_tpu/device/feed.py``. The parser's
RowBlocks are re-batched as the reference's device-resident producer does
(``batch_size`` rows a batch, collected as zero-copy slices in a
``RowBlockContainer``, the tail kept for the next chunk, a short last
batch unless ``drop_remainder``), then written once into static shapes
(device/csr.py): a csr batch straight from the container into its staging
arrays (``emit_to_bucket``, padded to ``spec.nnz_bucket`` when it is set),
a dense batch scattered into a zeroed ``[batch, num_features]`` staging
array (``RowBlockContainer.emit_dense_into``).

Over a ``NativePipelineParser`` (``data/parsers.py``'s native route) the
re-batch and the write run in C++ instead: each batch is staged
(``stage_batch``) and written by one native call straight into the staging
arrays (``fetch_batch_dense`` / ``fetch_batch_coo``), so the staging stays
one copy. That route carries no flows or dispatcher seqs (the native
parser has neither), and a feed whose determinism audit is armed reads the
parser's blocks through the Python re-batch instead, so that each batch
gets its digest.

That host stage (re-batch, audit digest, staging) runs on a producer
thread, ``ThreadedIter`` at depth ``host_prefetch`` (explicit, else
``DMLC_TPU_HOST_PREFETCH``, where -1 or unset is auto: 0 on a host with
one usable core, else 2); at 0 it runs inline on the consumer's thread
(:class:`_SyncIter`). The consumer keeps ``spec.prefetch`` batches'
host→device copies in flight (``spec.prefetch``, else
``DMLC_TPU_PREFETCH``, else 1) before it yields the oldest. Neither
option changes a batch's bits. The window is kept for parity with the
JAX package, where it pipelines async dispatch; on a card it buys no
overlap: the copies and the steps share the consumer's stream, so a
wider window only queues more copies ahead of the next step, and the
host already runs ahead of the card through ``non_blocking``.

On a CUDA feed the staging is pinned host memory filled by the producer;
the copies are ``non_blocking`` on the consumer's current stream, so a
step is stream-ordered after its copy, and a staging buffer is handed out
again only after a CUDA event recorded behind its copy has completed
(:class:`PinnedPool`, the counterpart of the reference's
``FixedShapePool`` guarded by ``_transfer_done``). On a CPU feed the
numpy arrays become tensors without a copy, so the staging is fresh for
every batch.

Batch dicts carry the reference's keys: dense ``x``/``label``/``weight``,
csr ``label``/``weight``/``indices``/``values``/``offsets`` (CSR offsets,
not per-entry row ids: the step expands them on the device), plus the
``num_rows`` (and csr ``num_nonzero``) ints.

Over a dispatcher-mode ``RemoteBlockParser`` (data/service.py) the feed
owns the exactly-once ack frontier: it switches the parser to explicit
acks, each chunk's seq id rides the first batch its rows reach (a chunk
with no rows rides the next batch), and the chunk is acked on the
consumer's thread once the consumer comes back from that batch; chunks
whose rows reached only a dropped remainder are acked once the consumer
has taken every batch. Closing the feed mid-epoch acks nothing it did not
deliver (prefetched chunks too), so the dispatcher requeues the rest.

Observability, on the reference's names (docs/observability.md): per-batch
stage histograms ``dmlc_feed_host_batch_ns`` (host production on the
producer: parse, then the write into staging), ``dmlc_feed_dispatch_ns``
(the non_blocking copy submission), ``dmlc_feed_host_wait_ns`` (the
consumer's wait on the producer thread; not observed at depth 0, where
that time is host_batch) and ``dmlc_feed_consume_ns`` (the time the
consumer held each batch: its step as the host sees it), the
``dmlc_feed_*`` / ``dmlc_pool_*`` counters, the H2D meter on the copies,
``stage`` / ``dispatch`` / ``consume`` / ``feed_batch`` spans that carry
each chunk's flow on to the consumer (``obs.current_flow`` is set around
the yield), and batch digests at emit for the determinism audit.
:meth:`DeviceFeed.stats` windows those totals to the current epoch and
:func:`stall_breakdown` formats them.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.data.parsers import Parser, create_parser
from dmlc_tpu_torch.data.row_block import RowBlockContainer
from dmlc_tpu_torch.device.csr import _bucket, _staging_raw, emit_to_bucket
from dmlc_tpu_torch.obs import audit, device_telemetry
from dmlc_tpu_torch.params.env import get_env
from dmlc_tpu_torch.resilience import faultpoint
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check, log_warning
from dmlc_tpu_torch.utils.threaded_iter import ThreadedIter

_FEED_IDS = itertools.count()  # per-instance obs label (feed="f0")
_POOL_IDS = itertools.count()  # per-instance obs label (pool="p0")

_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
}


def _available_cpus() -> int:
    """CPUs this process may run on (its affinity mask, so a one-core
    container on a large host counts one); ``os.cpu_count()`` elsewhere."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # not linux
        return os.cpu_count() or 1


def default_prefetch(explicit: Optional[int] = None) -> int:
    """The transfer window: ``explicit``, else ``DMLC_TPU_PREFETCH``,
    else 1; at least 1."""
    if explicit is not None:
        return max(1, int(explicit))
    return max(1, int(get_env("DMLC_TPU_PREFETCH", 1)))


def default_host_prefetch(explicit: Optional[int] = None) -> Optional[int]:
    """The producer's queue depth: ``explicit``, else
    ``DMLC_TPU_HOST_PREFETCH``; None (auto) when that is -1 or unset."""
    if explicit is not None:
        return int(explicit)
    val = int(get_env("DMLC_TPU_HOST_PREFETCH", -1))
    return None if val < 0 else val


class _SyncIter:
    """ThreadedIter's consumer surface (iteration, ``close``,
    ``before_first``) over the producer run inline: ``host_prefetch=0``."""

    def __init__(self, factory):
        self._factory = factory
        self._gen = factory()

    def __iter__(self):
        return self._gen

    def before_first(self) -> None:
        self.close()
        self._gen = self._factory()

    def close(self) -> None:
        gen, self._gen = self._gen, iter(())
        if hasattr(gen, "close"):
            gen.close()


@dataclass
class BatchSpec:
    """Static-shape contract for one feed."""

    batch_size: int
    layout: str = "dense"  # "dense" | "csr"
    num_features: int = 0  # required for dense; bounds csr feature ids
    nnz_bucket: Optional[int] = None  # a fixed csr entry bucket, else auto
    drop_remainder: bool = False
    # host→device copies in flight ahead of the consumer; None resolves
    # through DMLC_TPU_PREFETCH (default 1). Parity with the JAX package:
    # on a card the copies share the step's stream, so it overlaps nothing
    prefetch: Optional[int] = None


class PinnedPool:
    """Pinned host staging arrays keyed by (shape, dtype), reused across
    batches. ``acquire`` returns a numpy view of a pinned tensor;
    ``retire(arrays, event)`` offers a batch's arrays back, and they are
    handed out again only once ``event`` (recorded on the stream behind
    their copies) has completed — never blocking: a buffer still being
    read is left retired and a fresh one allocated, so the pool grows to
    the in-flight depth and then stops allocating. The feed's producer
    thread acquires while its consumer retires, so both go under one
    lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._free: Dict[tuple, list] = {}
        self._retired: deque = deque()  # (arrays, event)
        self._owner: Dict[int, tuple] = {}  # id(array) -> (array, tensor)
        self._shapes: set = set()
        # plain ints next to the registry mirrors: stats() stays truthful
        # under DMLC_TPU_METRICS=0
        self.allocated = 0
        self.reused = 0
        pid = "p%d" % next(_POOL_IDS)
        reg = obs.registry()
        self._m_allocated = reg.counter(
            "dmlc_pool_allocated_total",
            "staging buffers newly allocated", pool=pid)
        self._m_reused = reg.counter(
            "dmlc_pool_reused_total",
            "staging buffers recycled from the free list", pool=pid)

    @staticmethod
    def _key(shape, dtype) -> tuple:
        if isinstance(shape, int):
            shape = (shape,)
        return tuple(shape), np.dtype(dtype).str

    def acquire(self, shape, dtype) -> np.ndarray:
        key = self._key(shape, dtype)
        with self._lock:
            self._shapes.add(key)
            self._drain()
            free = self._free.get(key)
            if free:
                self.reused += 1
                self._m_reused.inc()
                return free.pop()
        tensor = torch.empty(key[0], dtype=_TORCH_DTYPE[np.dtype(dtype)],
                             pin_memory=True)
        arr = tensor.numpy()
        with self._lock:
            self._owner[id(arr)] = (arr, tensor)
            self.allocated += 1
        self._m_allocated.inc()
        return arr

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        """The pinned tensor behind an array this pool handed out."""
        with self._lock:
            return self._owner[id(arr)][1]

    def retire(self, arrays, event: torch.cuda.Event) -> None:
        with self._lock:
            self._retired.append((list(arrays), event))

    def stats(self) -> dict:
        with self._lock:
            return {"shapes": len(self._shapes),
                    "allocated": self.allocated, "reused": self.reused,
                    "pending_retire": len(self._retired)}

    def _drain(self) -> None:
        # under the lock; oldest first: copies on one stream complete in
        # order
        while self._retired and self._retired[0][1].query():
            arrays, _ = self._retired.popleft()
            for arr in arrays:
                self._free.setdefault(
                    self._key(arr.shape, arr.dtype), []).append(arr)


def stall_breakdown(stats: dict) -> str:
    """One-line human summary of :meth:`DeviceFeed.stats` — where the
    epoch's wall time sat (ms per stage) plus pool reuse, for fit-loop
    logging. ``host_wait`` ≈ 0 means the feed kept up with the consumer;
    ``host_wait`` ≈ ``host_batch`` means the consumer was ingest-bound.
    A formatter only: the numbers come from the obs registry, windowed to
    the epoch by ``stats()``."""
    ms = 1e6
    parts = [
        "feed[%d batches]" % stats.get("batches", 0),
        "host_batch %.1fms" % (stats.get("host_batch_ns", 0) / ms),
        "dispatch %.1fms" % (stats.get("dispatch_ns", 0) / ms),
        "host_wait %.1fms" % (stats.get("host_wait_ns", 0) / ms),
        "consume %.1fms" % (stats.get("consume_ns", 0) / ms),
    ]
    pool = stats.get("pool") or {}
    if pool.get("allocated"):
        parts.append(
            "pool %d shapes %d alloc %d reuse"
            % (pool.get("shapes", 0), pool["allocated"],
               pool.get("reused", 0))
        )
    pipe = stats.get("pipeline") or {}
    if pipe.get("chunks"):
        parts.append(
            "parse[%d chunks x%d] %.1fms (+%.1fms wait)"
            % (pipe["chunks"], pipe.get("nthread", 1),
               pipe.get("parse_ns", 0) / ms,
               pipe.get("consumer_wait_ns", 0) / ms)
        )
    return " | ".join(parts)


class DeviceFeed:
    """Iterate fixed-shape device batches from a parser or a uri; a uri
    gets ``create_parser`` on the feed's device (its route by the parser
    module's rules: the native pipeline for local files, where the
    Python stack's libsvm chunks would tokenize on that device).
    ``host_prefetch`` is the producer thread's queue
    depth (0 runs the host stage inline; None reads
    ``DMLC_TPU_HOST_PREFETCH``, else auto). The producer starts at the
    first iteration, so a caller may restore the parser's read plan after
    construction."""

    def __init__(self, source, spec: BatchSpec, device=None,
                 part_index: int = 0, num_parts: int = 1,
                 host_prefetch: Optional[int] = None):
        check(spec.layout in ("dense", "csr"), "layout must be dense or csr")
        if spec.layout == "dense":
            check(spec.num_features > 0, "dense layout requires num_features")
        self.device = resolve_device(device)
        host_prefetch = default_host_prefetch(host_prefetch)
        if host_prefetch is None:
            host_prefetch = 0 if _available_cpus() <= 1 else 2
        self.host_prefetch = max(0, host_prefetch)
        self._sync_host = self.host_prefetch == 0
        self._prefetch = default_prefetch(spec.prefetch)
        if isinstance(source, str):
            source = create_parser(source, part_index, num_parts,
                                   device=self.device)
        self._parser: Parser = source
        self.spec = spec
        self.pool = PinnedPool() if self.device.type == "cuda" else None
        # per-stage wall time in the obs registry as per-batch histograms
        # (host_batch observed on the producer, the rest on the consumer);
        # stats() windows the monotonic totals with _epoch_base so it
        # describes the current epoch
        fid = "f%d" % next(_FEED_IDS)
        reg = obs.registry()
        self._stage = {
            "host_batch_ns": reg.histogram(
                "dmlc_feed_host_batch_ns",
                "per-batch host production (parse + densify/pad)", feed=fid),
            "dispatch_ns": reg.histogram(
                "dmlc_feed_dispatch_ns",
                "per-batch async device transfer submission", feed=fid),
            "host_wait_ns": reg.histogram(
                "dmlc_feed_host_wait_ns",
                "per-batch consumer wait on the host producer", feed=fid),
            "consume_ns": reg.histogram(
                "dmlc_feed_consume_ns",
                "per-batch time the consumer held the batch", feed=fid),
        }
        self._m_batches = reg.counter(
            "dmlc_feed_batches_total", "device batches delivered", feed=fid)
        # rows delivered — the goodput ledger's examples/s numerator
        self._m_rows = reg.counter(
            "dmlc_feed_rows_total", "examples delivered to device",
            feed=fid)
        # host→device copy calls (one a batch array on a card)
        self._m_dispatches = reg.counter(
            "dmlc_feed_h2d_dispatches_total",
            "device_put dispatch calls (one per batched pytree put; "
            "per-array regressions show up as dispatches/batch > 1)",
            feed=fid)
        # H2D accounting around the copies: None when device telemetry is
        # off or the feed is on the CPU (no copy), and then no byte walk
        self._h2d = (device_telemetry.h2d_meter(feed=fid)
                     if self.pool is not None else None)
        device_telemetry.maybe_start_hbm_poller()
        # batch digests at emit, keyed by the per-epoch batch index (the
        # shared no-op child when DMLC_TPU_AUDIT is off)
        self._audit = audit.auditor()
        self._epoch_base: dict = {}
        # exactly-once acks (a dispatcher-mode RemoteBlockParser): switch
        # the parser to explicit acks before its first fetch, so a chunk is
        # acked only once the consumer has stepped on its rows
        self._ack = getattr(self._parser, "ack", None)
        set_explicit = getattr(self._parser, "set_explicit_ack", None)
        if callable(self._ack) and callable(set_explicit):
            set_explicit()
        else:
            self._ack = None
        self._host_iter = None  # started by the first __iter__

    def _start_host_iter(self):
        if self._sync_host:
            return _SyncIter(self._host_batches)
        return ThreadedIter(self._host_batches,
                            max_capacity=self.host_prefetch,
                            name="device-feed")

    # ---- host side: re-batch parser blocks into fixed-size batches ------
    def _containers(self) -> Iterator:
        """(container, flow ids, chunk seq ids) of ``batch_size`` rows (the
        last one shorter unless ``drop_remainder``), each holding slices of
        the parser's blocks; a chunk's flow id and dispatcher seq id ride
        the first batch its rows reach, a chunk with no rows the next
        batch. Seqs left at the end (their rows only reached a dropped
        remainder, or no rows followed) come last as ``(None, (),
        seqs)``: the consumer acks them once it has taken every batch."""
        bs = self.spec.batch_size
        pending = RowBlockContainer()
        flows, seqs = [], []
        for block in self._parser:
            fid = getattr(block, "flow_id", 0)
            if fid:
                flows.append(fid)
            sid = getattr(block, "seq_id", None)
            if sid is not None:
                seqs.append(sid)
            start = 0
            while start < len(block):
                take = min(bs - len(pending), len(block) - start)
                pending.push_block(block.slice(start, start + take))
                start += take
                if len(pending) == bs:
                    yield pending, tuple(flows), tuple(seqs)
                    pending = RowBlockContainer()
                    flows, seqs = [], []
        if len(pending) and not self.spec.drop_remainder:
            yield pending, tuple(flows), tuple(seqs)
        elif seqs:
            yield None, (), tuple(seqs)

    def _ack_seq(self, sid) -> None:
        """Report one dispatcher chunk consumed, best effort: a lost ack
        is covered by the lease deadline and a repeated one is harmless,
        so a dispatcher that went away must not stop the training loop."""
        if self._ack is None:
            return
        try:
            self._ack(sid)
        except Exception as err:  # noqa: BLE001 (see the docstring)
            log_warning("device feed: ack of chunk %s lost: %s", sid,
                        str(err).split("\n\nStack trace:")[0])

    def _use_native_batches(self) -> bool:
        """The C++ re-batch and write (pipeline.cc StageBatch /
        FetchBatch*) when the parser has them, unless the audit is armed
        (its batch digests are taken from the Python re-batch)."""
        return (getattr(self._parser, "supports_batch_fetch", False)
                and not self._audit.enabled)

    def _host_batches(self) -> Iterator:
        """The host stage (the producer thread's loop at depth > 0):
        (staged host arrays, flow ids, seq ids) per batch; the time of
        each step is ``dmlc_feed_host_batch_ns``."""
        producer = (self._host_batches_native() if self._use_native_batches()
                    else self._host_batches_python())
        while True:
            faultpoint("device.feed")
            t0 = time.monotonic_ns()
            try:
                try:
                    item = next(producer)
                except StopIteration:
                    return
            finally:
                self._stage["host_batch_ns"].observe(
                    time.monotonic_ns() - t0)
            yield item

    def _host_batches_python(self) -> Iterator:
        """Each batch's digest at emit, then its write into staging inside
        a ``stage`` span."""
        bidx = 0  # per-epoch batch index (the audit's batch-chain key)
        for rows, flows, seqs in self._containers():
            if rows is None:
                yield None, flows, seqs
                continue
            self._audit.note_batch(bidx, rows)
            bidx += 1
            with obs.span("stage", rows=len(rows)):
                for fid in flows:
                    obs.flow_step(fid, "chunk")
                staged = self._stage_rows(rows)
            yield staged, flows, seqs

    def _host_batches_native(self) -> Iterator:
        """Stage each batch in C++, then write it with one native call into
        the staging arrays (pinned on a card) inside a ``stage`` span."""
        bs = self.spec.batch_size
        row_ids = [np.empty(0, dtype=np.int32)]  # the C++ writes; unused
        while True:
            staged = self._parser.stage_batch(bs)
            if staged is None:
                return
            nrows, nnz = staged
            if nrows < bs and self.spec.drop_remainder:
                return
            with obs.span("stage", rows=nrows):
                arrays = self._fetch_native(nnz, row_ids)
            yield arrays, (), ()

    def _fetch_native(self, nnz: int, row_ids: list) -> tuple:
        """(host arrays, ints) of the staged batch, written by the C++
        straight into its static shapes."""
        spec = self.spec
        bs = spec.batch_size
        labels = _staging_raw(self.pool, bs, np.float32)
        weights = _staging_raw(self.pool, bs, np.float32)
        if spec.layout == "dense":
            x = _staging_raw(self.pool, (bs, spec.num_features), np.float32)
            n = self._parser.fetch_batch_dense(
                bs, spec.num_features, x=x, labels=labels,
                weights=weights)[3]
            return ({"x": x, "label": labels, "weight": weights},
                    {"num_rows": n})
        bucket = _bucket(nnz, spec.nnz_bucket)
        if len(row_ids[0]) < bucket:
            row_ids[0] = np.empty(bucket, dtype=np.int32)
        indices = _staging_raw(self.pool, bucket, np.int32)
        values = _staging_raw(self.pool, bucket, np.float32)
        offsets = _staging_raw(self.pool, bs + 1, np.int32)
        n = self._parser.fetch_batch_coo(
            bs, bucket, labels=labels, weights=weights, indices=indices,
            values=values, row_ids=row_ids[0][:bucket], offsets=offsets)[6]
        # an out-of-range feature id would index past w on the device (the
        # u32 view catches ids past 2^31 too)
        top = int(indices[:nnz].view(np.uint32).max()) if nnz else 0
        check(spec.num_features <= 0 or top < spec.num_features,
              "feature id %d out of range for num_features %d", top,
              spec.num_features)
        return ({"label": labels, "weight": weights, "indices": indices,
                 "values": values, "offsets": offsets},
                {"num_rows": n, "num_nonzero": nnz})

    def _stage_rows(self, rows: RowBlockContainer) -> tuple:
        """(host arrays, ints) of one batch, written once into its static
        shapes (into pinned staging on a CUDA feed)."""
        spec = self.spec
        if spec.layout == "dense":
            # pinned from the pool on a card; fresh on the CPU, whose
            # feed hands its arrays out without a copy
            bs = spec.batch_size
            x = _staging_raw(self.pool, (bs, spec.num_features), np.float32)
            x.fill(0)  # the scatter writes only the present entries
            labels = _staging_raw(self.pool, bs, np.float32)
            weights = _staging_raw(self.pool, bs, np.float32)
            n = rows.emit_dense_into(x, labels, weights)
            labels[n:] = 0.0
            weights[n:] = 0.0
            return ({"x": x, "label": labels, "weight": weights},
                    {"num_rows": n})
        # an out-of-range feature id would index past w on the device
        check(spec.num_features <= 0 or rows.num_nonzero == 0
              or rows.max_index < spec.num_features,
              "feature id %d out of range for num_features %d",
              rows.max_index, spec.num_features)
        batch = emit_to_bucket(rows, spec.batch_size,
                               nnz_bucket=spec.nnz_bucket, pool=self.pool)
        return ({"label": batch.labels, "weight": batch.weights,
                 "indices": batch.indices, "values": batch.values,
                 "offsets": batch.offsets},
                {"num_rows": batch.num_rows,
                 "num_nonzero": batch.num_nonzero})

    # ---- device side ---------------------------------------------------
    def _put(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.pool is None:
            return {k: torch.from_numpy(v) for k, v in arrays.items()}
        meter = self._h2d
        t0 = time.monotonic_ns()
        out = {
            k: self.pool.tensor(v).to(self.device, non_blocking=True)
            for k, v in arrays.items()
        }
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self.pool.retire(arrays.values(), event)
        self._m_dispatches.inc(len(arrays))
        if meter is not None:
            meter.note(sum(v.nbytes for v in arrays.values()),
                       time.monotonic_ns() - t0)
        return out

    def _consume(self, entry, index: int):
        """Yield one pending batch inside its ``consume`` span, then ack
        the chunks that ride it. The span covers the yield: its duration
        IS the time the consumer held the batch, and the thread's current
        flow is the batch's first chunk for that window, so fit-loop spans
        (train_step, collective ops) mark the chunk; each flow ends inside
        the span. A batch the consumer never comes back from (the feed
        closed, or an error) is not acked, so its chunks requeue."""
        batch, flows, seqs = entry
        if batch is not None:
            t2 = time.monotonic_ns()
            with obs.span("consume", batch=index):
                if flows:
                    obs.set_current_flow(flows[0])
                try:
                    yield batch
                finally:
                    if flows:
                        obs.set_current_flow(0)
                    for fid in flows:
                        obs.flow_end(fid, "chunk")
            self._stage["consume_ns"].observe(time.monotonic_ns() - t2)
        for sid in seqs:
            self._ack_seq(sid)

    def __iter__(self):
        """Yield device batches with ``spec.prefetch`` copies in flight
        ahead of the consumer. A producer error (a parse error, the
        ``device.feed`` faultpoint) is raised at its in-order position,
        after the batches before it; the feed stays closeable."""
        if self._host_iter is None:
            self._host_iter = self._start_host_iter()
        window = self._prefetch
        pending: deque = deque()
        it = iter(self._host_iter)
        nbatch = ndelivered = 0
        error = None
        while True:
            with obs.span("feed_batch", batch=nbatch):
                t0 = time.monotonic_ns()
                try:
                    staged, flows, seqs = next(it)
                except StopIteration:
                    break
                except Exception as err:  # noqa: BLE001 (raised below)
                    error = err
                    break
                finally:
                    # inline, the time inside next() is host_batch already
                    if not self._sync_host:
                        self._stage["host_wait_ns"].observe(
                            time.monotonic_ns() - t0)
                if staged is None:
                    pending.append((None, flows, seqs))
                    continue
                arrays, ints = staged
                t1 = time.monotonic_ns()
                with obs.span("dispatch", batch=nbatch):
                    for fid in flows:
                        obs.flow_step(fid, "chunk")
                    batch = self._put(arrays)
                    batch.update(ints)
                self._stage["dispatch_ns"].observe(time.monotonic_ns() - t1)
                self._m_batches.inc()
                self._m_rows.inc(int(ints["num_rows"]))
                pending.append((batch, flows, seqs))
                nbatch += 1
            if len(pending) > window:
                yield from self._consume(pending.popleft(), ndelivered)
                ndelivered += 1
        while pending:
            yield from self._consume(pending.popleft(), ndelivered)
            ndelivered += 1
        if error is not None:
            raise error

    def stats(self) -> dict:
        """Per-stage wall time of the current epoch (ns): host batch
        production (parse + staging, on the producer), device dispatch,
        the consumer's wait on the producer thread (0 at depth 0) and the
        time the consumer held each batch, plus the staging pool's
        counters and the parser pipeline's own stage counters when it has
        them."""
        base = self._epoch_base
        out = {
            "batches": int(self._m_batches.value - base.get("batches", 0)),
            "pool": self.pool.stats() if self.pool is not None else {},
        }
        for key, hist in self._stage.items():
            out[key] = int(hist.sum - base.get(key, 0))
        parser_stats = getattr(self._parser, "stats", None)
        if callable(parser_stats):
            pipeline = parser_stats()
            if pipeline:
                out["pipeline"] = pipeline
        return out

    def before_first(self) -> None:
        """Stop the producer, rewind the parser, then restart the
        producer on the next epoch."""
        if self._host_iter is not None:
            self._host_iter.close()
        self._parser.before_first()
        # registry metrics are monotonic (Prometheus semantics); stats()
        # windows them against this baseline
        self._epoch_base = {
            key: hist.sum for key, hist in self._stage.items()
        }
        self._epoch_base["batches"] = self._m_batches.value
        if self._host_iter is not None:
            self._host_iter.before_first()

    @property
    def bytes_read(self) -> int:
        return self._parser.bytes_read

    def close(self) -> None:
        """Join the producer thread, then close the parser."""
        if self._host_iter is not None:
            self._host_iter.close()
        self._parser.close()

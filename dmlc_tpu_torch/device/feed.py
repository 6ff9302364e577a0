"""DeviceFeed: host parse → fixed-shape batch → device tensors.

The single-device port of ``dmlc_tpu/device/feed.py``. The parser's
RowBlocks are re-batched as the reference's device-resident producer does
(``batch_size`` rows a batch, collected as zero-copy slices in a
``RowBlockContainer``, the tail kept for the next chunk, a short last
batch unless ``drop_remainder``), then padded into static shapes
(device/csr.py): a csr batch straight from the container into its staging
arrays (``emit_to_bucket``, one copy), a dense batch through
``block_to_dense``.

On a CUDA feed the padding writes straight into pinned host staging, the
copies are ``non_blocking``, and a staging buffer is handed out again only
after a CUDA event recorded behind its copy has completed (:class:`PinnedPool`,
the counterpart of the reference's ``FixedShapePool`` guarded by
``_transfer_done``). On a CPU feed the numpy arrays become tensors without a
copy.

Batch dicts carry the reference's keys: dense ``x``/``label``/``weight``,
csr ``label``/``weight``/``indices``/``values``/``offsets`` (CSR offsets,
not per-entry row ids: the step expands them on the device), plus the
``num_rows`` (and csr ``num_nonzero``) ints.

Over a dispatcher-mode ``RemoteBlockParser`` (data/service.py) the feed
owns the exactly-once ack frontier: it switches the parser to explicit
acks, each chunk's seq id rides the first batch its rows reach, and the
chunk is acked once the consumer comes back from that batch (a chunk with
no rows at once). Closing the feed mid-epoch acks nothing it did not
deliver, so the dispatcher requeues the rest.

Observability, on the reference's names (docs/observability.md): per-batch
stage histograms ``dmlc_feed_host_batch_ns`` (host production: parse, then
the pad into staging), ``dmlc_feed_dispatch_ns`` (the non_blocking copy
submission), ``dmlc_feed_host_wait_ns`` (the consumer's wait on a producer
thread — none here: the host stage runs on the consumer's thread, so its
time is all host_batch) and ``dmlc_feed_consume_ns`` (the time the
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
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.data.parsers import Parser, create_parser
from dmlc_tpu_torch.data.row_block import RowBlockContainer
from dmlc_tpu_torch.device.csr import block_to_dense, emit_to_bucket
from dmlc_tpu_torch.obs import audit, device_telemetry
from dmlc_tpu_torch.resilience import faultpoint
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check, log_warning

_FEED_IDS = itertools.count()  # per-instance obs label (feed="f0")
_POOL_IDS = itertools.count()  # per-instance obs label (pool="p0")

_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
}


@dataclass
class BatchSpec:
    """Static-shape contract for one feed."""

    batch_size: int
    layout: str = "dense"  # "dense" | "csr"
    num_features: int = 0  # required for dense; bounds csr feature ids
    drop_remainder: bool = False


class PinnedPool:
    """Pinned host staging arrays keyed by (shape, dtype), reused across
    batches. ``acquire`` returns a numpy view of a pinned tensor;
    ``retire(arrays, event)`` offers a batch's arrays back, and they are
    handed out again only once ``event`` (recorded on the stream behind
    their copies) has completed — never blocking: a buffer still being
    read is left retired and a fresh one allocated, so the pool grows to
    the in-flight depth and then stops allocating."""

    def __init__(self):
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
        self._owner[id(arr)] = (arr, tensor)
        self.allocated += 1
        self._m_allocated.inc()
        return arr

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        """The pinned tensor behind an array this pool handed out."""
        return self._owner[id(arr)][1]

    def retire(self, arrays, event: torch.cuda.Event) -> None:
        self._retired.append((list(arrays), event))

    def stats(self) -> dict:
        return {"shapes": len(self._shapes), "allocated": self.allocated,
                "reused": self.reused, "pending_retire": len(self._retired)}

    def _drain(self) -> None:
        # oldest first: copies on one stream complete in order
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
    gets ``create_parser`` on the feed's device, so its libsvm chunks
    tokenize there too."""

    def __init__(self, source, spec: BatchSpec, device=None,
                 part_index: int = 0, num_parts: int = 1):
        check(spec.layout in ("dense", "csr"), "layout must be dense or csr")
        if spec.layout == "dense":
            check(spec.num_features > 0, "dense layout requires num_features")
        self.device = resolve_device(device)
        if isinstance(source, str):
            source = create_parser(source, part_index, num_parts,
                                   device=self.device)
        self._parser: Parser = source
        self.spec = spec
        self.pool = PinnedPool() if self.device.type == "cuda" else None
        # per-stage wall time in the obs registry as per-batch histograms;
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

    # ---- host side: re-batch parser blocks into fixed-size batches ------
    def _containers(self) -> Iterator:
        """(container, flow ids, chunk seq ids) of ``batch_size`` rows (the
        last one shorter unless ``drop_remainder``), each holding slices of
        the parser's blocks; a chunk's flow id and dispatcher seq id ride
        the first batch its rows reach. A chunk with no rows, or whose rows
        only reach a dropped remainder, is acked here: it was visited."""
        bs = self.spec.batch_size
        pending = RowBlockContainer()
        flows, seqs = [], []
        for block in self._parser:
            fid = getattr(block, "flow_id", 0)
            if fid:
                flows.append(fid)
            sid = getattr(block, "seq_id", None)
            if sid is not None:
                if len(block):
                    seqs.append(sid)
                else:
                    self._ack_seq(sid)
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
        else:
            for sid in seqs:
                self._ack_seq(sid)

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

    def _host_batches(self) -> Iterator:
        """(staged host arrays, flow ids, seq ids): each batch's digest at
        emit,
        then its pad into staging inside a ``stage`` span; the time of
        each step of this producer is ``dmlc_feed_host_batch_ns``."""
        producer = self._containers()
        bidx = 0  # per-epoch batch index (the audit's batch-chain key)
        while True:
            faultpoint("device.feed")
            t0 = time.monotonic_ns()
            try:
                try:
                    rows, flows, seqs = next(producer)
                except StopIteration:
                    return
                self._audit.note_batch(bidx, rows)
                bidx += 1
                with obs.span("stage", rows=len(rows)):
                    for fid in flows:
                        obs.flow_step(fid, "chunk")
                    staged = self._stage_rows(rows)
            finally:
                self._stage["host_batch_ns"].observe(
                    time.monotonic_ns() - t0)
            yield staged, flows, seqs

    # ---- device side ---------------------------------------------------
    def _stage_rows(self, rows: RowBlockContainer) -> tuple:
        """(host arrays, ints) of one batch, padded to its static shapes
        (into pinned staging on a CUDA feed)."""
        spec = self.spec
        if spec.layout == "dense":
            x, labels, weights = block_to_dense(
                rows.to_block(), spec.batch_size, spec.num_features,
                pool=self.pool)
            return ({"x": x, "label": labels, "weight": weights},
                    {"num_rows": len(rows)})
        # an out-of-range feature id would index past w on the device
        check(spec.num_features <= 0 or rows.num_nonzero == 0
              or rows.max_index < spec.num_features,
              "feature id %d out of range for num_features %d",
              rows.max_index, spec.num_features)
        batch = emit_to_bucket(rows, spec.batch_size, pool=self.pool)
        return ({"label": batch.labels, "weight": batch.weights,
                 "indices": batch.indices, "values": batch.values,
                 "offsets": batch.offsets},
                {"num_rows": batch.num_rows,
                 "num_nonzero": batch.num_nonzero})

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

    def __iter__(self):
        """Yield device batches. The consume span covers the yield: its
        duration IS the time the consumer held the batch, and the
        thread's current flow is the batch's first chunk for that window,
        so fit-loop spans (train_step, collective ops) mark the chunk;
        each flow ends inside the consume span. Once the yield returns the
        consumer is done with the batch, and the dispatcher chunks whose
        rows first reached it are acked; a batch the consumer never comes
        back from (the feed closed, or an error) is not acked, so its
        chunks requeue."""
        nbatch = 0
        producer = self._host_batches()
        while True:
            with obs.span("feed_batch", batch=nbatch):
                try:
                    (arrays, ints), flows, seqs = next(producer)
                except StopIteration:
                    break
                t1 = time.monotonic_ns()
                with obs.span("dispatch", batch=nbatch):
                    for fid in flows:
                        obs.flow_step(fid, "chunk")
                    batch = self._put(arrays)
                    batch.update(ints)
                self._stage["dispatch_ns"].observe(time.monotonic_ns() - t1)
                self._m_batches.inc()
                self._m_rows.inc(int(ints["num_rows"]))
            t2 = time.monotonic_ns()
            with obs.span("consume", batch=nbatch):
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
            nbatch += 1

    def stats(self) -> dict:
        """Per-stage wall time of the current epoch (ns): host batch
        production (parse + pad), device dispatch, the consumer's wait on
        a producer thread (0: none here) and the time the consumer held
        each batch, plus the staging pool's counters and the parser
        pipeline's own stage counters when it has them."""
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
        self._parser.before_first()
        # registry metrics are monotonic (Prometheus semantics); stats()
        # windows them against this baseline
        self._epoch_base = {
            key: hist.sum for key, hist in self._stage.items()
        }
        self._epoch_base["batches"] = self._m_batches.value

    @property
    def bytes_read(self) -> int:
        return self._parser.bytes_read

    def close(self) -> None:
        self._parser.close()

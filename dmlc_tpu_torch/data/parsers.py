"""Text parsers: libsvm / libfm / csv chunks → CSR RowBlocks (src/data/
parser.h, text_parser.h, libsvm_parser.h, libfm_parser.h, csv_parser.h),
the port of ``dmlc_tpu/data/parsers.py``'s Python stack.

- ``Parser``: a streaming one-pass iterator over RowBlocks pulled chunk by
  chunk from an InputSplit; a chunk is split at line breaks into
  ``nthread`` parts parsed by a thread pool (text_parser.h:94-134) and
  merged in order; ``bytes_read`` counts the raw bytes.
- ``LibSVMParser``: ``label[:weight] [qid:n] index[:value]...``. The token
  masks of each part come from the ``tokenize_boundaries`` kernel on the
  parser's device (``data/vparse.kernel_token_masks``); the rest of the
  parse is the vectorized numpy parse (``data/vparse.py``).
- ``LibFMParser`` (``label field:index:value...``) and ``CSVParser``
  (dense rows, ``label_column`` / ``weight_column``): host code only.
- ``ThreadedParser``: background-thread prefetch of parsed blocks
  (parser.h:70-126).
- ``PARSER_REGISTRY`` / ``register_parser`` and ``create_parser(uri, part,
  nparts, format)`` over any uri of the filesystem registry (local,
  ``s3://``, ``gs://``, ``hdfs://``, ``azure://``, ``http(s)://``,
  ``mem://``: a remote uri reads through the same InputSplit), resolving
  "auto" through the ``format=`` uri arg, or a ``.dtsh`` suffix (local
  files only), else libsvm (src/data.cc:62-85); with
  ``threaded=True`` a ``Parser`` comes wrapped in the cross-chunk
  ``data/pipeline.PipelinedParser``.
- the binary formats: ``recordio`` (row groups, ``data/rowrec.py``, over
  a recordio InputSplit) and ``shard`` (``io/shard.ShardParser``); neither
  runs the tokenizer.
- a ``shuffle_chunks=SEED`` uri arg reads the part's text or recordio
  chunks through ``InputSplitShuffle`` (16 sub-splits, a new order each
  epoch) and seeds a shard's window shuffle; a ``#cachefile`` uri reads
  through ``CachedInputSplit`` (the chunks of the first epoch replayed
  from the file afterwards).

- ``NativePipelineParser``: the all-native route (the reader, the parse
  workers and the ordered queue of ``native/csrc/pipeline.cc``), with the
  fixed-shape batch staging the feed reads (``read_batch_dense`` /
  ``read_batch_coo`` / ``read_batch_coo_sharded``).

How the route is chosen: by the call, as the JAX package chooses with its
library loaded; no environment variable and no device chooses it.
``create_parser(..., threaded=True)`` over libsvm, libfm, csv or recordio
takes the native route when the files are all local, or all on one remote
filesystem with no ``shuffle_chunks`` (the bytes pushed in by
``io/readahead.RemotePartitionReader``), and the determinism audit is not
armed; a libsvm ``#cachefile`` takes the row-group cache
(``<cache>.rowrec``, ``_try_native_cached``). The Python stack serves
``threaded=False``, parsers built directly, registered plugin formats and
``.dtsh`` shards, mixed filesystems, a remote ``shuffle_chunks``, an armed
audit, and ``#cachefile`` on another format. Inside it,
``LibSVMParser.parse_chunk`` runs the ``tokenize_boundaries`` kernel on
the parser's device (the counterpart of the JAX package's Pallas tokenizer
route) and ``LibFMParser`` / ``CSVParser`` parse on the host, whatever
the native library could do. The device chooses only what runs after the
parse. A native route that cannot build its library raises. The parse
loop's ``parse.chunk`` faultpoint and its chunk flows and acks are the
Python stack's (``data/pipeline.PipelinedParser``'s workers); on the
native route the C++ parses, and the feed's ``device.feed`` faultpoint is
the one a fit passes on both routes.

Every parser takes ``device`` (None means cuda, see utils/device.py).
``create_parser`` stamps the audit's shard signature
(``obs.audit.Auditor.set_shard``; a ``ShardParser`` stamps its own); the
chunk and parse digests are taken in ``data/pipeline.PipelinedParser``.
The JAX package's knobs ``DMLC_TPU_NATIVE``, ``DMLC_TPU_PARSE_BACKEND``
and ``DMLC_TPU_NTHREAD`` have no counterpart here.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import threading
import uuid
from typing import Dict, Iterator, List, Optional

import numpy as np

from dmlc_tpu_torch.data import vparse
from dmlc_tpu_torch.data.row_block import (
    INDEX_DTYPE,
    REAL_DTYPE,
    RowBlock,
    RowBlockContainer,
)
from dmlc_tpu_torch.io.input_split import InputSplit, create_input_split
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.params.parameter import Parameter, field
from dmlc_tpu_torch.params.registry import Registry
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import DMLCError, check
from dmlc_tpu_torch.utils.threaded_iter import ThreadedIter

#: parse threads a chunk is split over when the caller names none (the
#: JAX package's default)
DEFAULT_NTHREAD = 2
#: parsed blocks ThreadedParser holds ahead of its consumer (parser.h:70-126)
PREFETCH_DEPTH = 8


class Parser:
    """Streaming parser base: an iterator over RowBlocks (data.h:298-316).

    ``device`` (None means cuda) is where the parser's kernels run."""

    def __init__(self, source: InputSplit, nthread: int = DEFAULT_NTHREAD,
                 device=None):
        self._source = source
        self.device = resolve_device(device)
        self._nthread = max(1, nthread)
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=self._nthread)
            if self._nthread > 1 else None)
        self.bytes_read = 0

    def parse_chunk(self, chunk: bytes) -> RowBlockContainer:
        raise NotImplementedError

    def next_chunk(self) -> Optional[bytes]:
        chunk = self._source.next_chunk()
        if chunk is not None:
            self.bytes_read += len(chunk)
        return chunk

    def _split_lines(self, chunk: bytes, nparts: int) -> List[bytes]:
        """Split a chunk at line breaks into ~equal parts
        (text_parser.h:104-118 / BackFindEndLine :71-77); a chunk under
        4096 bytes stays whole."""
        if nparts <= 1 or len(chunk) < 4096:
            return [chunk]
        step = len(chunk) // nparts
        bounds = [0]
        for i in range(1, nparts):
            pos = chunk.rfind(b"\n", bounds[-1], i * step)
            pos2 = chunk.rfind(b"\r", bounds[-1], i * step)
            pos = max(pos, pos2)
            bounds.append(pos + 1 if pos > 0 else bounds[-1])
        bounds.append(len(chunk))
        return [chunk[bounds[i]:bounds[i + 1]] for i in range(nparts)]

    def next_block(self) -> Optional[RowBlock]:
        """Parse the next chunk into one RowBlock; None at end of data."""
        while True:
            chunk = self.next_chunk()
            if chunk is None:
                return None
            parts = self._split_lines(chunk, self._nthread)
            if self._pool is not None and len(parts) > 1:
                containers = list(self._pool.map(self.parse_chunk, parts))
            else:
                containers = [self.parse_chunk(p) for p in parts]
            merged = containers[0]
            for extra in containers[1:]:
                if len(extra):
                    merged.push_block(extra.to_block())
            if len(merged):
                return merged.to_block()
            # empty chunk (e.g. all blank lines): keep pulling

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block

    def before_first(self) -> None:
        self._source.before_first()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        self._source.close()


class LibSVMParser(Parser):
    """``label[:weight] [qid:n] index[:value]...`` (libsvm_parser.h): the
    token masks from the tokenize_boundaries kernel on the parser's
    device, the rest of the parse on the host."""

    def parse_chunk(self, chunk: bytes) -> RowBlockContainer:
        out = RowBlockContainer()
        if chunk:
            a = np.frombuffer(chunk, dtype=np.uint8)
            vparse.parse_libsvm_vector(
                chunk, out, vparse.kernel_token_masks(a, self.device))
        return out


class LibFMParser(Parser):
    """``label field:index:value`` triples (libfm_parser.h:35-90)."""

    def parse_chunk(self, chunk: bytes) -> RowBlockContainer:
        out = RowBlockContainer()
        lines = [ln for ln in chunk.splitlines() if ln.strip()]
        if not lines:
            return out
        flat: List[bytes] = []
        counts = np.empty(len(lines), dtype=np.int64)
        for i, line in enumerate(lines):
            toks = line.replace(b":", b" ").split()
            check((len(toks) - 1) % 3 == 0, "invalid libfm line: %s",
                  line[:80].decode(errors="replace"))
            counts[i] = (len(toks) - 1) // 3
            flat.extend(toks)
        values = np.asarray(flat, dtype="S").astype(np.float64)
        # row i's tokens: its label, then 3 per feature (field, index, value)
        starts = np.concatenate([[0], np.cumsum(1 + 3 * counts)[:-1]])
        feats = np.delete(values, starts).reshape(-1, 3)
        out.push_arrays(
            values[starts].astype(REAL_DTYPE),
            counts,
            feats[:, 1].astype(INDEX_DTYPE),
            value=feats[:, 2].astype(REAL_DTYPE),
            field=feats[:, 0].astype(INDEX_DTYPE),
        )
        return out


class CSVParserParam(Parameter):
    """URI args for the csv parser (csv_parser.h:22-32)."""

    format = field(str, "csv", description="File format.")
    label_column = field(
        int, -1, description="Column index that will be put into label.")
    weight_column = field(
        int, -1, description="Column index for per-row weights.")


class CSVParser(Parser):
    """Dense CSV → CSR with running column indices (csv_parser.h:63-104)."""

    def __init__(self, source: InputSplit, args: Dict[str, str] = None,
                 nthread: int = DEFAULT_NTHREAD, device=None):
        super().__init__(source, nthread, device)
        self.param = CSVParserParam()
        self.param.init(args or {}, allow_unknown=True)
        check(self.param.format == "csv", "CSVParser requires format=csv")

    def parse_chunk(self, chunk: bytes) -> RowBlockContainer:
        out = RowBlockContainer()
        table = vparse.parse_csv_vector_table(chunk)
        if table.shape[0] == 0:
            return out
        return _csv_table_to_block(table, self.param.label_column,
                                   self.param.weight_column, out)


def _csv_table_to_block(table: np.ndarray, label_col: int, weight_col: int,
                        out: RowBlockContainer) -> RowBlockContainer:
    """Split the label and weight columns out of a dense table → CSR."""
    nrows, ncols = table.shape
    keep = np.ones(ncols, dtype=bool)
    labels = np.zeros(nrows, dtype=REAL_DTYPE)
    weight = None
    if 0 <= label_col < ncols:
        labels = table[:, label_col].astype(REAL_DTYPE)
        keep[label_col] = False
    if 0 <= weight_col < ncols:
        weight = table[:, weight_col].astype(REAL_DTYPE)
        keep[weight_col] = False
    data = table[:, keep]
    nfeat = data.shape[1]
    out.push_arrays(
        labels,
        np.full(nrows, nfeat, dtype=np.int64),
        np.tile(np.arange(nfeat, dtype=INDEX_DTYPE), nrows),
        value=np.ascontiguousarray(data).reshape(-1).astype(REAL_DTYPE),
        weight=weight,
    )
    return out


def _feed_pipeline(pipe, reader, error_holder: list) -> None:
    """The remote feeder thread: ``reader.feed_into`` pushes the part's
    in-order buffers; a push blocks while the workers are behind. A
    fetch failure is put in ``error_holder`` and aborts the pipeline, so a
    consumer blocked in ``next_block`` wakes with an error; a refused push
    means the pipeline already failed, and its own error reaches the
    consumer. Module-level: the thread holds no reference to the parser,
    so an abandoned parser can still be collected."""
    from dmlc_tpu_torch.io.readahead import PushRejected

    try:
        try:
            reader.feed_into(pipe)
        except PushRejected:
            return
        try:
            pipe.push_eof()
        except DMLCError:
            return
    except BaseException as err:  # noqa: BLE001 (must reach the consumer)
        error_holder.append(err)
        try:
            pipe.push_abort()
        except Exception:
            pass


class NativePipelineParser:
    """The all-native ingest route: ``native/csrc/pipeline.cc``'s reader,
    parse workers and ordered queue, with no Python in the parse loop
    (the JAX package's ``NativePipelineParser``). The partition is the
    InputSplit's, exactly once (input_split_base.cc:30-64).

    Local files are read by the C++ reader thread (mmap when the part lies
    in one file); files on one remote filesystem are fetched by
    ``io/readahead.RemotePartitionReader`` on Python threads and pushed in.
    ``shuffle_seed >= 0`` visits a local file's 1 MB chunks in a seeded
    order, a new one each epoch (``_mix_epoch_seed``). Blocks come as
    RowBlocks over the native arrays (u32 indices and fields, i64
    offsets), or, through ``read_batch_*``, as fixed-shape batches staged
    in C++. ``device`` is where the caller's kernels run; the parse does
    not use it."""

    def __init__(self, paths: List[str], sizes: List[int], data_format: str,
                 part_index: int, num_parts: int, nthread: int = DEFAULT_NTHREAD,
                 args: Optional[Dict[str, str]] = None, remote_fs=None,
                 remote_uris=None, shuffle_seed: int = -1, device=None):
        from dmlc_tpu_torch import native

        self.device = resolve_device(device)
        self._fmt_name = data_format
        self._fmt = {
            "libsvm": native.INGEST_LIBSVM,
            "libfm": native.INGEST_LIBFM,
            "csv": native.INGEST_CSV,
            "recordio": native.INGEST_RECORDIO,
        }[data_format]
        self._open_args = (paths, sizes, part_index, num_parts, nthread)
        self._shuffle_seed = shuffle_seed
        self._epoch = 0  # advances the shuffle permutation a before_first
        self._remote_fs = remote_fs
        self._remote_uris = remote_uris
        self._csv_param = None
        if data_format == "csv":
            self._csv_param = CSVParserParam()
            self._csv_param.init(args or {}, allow_unknown=True)
        self._pipe = None
        self._feeder = None
        self._reader = None
        self._feed_error_holder: list = []
        self._bytes_read_done = 0
        self._open()

    def _open(self) -> None:
        from dmlc_tpu_torch import native

        paths, sizes, part, nparts, nthread = self._open_args
        if self._remote_fs is None:
            if self._shuffle_seed >= 0:
                # the chunk is the shuffle's unit: 1 MB chunks give a
                # ~100 MB file ~100 slots, at a small cost against 8 MB
                self._pipe = native.IngestPipeline(
                    paths, sizes, self._fmt, part, nparts, nthread=nthread,
                    chunk_bytes=1 << 20,
                    shuffle_seed=_mix_epoch_seed(self._shuffle_seed,
                                                 self._epoch))
            else:
                self._pipe = native.IngestPipeline(
                    paths, sizes, self._fmt, part, nparts, nthread=nthread)
            return
        from dmlc_tpu_torch.io import readahead

        reader = readahead.RemotePartitionReader(
            self._remote_fs, list(zip(self._remote_uris, sizes)), part, nparts,
            range_bytes=readahead.DEFAULT_RANGE_BYTES,
            connections=readahead.DEFAULT_CONNECTIONS,
            record_format=("recordio" if self._fmt_name == "recordio"
                           else "text"))
        self._pipe = native.IngestPipeline(None, None, self._fmt, 0, 1,
                                           nthread=nthread, push=True)
        # the feeder holds no reference to this parser; errors travel
        # through the shared holder
        self._feed_error_holder = []
        self._reader = reader
        self._feeder = threading.Thread(
            target=_feed_pipeline,
            args=(self._pipe, reader, self._feed_error_holder),
            name="remote-ingest-feeder", daemon=True)
        self._feeder.start()

    def _feed_failed(self, err: DMLCError):
        holder = self._feed_error_holder
        if holder:
            return DMLCError(f"remote ingest feeder failed: {holder[0]}")
        return err

    @property
    def bytes_read(self) -> int:
        return self._bytes_read_done + (
            self._pipe.bytes_read if self._pipe is not None else 0)

    def next_block(self) -> Optional[RowBlock]:
        from dmlc_tpu_torch import native

        while True:
            try:
                parsed = self._pipe.next_block()
            except DMLCError as err:
                raise self._feed_failed(err) from err
            if parsed is None:
                return None
            if self._fmt == native.INGEST_CSV:
                table = parsed["table"]
                if table.shape[0] == 0:
                    continue
                out = RowBlockContainer()
                _csv_table_to_block(table, self._csv_param.label_column,
                                    self._csv_param.weight_column, out)
                return out.to_block()
            if len(parsed["labels"]) == 0:
                continue
            has_value = (self._fmt == native.INGEST_LIBFM
                         or parsed["flags"] & native.HAS_VALUE)
            return RowBlock(
                offset=parsed["offsets"], label=parsed["labels"],
                index=parsed["indices"],
                value=parsed["values"] if has_value else None,
                weight=parsed.get("weights"), qid=parsed.get("qids"),
                field=parsed.get("fields"))

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block

    # ---- the fixed-shape batch route (the feed's host stage) -----------
    # re-batching to batch_size rows and the dense / padded-COO write run
    # in C++ (pipeline.cc StageBatch / FetchBatch*): one ctypes call a
    # batch. libsvm, libfm and recordio (csv has its table layout).

    @property
    def supports_batch_fetch(self) -> bool:
        from dmlc_tpu_torch import native

        return self._fmt in (native.INGEST_LIBSVM, native.INGEST_LIBFM,
                             native.INGEST_RECORDIO)

    def stage_batch(self, batch_size: int):
        """Stage the next batch → (rows, nnz), None at the end of data."""
        try:
            return self._pipe.stage_batch(batch_size)
        except DMLCError as err:
            raise self._feed_failed(err) from err

    def fetch_batch_dense(self, batch_size: int, num_features: int, **out):
        """Consume the staged batch as ``IngestPipeline.fetch_batch_dense``
        does, into the arrays ``out`` names when given."""
        return self._pipe.fetch_batch_dense(batch_size, num_features, **out)

    def fetch_batch_coo(self, batch_size: int, nnz_bucket: int, **out):
        """Consume the staged batch as ``IngestPipeline.fetch_batch_coo``
        does, into the arrays ``out`` names when given."""
        return self._pipe.fetch_batch_coo(batch_size, nnz_bucket, **out)

    def read_batch_dense(self, batch_size: int, num_features: int):
        """→ (x [batch, F] f32, labels, weights, valid rows), None at the
        end of data; a short last batch is zero-padded (weight 0)."""
        if self.stage_batch(batch_size) is None:
            return None
        return self._pipe.fetch_batch_dense(batch_size, num_features)

    def read_batch_coo(self, batch_size: int, nnz_bucket=None):
        """→ ``device/csr.DeviceCSRBatch``, None at the end of data; the
        entry bucket is ``nnz_bucket`` when given, else ``round_up_bucket``
        of the batch's nnz. The per-entry row ids the C++ also writes are
        dropped, as the port's batch carries CSR offsets only."""
        from dmlc_tpu_torch.device.csr import DeviceCSRBatch, _bucket

        staged = self.stage_batch(batch_size)
        if staged is None:
            return None
        nnz = staged[1]
        labels, weights, indices, values, _row_ids, offsets, rows = (
            self._pipe.fetch_batch_coo(batch_size, _bucket(nnz, nnz_bucket)))
        return DeviceCSRBatch(
            labels=labels, weights=weights, indices=indices, values=values,
            offsets=offsets, num_rows=rows, num_nonzero=nnz)

    def read_batch_coo_sharded(self, batch_size: int, num_shards: int,
                               nnz_bucket=None):
        """→ ``device/csr.ShardedCSRBatch`` (per-shard entry sections,
        local row ids), None at the end of data; the bucket is
        ``round_up_bucket`` of the largest shard's nnz unless fixed."""
        from dmlc_tpu_torch.device.csr import ShardedCSRBatch, _bucket

        staged = self.stage_batch(batch_size)
        if staged is None:
            return None
        nnz = staged[1]
        bucket = (nnz_bucket if nnz_bucket is not None else _bucket(
            self._pipe.staged_max_shard_nnz(batch_size, num_shards), None))
        labels, weights, indices, values, row_ids, offsets, rows = (
            self._pipe.fetch_batch_coo_sharded(batch_size, num_shards,
                                               bucket))
        return ShardedCSRBatch(
            labels=labels, weights=weights, indices=indices, values=values,
            row_ids=row_ids, offsets=offsets, num_rows=rows,
            num_nonzero=nnz, num_shards=num_shards, nnz_bucket=bucket)

    def stats(self) -> Optional[dict]:
        """The pipeline's stage counters, None once closed."""
        return self._pipe.stats() if self._pipe is not None else None

    def _teardown(self) -> None:
        if self._pipe is None:
            return
        if self._feeder is not None:
            # abort first: a feeder blocked in push() wakes with an error
            # and cancelled fetches stop at their next check, both before
            # the native handle is freed
            self._reader.cancel()
            self._pipe.push_abort()
            self._feeder.join()
            self._feeder = None
            self._reader = None
        self._bytes_read_done += self._pipe.bytes_read
        self._pipe.close()
        self._pipe = None

    def before_first(self) -> None:
        self._teardown()
        self._epoch += 1
        self._open()

    def close(self) -> None:
        self._teardown()

    def __del__(self):
        # the feeder is joined before the native handle is freed
        try:
            self._teardown()
        except Exception:
            pass


def _native_local_files(spec: URISpec):
    """The dataset's files when they are listable and all local, else
    None. Loads the native library first: a failed build raises."""
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.io.filesystem import list_split_files

    native.get_lib()
    try:
        files = list_split_files(spec.uri)
    except Exception:
        return None
    if not files or not all(info.path.protocol in ("file://", "")
                            for info in files):
        return None
    return files


def _try_native_cached(spec: URISpec, data_format: str, part_index: int,
                       num_parts: int, nthread: int,
                       device) -> Optional[NativePipelineParser]:
    """``#cachefile`` on a local libsvm uri: the reference's DiskRowIter
    contract (build the cache, then stream it back each epoch,
    disk_row_iter.h:95-141) with the cache in the row-group RecordIO layout
    (data/rowrec.py) at ``<cachefile>.rowrec``. The first parser parses
    its part through the native pipeline and writes the row groups; every
    later epoch, and every later parser over the same uri, reads the cache
    through the native recordio route. A sidecar ``.meta`` holds the
    source's signature (bytes, newest mtime in ns, part), so a changed
    source rebuilds. libsvm only: libfm's fields are not in the layout,
    csv has its table, recordio is binary already."""
    if data_format != "libsvm":
        return None
    files = _native_local_files(spec)
    if files is None:
        return None
    # a path apart from the user's name: the Python stack's
    # CachedInputSplit keeps its raw chunk frames at that name
    cache = spec.cache_file + ".rowrec"
    meta_path = cache + ".meta"
    # unique a writer (threads of one process share a pid); the last
    # atomic replace wins
    tmp_tag = ".tmp.%d.%s" % (os.getpid(), uuid.uuid4().hex[:8])
    try:
        sig = {
            "format": "rowrec-v1",
            "src_bytes": int(sum(info.size for info in files)),
            "src_mtime_ns": max(os.stat(info.path.name).st_mtime_ns
                                for info in files),
            "part": part_index,
            "num_parts": num_parts,
        }
        valid = False
        if os.path.exists(cache) and os.path.exists(meta_path):
            try:
                with open(meta_path) as fh:
                    valid = json.load(fh) == sig
            except (OSError, ValueError):
                valid = False
        if not valid:
            from dmlc_tpu_torch.data.rowrec import RowGroupWriter
            from dmlc_tpu_torch.io.filesystem import create_stream

            base = NativePipelineParser(
                [info.path.name for info in files],
                [info.size for info in files], "libsvm", part_index,
                num_parts, nthread=nthread, args=spec.args, device=device)
            try:
                with create_stream(cache + tmp_tag, "w") as out:
                    writer = RowGroupWriter(out, rows_per_group=4096)
                    for block in base:
                        writer.write_block(block)
            finally:
                base.close()
            os.replace(cache + tmp_tag, cache)
            with open(meta_path + tmp_tag, "w") as fh:
                json.dump(sig, fh)
            os.replace(meta_path + tmp_tag, meta_path)
        # the cache holds exactly this part's rows: served whole, and
        # shuffled like any one local file
        return NativePipelineParser(
            [cache], [os.path.getsize(cache)], "recordio", 0, 1,
            nthread=nthread, args=spec.args,
            shuffle_seed=_shuffle_seed_arg(spec), device=device)
    except Exception:
        for tmp in (cache + tmp_tag, meta_path + tmp_tag):
            try:
                os.remove(tmp)
            except OSError:
                pass
        return None


def _try_native_pipeline(spec: URISpec, data_format: str, part_index: int,
                         num_parts: int, nthread: int,
                         device) -> Optional[NativePipelineParser]:
    """The native route when the dataset allows it (the rules in the
    module docstring), else None for the Python stack. Loads the native
    library first: a failed build raises."""
    if data_format not in ("libsvm", "libfm", "csv", "recordio"):
        return None
    if spec.cache_file:
        return _try_native_cached(spec, data_format, part_index, num_parts,
                                  nthread, device)
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.io.filesystem import get_filesystem, list_split_files

    native.get_lib()
    try:
        files = list_split_files(spec.uri)
    except Exception:
        return None
    local = all(info.path.protocol in ("file://", "") for info in files)
    sizes = [info.size for info in files]
    shuffle_seed = _shuffle_seed_arg(spec)
    try:
        if local:
            return NativePipelineParser(
                [info.path.name for info in files], sizes, data_format,
                part_index, num_parts, nthread=nthread, args=spec.args,
                shuffle_seed=shuffle_seed, device=device)
        if shuffle_seed >= 0:
            # the push route streams in order: InputSplitShuffle takes it
            return None
        keys = {(info.path.protocol, info.path.host) for info in files}
        if len(keys) != 1 or any(size <= 0 for size in sizes):
            return None
        return NativePipelineParser(
            [], sizes, data_format, part_index, num_parts, nthread=nthread,
            args=spec.args, remote_fs=get_filesystem(files[0].path),
            remote_uris=[info.path for info in files], device=device)
    except DMLCError:
        # ingest_open refused (a chunk shuffle over several files)
        return None


class ThreadedParser:
    """Background-thread parse prefetch, :data:`PREFETCH_DEPTH` blocks
    ahead (parser.h:70-126)."""

    def __init__(self, base: Parser):
        self._base = base
        self._iter = ThreadedIter(self._produce, max_capacity=PREFETCH_DEPTH,
                                  name="threaded-parser")

    def _produce(self) -> Iterator[RowBlock]:
        while True:
            block = self._base.next_block()
            if block is None:
                return
            yield block

    @property
    def device(self):
        return self._base.device

    @property
    def bytes_read(self) -> int:
        return self._base.bytes_read

    def next_block(self) -> Optional[RowBlock]:
        return self._iter.next()

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block

    def before_first(self) -> None:
        self._iter.close()
        self._base.before_first()
        self._iter.before_first()

    def close(self) -> None:
        self._iter.close()
        self._base.close()


class ThreadedShardParser(ThreadedParser):
    """A :class:`ThreadedParser` over an ``io/shard.ShardParser`` that
    passes its read plan through, so that ``fit_uri(resume=True)``
    restores it: ``snapshot_state``, and ``restore_state``, which stops
    the prefetch, moves the plan and starts the prefetch again at the
    restored epoch."""

    def snapshot_state(self) -> dict:
        return self._base.snapshot_state()

    def restore_state(self, st: dict) -> None:
        self._iter.close()
        self._base.restore_state(st)
        self._iter.before_first()


def _mix_epoch_seed(seed: int, epoch: int) -> int:
    """(base seed, epoch) -> a decorrelated seed for that epoch (the
    splitmix64 finalizer, masked to a non-negative int64): plain
    ``seed + epoch`` would give adjacent seeds the same permutations one
    epoch apart."""
    mask = (1 << 64) - 1
    x = (seed * 0x9E3779B97F4A7C15 + epoch + 1) & mask
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & mask
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & mask
    x ^= x >> 31
    return x & ((1 << 62) - 1)


def _shuffle_seed_arg(spec: URISpec) -> int:
    """The ``shuffle_chunks=SEED`` uri arg as an int, -1 when absent."""
    raw = spec.args.get("shuffle_chunks")
    if raw is None:
        return -1
    try:
        seed = int(raw)
    except ValueError:
        raise DMLCError(
            f"shuffle_chunks must be an integer seed, got {raw!r}") from None
    check(seed >= 0, "shuffle_chunks seed must be >= 0, got %d", seed)
    return seed


# ---------------------------------------------------------------------------
# Registry + factory (src/data.cc:62-85,150-158; data.h:317-350)
# ---------------------------------------------------------------------------

PARSER_REGISTRY: Registry = Registry.get("parser")


def register_parser(name: str, factory=None):
    """DMLC_REGISTER_DATA_PARSER: ``factory(source, args, nthread,
    device)`` → a Parser, where ``source`` is the part's InputSplit (text
    unless ``_SPLIT_TYPE`` names another record type),
    ``args`` the uri's ``?key=value`` args and ``device`` a resolved
    ``torch.device``. Usable as a decorator."""
    if factory is None:
        return PARSER_REGISTRY.register(name)
    return PARSER_REGISTRY.register(name, factory)


register_parser("libsvm", lambda source, args, nthread, device:
                LibSVMParser(source, nthread, device))
register_parser("libfm", lambda source, args, nthread, device:
                LibFMParser(source, nthread, device))
register_parser("csv", lambda source, args, nthread, device:
                CSVParser(source, args, nthread, device))


def _make_recordio_parser(source, args, nthread, device):
    from dmlc_tpu_torch.data.rowrec import RecordIORowParser

    return RecordIORowParser(source, args, nthread, device)


register_parser("recordio", _make_recordio_parser)

# the InputSplit record type of a format ("text" unless named here): the
# recordio parser reads whole framed records, not lines
_SPLIT_TYPE = {"recordio": "recordio"}


def create_parser(uri: str, part_index: int = 0, num_parts: int = 1,
                  data_format: str = "auto", nthread: Optional[int] = None,
                  threaded: bool = True, device=None):
    """Parser<I>::Create (src/data.cc:62-85,132-138).

    "auto" resolves through the ``format=`` uri arg, else ``shard`` for a
    ``.dtsh`` uri, else libsvm. ``nthread=None`` means
    :data:`DEFAULT_NTHREAD`. ``threaded=True`` wraps a :class:`Parser` in
    a ``PipelinedParser`` over ``nthread`` workers (each chunk parsed
    whole by one worker, blocks delivered in chunk order), a shard parser
    in a :class:`ThreadedShardParser` and any other parser in a
    :class:`ThreadedParser`, as the JAX package does, unless the native
    route takes the uri first (the rules in the module docstring).
    ``device`` (None means cuda) is where the parser's kernels run. On the
    Python stack a ``#cachefile`` uri reads through ``CachedInputSplit``
    and ``shuffle_chunks=SEED`` through ``InputSplitShuffle`` (16
    sub-splits).
    """
    device = resolve_device(device)
    nthread = DEFAULT_NTHREAD if nthread is None else nthread
    spec = URISpec(uri, part_index, num_parts)
    args = spec.args
    if data_format == "auto":
        data_format = args.get("format")
        if data_format is None:
            from dmlc_tpu_torch.io.shard import is_shard_uri

            data_format = "shard" if is_shard_uri(spec.uri) else "libsvm"
    if data_format == "shard":
        # baked shards: no parse stage to fan out; the ShardParser takes
        # its own audit digests and shard signature
        from dmlc_tpu_torch.io.shard import ShardParser

        shard = ShardParser(spec.uri, part_index, num_parts, args=args,
                            nthread=nthread, device=device)
        return ThreadedShardParser(shard) if threaded else shard
    entry = PARSER_REGISTRY.find(data_format)
    if entry is None:
        raise DMLCError(
            f"unknown data format {data_format!r}; known: "
            f"{PARSER_REGISTRY.list_all_names()}")
    # stamp the determinism auditor's shard signature so digest chains
    # only compare across runs and ranks reading the same (uri, part)
    # slice (obs/audit.py; the no-op child when DMLC_TPU_AUDIT is off)
    from dmlc_tpu_torch.obs import audit

    audit.auditor().set_shard(uri, part_index, num_parts)
    if threaded and not audit.auditor().enabled:
        # the native route has no io_read / parse digest points, so an
        # armed audit keeps the Python stack, as in the JAX package
        native_parser = _try_native_pipeline(spec, data_format, part_index,
                                             num_parts, nthread, device)
        if native_parser is not None:
            return native_parser
    shuffle_seed = _shuffle_seed_arg(spec)
    source = create_input_split(
        uri, part_index, num_parts, _SPLIT_TYPE.get(data_format, "text"),
        num_shuffle_parts=16 if shuffle_seed >= 0 else 0,
        seed=max(shuffle_seed, 0))
    base = entry(source, args, nthread, device)
    if not threaded:
        return base
    if isinstance(base, Parser):
        # deferred: data/pipeline.py imports this module
        from dmlc_tpu_torch.data.pipeline import PipelinedParser

        return PipelinedParser(base, nthread=nthread)
    return ThreadedParser(base)

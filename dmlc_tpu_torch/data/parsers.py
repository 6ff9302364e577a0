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

Every parser takes ``device`` (None means cuda, see utils/device.py).
``create_parser`` stamps the audit's shard signature
(``obs.audit.Auditor.set_shard``; a ``ShardParser`` stamps its own); the
chunk and parse digests are taken in ``data/pipeline.PipelinedParser``.
The JAX package's native C++ core and its all-native routes (the native
pipeline, the row-group ``#cachefile`` cache) are not ported, and it has
knobs (``DMLC_TPU_PARSE_BACKEND``, ``DMLC_TPU_NTHREAD``) that have no
counterpart here: this is its Python stack (``DMLC_TPU_NATIVE=0``).
"""

from __future__ import annotations

import concurrent.futures
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
    :class:`ThreadedParser`, as the JAX package does. ``device`` (None
    means cuda) is where the parser's kernels run. A ``#cachefile`` uri
    reads through ``CachedInputSplit``; ``shuffle_chunks=SEED`` through
    ``InputSplitShuffle`` (16 sub-splits).
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

"""Pre-tokenized columnar shards (``.dtsh``): text parsed once by ``bake``,
every later epoch read as typed segments, the port of
``dmlc_tpu/io/shard.py``. A shard holds the parser's RowBlock arrays, so
a read is ``np.frombuffer`` slices (views of one mmap in mmap mode) and
no tokenizer runs.

File layout (little-endian), byte for byte the JAX package's::

    MAGIC "DTSHARD1"                                      8 bytes
    header <HHI>: version, reserved, rows_per_window      8 bytes
    window 0                                              |
      <BBHIQ>: tag 'W', flags, reserved, nrows, nnz       | data
      label    f32[nrows]                                 |
      weight   f32[nrows]      (flags & HAS_WEIGHT)       |
      qid      i64[nrows]      (flags & HAS_QID)          |
      row_nnz  u32[nrows]                                 |
      index    u32[nnz]                                   |
      value    f32[nnz]        (flags & HAS_VALUE)        |
      field    u32[nnz]        (flags & HAS_FIELD)        |
    window 1 ... window N-1                               |
    footer                                                |
      index    <QQQI>[N]: offset, nbytes, nnz, nrows      | 28 B each
      meta     <QQIHH>: rows, nnz, nwindows, ver, flags   | 24 B
    tail <IQ>: crc32(footer), footer_len                  12 bytes
    MAGIC "DTSHARD1"                                      8 bytes

The footer indexes the windows; each decodes alone, which is what the
shuffle permutes and what the determinism auditor digests (io_read: the
window's raw bytes; parse: the decoded block). The crc32 and the
trailing magic make a torn or overwritten file fail with a
:class:`DMLCError` before any row is served; the ``shard.read``
faultpoint injects a read fault there.

Shuffle: a seed >= 0 (the ``shuffle_chunks`` uri arg, else
``DMLC_TPU_SHUFFLE``, default -1: off) permutes the global window table,
all windows of all files, in units of ``DMLC_TPU_SHUFFLE_WINDOW``
consecutive windows (default 1) with numpy's PCG64 seeded by the
splitmix64 mix of (seed, epoch); rank ``k`` of ``n`` reads its
contiguous slice of that order. The order depends on (seed, epoch) only,
never on the world size, so re-sharding and resume replay it.
``DMLC_TPU_SHARD_MMAP`` (default on; 0: seek and read a window at a
time) picks the read mode. These three names are read here, where they
are used; none selects a kernel or a device.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.data.row_block import (
    INDEX_DTYPE,
    REAL_DTYPE,
    RowBlock,
    RowBlockContainer,
)
from dmlc_tpu_torch.params.env import get_env
from dmlc_tpu_torch.resilience import faultpoint
from dmlc_tpu_torch.utils.logging import DMLCError, check

MAGIC = b"DTSHARD1"
SHARD_FORMAT_VERSION = 1
SHARD_SUFFIX = ".dtsh"
DEFAULT_ROWS_PER_WINDOW = 4096

_HEADER = struct.Struct("<HHI")  # version, reserved, rows_per_window
_WIN = struct.Struct("<BBHIQ")  # tag, flags, reserved, nrows, nnz
_IDX = struct.Struct("<QQQI")  # offset, nbytes, nnz, nrows
_META = struct.Struct("<QQIHH")  # rows, nnz, nwindows, version, flags
_TAIL = struct.Struct("<IQ")  # crc32(footer), footer_len

_WIN_TAG = 0x57  # 'W'
HAS_WEIGHT = 1
HAS_QID = 2
HAS_VALUE = 4
HAS_FIELD = 8

# the footer index as numpy records, one a window
_IDX_DTYPE = np.dtype(
    [("offset", "<u8"), ("nbytes", "<u8"), ("nnz", "<u8"), ("nrows", "<u4")])


def env_shuffle_seed() -> int:
    """``DMLC_TPU_SHUFFLE``: the shard shuffle's seed, -1 (off) when
    unset."""
    return int(get_env("DMLC_TPU_SHUFFLE", -1))


def env_shuffle_window() -> int:
    """``DMLC_TPU_SHUFFLE_WINDOW``: consecutive windows the shuffle moves
    together (default 1, at least 1)."""
    return max(1, get_env("DMLC_TPU_SHUFFLE_WINDOW", 1))


def env_shard_mmap() -> bool:
    """``DMLC_TPU_SHARD_MMAP``: read shards through one mmap (default
    on)."""
    return bool(get_env("DMLC_TPU_SHARD_MMAP", True))


def _local_path(uri: str) -> str:
    """The path of a shard uri (shards are local files)."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    return uri


def is_shard_uri(uri: str) -> bool:
    """Whether ``uri`` names shard data by its ``.dtsh`` suffix."""
    return _local_path(str(uri)).split("?", 1)[0].endswith(SHARD_SUFFIX)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class ShardWriter:
    """Write RowBlocks to one ``.dtsh`` file, in windows of
    ``rows_per_window`` rows whatever the incoming blocks' sizes (the
    window is the shuffle and audit unit, so it is a bake parameter).
    ``close`` seals the footer; a file never closed has no valid tail and
    every reader refuses it."""

    def __init__(self, path: str,
                 rows_per_window: int = DEFAULT_ROWS_PER_WINDOW):
        self.path = _local_path(path)
        self.rows_per_window = max(1, int(rows_per_window))
        self._file = open(self.path, "wb")
        self._file.write(MAGIC)
        self._file.write(_HEADER.pack(SHARD_FORMAT_VERSION, 0,
                                      self.rows_per_window))
        self._index: List[Tuple[int, int, int, int]] = []
        self._pending = RowBlockContainer()
        self._union_flags = 0
        self.rows_written = 0
        self.nnz_written = 0
        self._closed = False

    def write_block(self, block) -> None:
        """Append a RowBlock (or anything with ``to_block``)."""
        if hasattr(block, "to_block") and not isinstance(block, RowBlock):
            block = block.to_block()
        self._pending.push_block(block)
        while self._pending.size >= self.rows_per_window:
            whole = self._pending.to_block()
            n = len(whole)
            w = self.rows_per_window
            full = (n // w) * w
            for lo in range(0, full, w):
                self._emit_window(whole.slice(lo, lo + w))
            self._pending = RowBlockContainer()
            if full < n:
                self._pending.push_block(whole.slice(full, n))

    def _emit_window(self, block: RowBlock) -> None:
        nrows = len(block)
        nnz = block.num_nonzero
        flags = 0
        segs: List[np.ndarray] = [
            np.ascontiguousarray(block.label, dtype=REAL_DTYPE)]
        if block.weight is not None:
            flags |= HAS_WEIGHT
            segs.append(np.ascontiguousarray(block.weight, dtype=REAL_DTYPE))
        if block.qid is not None:
            flags |= HAS_QID
            segs.append(np.ascontiguousarray(block.qid, dtype=np.int64))
        segs.append(np.ascontiguousarray(np.diff(block.offset),
                                         dtype=np.uint32))
        segs.append(np.ascontiguousarray(block.index, dtype=np.uint32))
        if block.value is not None:
            flags |= HAS_VALUE
            segs.append(np.ascontiguousarray(block.value, dtype=REAL_DTYPE))
        if block.field is not None:
            flags |= HAS_FIELD
            segs.append(np.ascontiguousarray(block.field, dtype=np.uint32))
        offset = self._file.tell()
        self._file.write(_WIN.pack(_WIN_TAG, flags, 0, nrows, nnz))
        for seg in segs:
            self._file.write(seg.tobytes())
        nbytes = self._file.tell() - offset
        self._index.append((offset, nbytes, nnz, nrows))
        self._union_flags |= flags
        self.rows_written += nrows
        self.nnz_written += nnz

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._pending.size:
            self._emit_window(self._pending.to_block())
            self._pending = RowBlockContainer()
        footer = b"".join(_IDX.pack(*entry) for entry in self._index)
        footer += _META.pack(self.rows_written, self.nnz_written,
                             len(self._index), SHARD_FORMAT_VERSION,
                             self._union_flags)
        self._file.write(footer)
        self._file.write(_TAIL.pack(zlib.crc32(footer) & 0xFFFFFFFF,
                                    len(footer)))
        self._file.write(MAGIC)
        self._file.close()

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class ShardReader:
    """Random-access window reads of one sealed shard file.

    With ``use_mmap`` (None: ``DMLC_TPU_SHARD_MMAP``) the file is mapped
    once and windows decode as ``np.frombuffer`` views of the map;
    otherwise each window is sought and read. Both check the leading
    magic and the crc32 of the footer before the first row, and each
    window's header against the footer, raising :class:`DMLCError` for a
    torn footer, a truncated segment or a stale index. A view handed out
    keeps the map alive after ``close``; the device feed copies rows into
    its own staging before the host-to-device copy."""

    def __init__(self, path: str, use_mmap: Optional[bool] = None):
        self.path = _local_path(path)
        self._mmap_wanted = (env_shard_mmap() if use_mmap is None
                             else bool(use_mmap))
        self._file = open(self.path, "rb")
        self._mm: Optional[mmap.mmap] = None
        try:
            self._load_footer()
        except BaseException:
            self._file.close()
            raise
        if self._mmap_wanted:
            try:
                self._mm = mmap.mmap(self._file.fileno(), 0,
                                     access=mmap.ACCESS_READ)
            except (ValueError, OSError):  # empty or unmappable: seek path
                self._mm = None

    # ---- footer ---------------------------------------------------------
    def _fail(self, why: str) -> None:
        raise DMLCError("bad shard %s: %s" % (self.path, why))

    def _load_footer(self) -> None:
        # an injected fault here reads as a transient read error; real
        # corruption below raises DMLCError
        faultpoint("shard.read")
        size = os.fstat(self._file.fileno()).st_size
        head_len = len(MAGIC) + _HEADER.size
        tail_len = _TAIL.size + len(MAGIC)
        if size < head_len + tail_len:
            self._fail("file too short (%d bytes)" % size)
        self._file.seek(0)
        if self._file.read(len(MAGIC)) != MAGIC:
            self._fail("leading magic mismatch")
        version, _, self.rows_per_window = _HEADER.unpack(
            self._file.read(_HEADER.size))
        if version != SHARD_FORMAT_VERSION:
            self._fail("unsupported version %d" % version)
        self._file.seek(size - tail_len)
        crc, footer_len = _TAIL.unpack(self._file.read(_TAIL.size))
        if self._file.read(len(MAGIC)) != MAGIC:
            self._fail("trailing magic mismatch (torn or unsealed write)")
        if footer_len > size - head_len - tail_len:
            self._fail("footer length %d exceeds file" % footer_len)
        self._file.seek(size - tail_len - footer_len)
        footer = self._file.read(footer_len)
        if (zlib.crc32(footer) & 0xFFFFFFFF) != crc:
            self._fail("footer crc mismatch (torn write)")
        if (footer_len - _META.size) % _IDX.size:
            self._fail("footer size %d not index-aligned" % footer_len)
        (self.num_rows, self.num_nonzero, nwin, meta_ver,
         self.union_flags) = _META.unpack(footer[footer_len - _META.size:])
        if meta_ver != version:
            self._fail("meta/header version mismatch")
        if nwin != (footer_len - _META.size) // _IDX.size:
            self._fail("window count disagrees with index size")
        self._index = np.frombuffer(footer, dtype=_IDX_DTYPE, count=nwin)
        self.footer_crc = int(crc)
        data_end = size - tail_len - footer_len
        if nwin:
            last = self._index[nwin - 1]
            if int(last["offset"]) + int(last["nbytes"]) != data_end:
                self._fail("index does not cover the data section")

    @property
    def num_windows(self) -> int:
        return len(self._index)

    def window_rows(self, i: int) -> int:
        return int(self._index[i]["nrows"])

    def window_nbytes(self, i: int) -> int:
        return int(self._index[i]["nbytes"])

    # ---- window reads ---------------------------------------------------
    def window_bytes(self, i: int):
        """The encoded bytes of window ``i`` (a memoryview of the map in
        mmap mode): what the audit's io_read digest covers."""
        faultpoint("shard.read")
        ent = self._index[i]
        off, n = int(ent["offset"]), int(ent["nbytes"])
        if self._mm is not None:
            return memoryview(self._mm)[off:off + n]
        self._file.seek(off)
        buf = self._file.read(n)
        if len(buf) != n:
            self._fail("truncated window %d (%d of %d bytes)"
                       % (i, len(buf), n))
        return buf

    def read_window(self, i: int, raw=None) -> RowBlock:
        """Decode window ``i``; ``raw`` is its bytes when already read
        (:meth:`window_bytes`)."""
        ent = self._index[i]
        if raw is None:
            raw = self.window_bytes(i)
        tag, flags, _, nrows, nnz = _WIN.unpack_from(raw, 0)
        if tag != _WIN_TAG:
            self._fail("window %d tag %#x (index/data skew)" % (i, tag))
        if nrows != int(ent["nrows"]) or nnz != int(ent["nnz"]):
            self._fail("window %d header disagrees with footer index" % i)
        pos = _WIN.size
        need = _WIN.size + 8 * nrows + 4 * nnz  # label + row_nnz + index
        if flags & HAS_WEIGHT:
            need += 4 * nrows
        if flags & HAS_QID:
            need += 8 * nrows
        if flags & HAS_VALUE:
            need += 4 * nnz
        if flags & HAS_FIELD:
            need += 4 * nnz
        if len(raw) != need:
            self._fail("window %d is %d bytes, segments need %d (truncated)"
                       % (i, len(raw), need))

        def seg(dtype, count):
            nonlocal pos
            a = np.frombuffer(raw, dtype=dtype, count=count, offset=pos)
            pos += a.nbytes
            return a

        label = seg(REAL_DTYPE, nrows)
        weight = seg(REAL_DTYPE, nrows) if flags & HAS_WEIGHT else None
        qid = seg(np.int64, nrows) if flags & HAS_QID else None
        row_nnz = seg(np.uint32, nrows)
        index = seg(INDEX_DTYPE, nnz)
        value = seg(REAL_DTYPE, nnz) if flags & HAS_VALUE else None
        field = seg(np.uint32, nnz) if flags & HAS_FIELD else None
        offset = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(row_nnz, out=offset[1:])
        if int(offset[-1]) != nnz:
            self._fail("window %d row_nnz sums to %d, header says %d"
                       % (i, int(offset[-1]), nnz))
        return RowBlock(offset=offset, label=label, index=index, value=value,
                        weight=weight, qid=qid, field=field)

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass  # views still exported keep the map alive until freed
            self._mm = None
        self._file.close()

    def __enter__(self) -> "ShardReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# parser: shard files -> RowBlocks, with the windowed global shuffle
# ---------------------------------------------------------------------------


def _epoch_mixed_seed(seed: int, epoch: int) -> int:
    # the splitmix64 mix of (seed, epoch), shared with data/parsers.py
    from dmlc_tpu_torch.data.parsers import _mix_epoch_seed

    return _mix_epoch_seed(seed, epoch)


class ShardParser:
    """A parser over baked shards (one file, a directory or a regex, as
    ``io/input_split.list_split_files`` resolves them). Each
    ``next_block`` returns one window, with the io_read and parse spans,
    the chunk flow and the audit digests the text pipeline gives a chunk,
    so the feed and the audit read it as any other parser's blocks.

    Shuffle (see the module docstring): construction is epoch 0, each
    ``before_first`` the next epoch, and ``reset_partition`` re-slices the
    current epoch's order. With shuffle armed the audit's shard signature
    is salted with the epoch's mixed seed: each epoch's chains compare
    only with the same epoch's (across ranks and restarts).
    ``snapshot_state`` / ``restore_state`` carry (seed, window, epoch) in
    a job snapshot; a restore starts the epoch after the snapshotted
    one."""

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 args: Optional[Dict] = None, nthread: Optional[int] = None,
                 seed: Optional[int] = None,
                 shuffle_window: Optional[int] = None,
                 use_mmap: Optional[bool] = None, device=None):
        from dmlc_tpu_torch.io.filesystem import list_split_files
        from dmlc_tpu_torch.obs import audit

        del nthread  # windows decode as frombuffer slices
        # the reader runs on the host and launches no kernel: ``device``
        # (create_parser's, resolved there) is only carried for the
        # parser interface
        self.device = device
        self.uri = str(uri)
        args = dict(args or {})
        if seed is None:
            raw = args.get("shuffle_chunks")
            seed = int(raw) if raw is not None else env_shuffle_seed()
        self._seed = int(seed)
        self._unit = max(1, int(shuffle_window) if shuffle_window is not None
                         else env_shuffle_window())
        infos = list_split_files(_local_path(self.uri))
        for info in infos:
            # shards are local files: a remote uri lists, then refuses
            check(info.path.protocol == "file://",
                  "shard reader requires local files, got %s",
                  info.path.protocol)
        paths = sorted(info.path.name for info in infos)
        self._readers: List[ShardReader] = []
        try:
            for p in paths:
                self._readers.append(ShardReader(p, use_mmap=use_mmap))
        except BaseException:
            for rd in self._readers:
                rd.close()
            raise
        # the global window table in (file, window) order: what the
        # shuffle permutes and the parts slice
        self._table: List[Tuple[int, int]] = [
            (f, w) for f, rd in enumerate(self._readers)
            for w in range(rd.num_windows)]
        self.num_rows = sum(rd.num_rows for rd in self._readers)
        self._part = int(part_index)
        self._nparts = max(1, int(num_parts))
        self._epoch = 0
        self._seq = 0
        self._epoch_base = 0
        self._audit = audit.auditor()
        self.bytes_read = 0
        self._order: np.ndarray = np.empty(0, dtype=np.int64)
        self._pos = 0
        self._closed = False
        self._reorder()

    # ---- order ----------------------------------------------------------
    def _global_order(self) -> np.ndarray:
        nwin = len(self._table)
        if self._seed < 0 or nwin == 0:
            return np.arange(nwin, dtype=np.int64)
        mixed = _epoch_mixed_seed(self._seed, self._epoch)
        rng = np.random.Generator(np.random.PCG64(mixed))
        nunits = -(-nwin // self._unit)
        starts = rng.permutation(nunits) * self._unit
        return np.concatenate([
            np.arange(s, min(s + self._unit, nwin), dtype=np.int64)
            for s in starts])

    def _reorder(self) -> None:
        order = self._global_order()
        lo = self._part * len(order) // self._nparts
        hi = (self._part + 1) * len(order) // self._nparts
        self._order = order[lo:hi]
        self._pos = 0
        self._stamp_audit()

    def _stamp_audit(self) -> None:
        if not self._audit.enabled:
            return
        sig_uri = self.uri
        if self._seed >= 0:
            # a reshuffled epoch is another read plan: its own chain domain
            sig_uri = "%s#shuffle-%x" % (
                self.uri, _epoch_mixed_seed(self._seed, self._epoch))
        self._audit.set_shard(sig_uri, self._part, self._nparts)

    # ---- parser surface -------------------------------------------------
    def next_block(self) -> Optional[RowBlock]:
        check(not self._closed, "shard parser is closed")
        if self._pos >= len(self._order):
            return None
        fidx, widx = self._table[int(self._order[self._pos])]
        reader = self._readers[fidx]
        seq = self._seq
        fid = obs.new_flow()
        with obs.span("io_read", chunk=seq, flow=fid):
            raw = reader.window_bytes(widx)
            obs.flow_start(fid, "chunk")
        if self._audit.enabled:
            self._audit.note_chunk(seq - self._epoch_base, raw)
        with obs.span("parse", chunk=seq, flow=fid):
            obs.flow_step(fid, "chunk")
            faultpoint("shard.read")
            block = reader.read_window(widx, raw)
        if self._audit.enabled:
            self._audit.note_parse(seq - self._epoch_base, block)
        block.flow_id = fid
        self.bytes_read += len(raw)
        self._seq += 1
        self._pos += 1
        return block

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block

    def before_first(self) -> None:
        """Rewind for the next epoch (with shuffle armed, its
        permutation)."""
        self._epoch += 1
        self._epoch_base = self._seq
        self._reorder()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Re-slice the current epoch's global order for a new part."""
        self._part = int(part_index)
        self._nparts = max(1, int(num_parts))
        self._reorder()

    def stats(self) -> dict:
        return {
            "windows": len(self._order),
            "windows_total": len(self._table),
            "files": len(self._readers),
            "rows": int(self.num_rows),
            "epoch": int(self._epoch),
            "shuffle_seed": int(self._seed),
            "shuffle_window": int(self._unit),
        }

    # ---- job-snapshot state ---------------------------------------------
    def snapshot_state(self) -> dict:
        """What the read plan is a function of; the order itself is
        derived again on restore."""
        return {
            "uri": self.uri,
            "seed": int(self._seed),
            "window": int(self._unit),
            "epoch": int(self._epoch),
            "part": int(self._part),
            "nparts": int(self._nparts),
        }

    def restore_state(self, st: dict) -> None:
        """Go to the start of the epoch after ``st["epoch"]`` (snapshots
        are taken at epoch ends) and slice its order for this parser's
        current part."""
        check(st.get("uri", self.uri) == self.uri,
              "snapshot read-plan is for %s, not %s", st.get("uri"),
              self.uri)
        check(int(st.get("window", self._unit)) == self._unit,
              "snapshot shuffle window %s != configured %d (the epoch "
              "permutation would differ)", st.get("window"), self._unit)
        self._seed = int(st["seed"])
        self._epoch = int(st["epoch"]) + 1
        self._epoch_base = self._seq
        self._reorder()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for rd in self._readers:
            rd.close()


# ---------------------------------------------------------------------------
# source-cache keying
# ---------------------------------------------------------------------------


def cache_token(uri: str, data_format: str) -> Optional[List]:
    """The shard-content token of a source-cache key: [format version,
    shuffle seed, shuffle window, [[path, size, footer crc32] a file]], so
    a re-baked file or a re-seeded job never hits another's cached parse;
    None for data that is not shards. An unreadable footer gives (size,
    mtime) instead."""
    if data_format != "shard" and not is_shard_uri(uri):
        return None
    token: List = [SHARD_FORMAT_VERSION, env_shuffle_seed(),
                   env_shuffle_window()]
    files: List = []
    try:
        from dmlc_tpu_torch.io.input_split import list_split_files

        for path, _size in sorted(list_split_files(_local_path(uri))):
            try:
                size = os.path.getsize(path)
                with open(path, "rb") as f:
                    f.seek(max(0, size - _TAIL.size - len(MAGIC)))
                    crc = _TAIL.unpack(f.read(_TAIL.size))[0]
                files.append([path, int(size), int(crc)])
            except (OSError, struct.error):
                try:
                    st = os.stat(path)
                    files.append([path, int(st.st_size),
                                  int(st.st_mtime_ns)])
                except OSError:
                    files.append([path, -1, -1])
    except Exception:
        files.append(["unlistable", str(uri)])
    token.append(files)
    return token

"""InputSplit: part k of n of a dataset, every record exactly once, the
port of ``dmlc_tpu/io/input_split.py`` (the reference's io.h:135-282,
src/io/input_split_base.*, line_split, recordio_split,
indexed_recordio_split, single_file_split.h, threaded_input_split.h,
cached_input_split.h and input_split_shuffle.h), over any registered
filesystem (``io/filesystem.py``: local files, ``mem://``, ``s3://``,
``gs://``, ``hdfs://``, ``azure://``, ``http(s)://``):

- the dataset is one ``;``-separated list of uris, each an exact path, a
  directory (its non-empty files; with ``recurse_directories`` those of
  its subdirectories too), or a regex over the files of its parent
  directory (InputSplitBase::ConvertToURIs, ``expand_uri_patterns``);
- each file is read through its filesystem's ``open_for_read`` stream:
  a local file's handle, a remote file's reconnecting ranged reader;
- partition boundaries are aligned byte offsets moved forward to the next
  record start (ResetPartition), so every record belongs to exactly one
  part;
- chunks hold whole records only: bytes after the last record head wait
  in an ``overflow`` buffer, and a chunk with no record head inside
  doubles until it holds one (Chunk::Load);
- record types: ``text`` (lines), ``recordio`` (magic-framed binary,
  4-byte aligned) and ``indexed_recordio`` (parts of equal record counts
  from an index file, optionally visited in a seeded MT19937 order each
  epoch);
- decorators: a prefetch thread (capacity 2, the factory's default; the
  thread starts at the first read, so a chunk-size hint given before it
  holds from the first chunk), the first-epoch disk cache of a
  ``#cachefile`` uri (``[u64 size][bytes]`` frames, replayed from the
  second epoch on) and the shuffle of ``num_shuffle_parts`` sub-splits in
  a seeded order each epoch.

``uri == "stdin"`` reads standard input (``SingleFileSplit``).
"""

from __future__ import annotations

import bisect
import os
import struct
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.io import recordio as _rio
from dmlc_tpu_torch.io.filesystem import (URI, FileInfo, create_stream,
                                          create_stream_for_read, delete,
                                          exists, get_filesystem, is_local)
from dmlc_tpu_torch.io.filesystem import list_split_files as _split_infos
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.utils.logging import DMLCError, check, check_eq
from dmlc_tpu_torch.utils.threaded_iter import ThreadedIter

# 8 MiB chunk buffer (kBufferSize, src/io/input_split_base.h)
DEFAULT_CHUNK_BYTES = (2 << 20) * 4


# process-wide ingest byte counter (docs/observability.md); every split's
# raw reads funnel through it
_M_READ = obs.registry().counter(
    "dmlc_io_read_bytes_total", "payload bytes ingested by source",
    source="input_split")


def list_split_files(uri: str,
                     recurse: bool = False) -> List[Tuple[str, int]]:
    """The flat list of non-empty ``(uri, size)`` files of a dataset uri
    (InputSplitBase::InitInputFileInfo; ``io/filesystem.list_split_files``
    gives them as FileInfo), a directory's subdirectories included with
    ``recurse``; raise if nothing matched. A local file is named by its
    path."""
    return [(info.path.str_full(), info.size)
            for info in _split_infos(uri, recurse)]


class InputSplit:
    """The record and chunk pull interface (io.h:135-282)."""

    def next_record(self) -> Optional[bytes]:
        """The next record, or None at the end of this part."""
        raise NotImplementedError

    def next_chunk(self) -> Optional[bytes]:
        """The next chunk of whole records, or None at the end."""
        raise NotImplementedError

    def next_batch(self, n_records: int) -> Optional[bytes]:
        """A chunk of about ``n_records`` records where the split supports
        it, else the next chunk (io.h:210)."""
        return self.next_chunk()

    def before_first(self) -> None:
        raise NotImplementedError

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise NotImplementedError

    def hint_chunk_size(self, chunk_size: int) -> None:
        pass

    def get_total_size(self) -> int:
        raise NotImplementedError

    def records(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec

    def chunks(self) -> Iterator[bytes]:
        while True:
            chunk = self.next_chunk()
            if chunk is None:
                return
            yield chunk

    def close(self) -> None:
        pass


class InputSplitBase(InputSplit):
    """Multi-file byte-range splitting core (src/io/input_split_base.*)."""

    def __init__(self, uri: str, align_bytes: int,
                 recurse_directories: bool = False):
        self._files: List[FileInfo] = _split_infos(uri, recurse_directories)
        self._file_offset = [0]
        for info in self._files:
            check(info.size % align_bytes == 0,
                  "file %s does not align by %d bytes",
                  info.path.str_full(), align_bytes)
            self._file_offset.append(self._file_offset[-1] + info.size)
        self._align = align_bytes
        self._chunk_bytes = DEFAULT_CHUNK_BYTES
        self._stream = None
        self._file_ptr = 0
        self._offset_begin = 0
        self._offset_end = 0
        self._offset_curr = 0
        self._overflow = b""
        self._pending_records: List[bytes] = []
        self._pending_idx = 0

    # ---- subclass hooks -----------------------------------------------
    def seek_record_begin(self, stream) -> int:
        """Read forward to the next record start; return bytes skipped."""
        raise NotImplementedError

    def find_last_record_begin(self, buf: bytes) -> int:
        """Offset of the last record head in buf (0 when none found)."""
        raise NotImplementedError

    def extract_records(self, chunk: bytes) -> List[bytes]:
        raise NotImplementedError

    # ---- partitioning (input_split_base.cc:30-64) ----------------------
    def reset_partition(self, part_index: int, num_parts: int) -> None:
        ntotal = self._file_offset[-1]
        nstep = (ntotal + num_parts - 1) // num_parts
        align = self._align
        nstep = ((nstep + align - 1) // align) * align
        begin = min(nstep * part_index, ntotal)
        end = min(nstep * (part_index + 1), ntotal)
        self._offset_begin = begin
        self._offset_end = end
        self._offset_curr = begin
        if begin == end:
            self._close_stream()
            self.before_first()
            return
        # exact end: extend the raw boundary to the next record begin
        file_end = self._file_index_for(end)
        if end != self._file_offset[file_end]:
            check(end > self._file_offset[file_end], "bad end offset")
            check(file_end < len(self._files), "bad end offset")
            with self._open(file_end) as fs:
                fs.seek(end - self._file_offset[file_end])
                self._offset_end = end + self.seek_record_begin(fs)
        # exact begin likewise
        self._file_ptr = self._file_index_for(begin)
        if begin != self._file_offset[self._file_ptr]:
            with self._open(self._file_ptr) as fs:
                fs.seek(begin - self._file_offset[self._file_ptr])
                self._offset_begin = begin + self.seek_record_begin(fs)
        self.before_first()

    def _file_index_for(self, offset: int) -> int:
        # index i with file_offset[i] <= offset < file_offset[i+1]
        return bisect.bisect_right(self._file_offset, offset) - 1

    def _open(self, file_index: int):
        path = self._files[file_index].path
        return get_filesystem(path).open_for_read(path)

    def _close_stream(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def before_first(self) -> None:
        self._pending_records = []
        self._pending_idx = 0
        self._overflow = b""
        if self._offset_begin >= self._offset_end:
            return
        self._close_stream()
        self._file_ptr = self._file_index_for(self._offset_begin)
        self._stream = self._open(self._file_ptr)
        self._stream.seek(
            self._offset_begin - self._file_offset[self._file_ptr])
        self._offset_curr = self._offset_begin

    # ---- raw reading across file boundaries ----------------------------
    def _read_range(self, size: int) -> bytes:
        if self._offset_begin >= self._offset_end or self._stream is None:
            return b""
        size = min(size, self._offset_end - self._offset_curr)
        if size <= 0:
            return b""
        parts: List[bytes] = []
        nleft = size
        while nleft > 0:
            data = self._stream.read(nleft)
            if data:
                parts.append(data)
                nleft -= len(data)
                self._offset_curr += len(data)
                continue
            # end of the current file: check bookkeeping, open the next
            check_eq(self._offset_curr, self._file_offset[self._file_ptr + 1],
                     "file offset not calculated correctly")
            if self._file_ptr + 1 >= len(self._files):
                break
            self._file_ptr += 1
            self._close_stream()
            self._stream = self._open(self._file_ptr)
        _M_READ.inc(size - nleft)
        if len(parts) == 1:
            return parts[0]
        return b"".join(parts)

    # ---- chunk loading (ReadChunk + Chunk::Load) -----------------------
    def _load_chunk(self) -> Optional[bytes]:
        """Next chunk holding only whole records, or None at end."""
        target = self._chunk_bytes
        overflow = self._overflow
        self._overflow = b""
        data = self._read_range(target - len(overflow))
        buf = (overflow + data) if overflow else data
        if not buf:
            return None
        while True:
            if len(buf) < target:
                # end of the partition range: the remainder is the final
                # chunk (its end was extended to a record boundary)
                return bytes(buf)
            pos = self.find_last_record_begin(buf)
            if pos != 0:
                self._overflow = bytes(buf[pos:])
                return bytes(memoryview(buf)[:pos])
            # no record boundary inside: grow and read more
            target *= 2
            buf = buf + self._read_range(target - len(buf))

    # ---- public API ----------------------------------------------------
    def next_chunk(self) -> Optional[bytes]:
        return self._load_chunk()

    def next_record(self) -> Optional[bytes]:
        while self._pending_idx >= len(self._pending_records):
            chunk = self._load_chunk()
            if chunk is None:
                return None
            self._pending_records = self.extract_records(chunk)
            self._pending_idx = 0
        rec = self._pending_records[self._pending_idx]
        self._pending_idx += 1
        return rec

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._chunk_bytes = max(chunk_size, self._align)

    def get_total_size(self) -> int:
        return self._file_offset[-1]

    def close(self) -> None:
        self._close_stream()


class LineSplitter(InputSplitBase):
    """Text records, one per line (src/io/line_split.cc). Runs of
    ``\\n``/``\\r`` collapse: empty lines produce no records."""

    def __init__(self, uri: str, recurse_directories: bool = False):
        super().__init__(uri, align_bytes=1,
                         recurse_directories=recurse_directories)

    def seek_record_begin(self, stream) -> int:
        nstep = 0
        # scan to the first end-of-line
        while True:
            c = stream.read(1)
            if not c:
                return nstep
            nstep += 1
            if c in (b"\n", b"\r"):
                break
        # consume the rest of the newline run
        while True:
            c = stream.read(1)
            if not c:
                return nstep
            if c not in (b"\n", b"\r"):
                break
            nstep += 1
        return nstep

    def find_last_record_begin(self, buf: bytes) -> int:
        pos = max(buf.rfind(b"\n", 1), buf.rfind(b"\r", 1))
        return pos + 1 if pos >= 0 else 0

    def extract_records(self, chunk: bytes) -> List[bytes]:
        return [line for line in chunk.splitlines() if line]




class RecordIOSplitter(InputSplitBase):
    """Magic-framed binary records (src/io/recordio_split.{h,cc}); files
    are 4-byte aligned."""

    def __init__(self, uri: str, recurse_directories: bool = False):
        super().__init__(uri, align_bytes=4,
                         recurse_directories=recurse_directories)

    def seek_record_begin(self, stream) -> int:
        # one u32 at a time to a record head: the magic, then an lrecord
        # of cflag 0 or 1 (recordio_split.cc:9-24)
        nstep = 0
        while True:
            word = stream.read(4)
            if not word:
                return nstep
            nstep += 4
            if struct.unpack("<I", word)[0] == _rio.RECORDIO_MAGIC:
                lrec_b = stream.read(4)
                check(len(lrec_b) == 4, "invalid recordio format")
                nstep += 4
                cflag = _rio.decode_flag(struct.unpack("<I", lrec_b)[0])
                if cflag in (0, 1):
                    return nstep - 8

    def find_last_record_begin(self, buf: bytes) -> int:
        check_eq(len(buf) % 4, 0, "recordio chunk must stay 4B-aligned")
        return _rio.last_record_head(buf)

    def extract_records(self, chunk: bytes) -> List[bytes]:
        return list(_rio.RecordIOChunkReader(chunk))


class IndexedRecordIOSplitter(InputSplitBase):
    """RecordIO parts of equal record counts from an index file
    (src/io/indexed_recordio_split.{h,cc}).

    The index holds whitespace-separated ``key offset`` pairs; the sorted
    offsets become (offset, size) spans (ReadIndexFile,
    indexed_recordio_split.cc:43-61). ``shuffle=True`` visits the part's
    records in a new permutation each epoch, drawn from one MT19937
    engine seeded once with ``K_RAND_MAGIC + seed``: numpy's generator,
    so the order is the JAX package's."""

    K_RAND_MAGIC = 111

    def __init__(self, uri: str, index_uri: str, batch_size: int = 256,
                 shuffle: bool = False, seed: int = 0,
                 recurse_directories: bool = False):
        super().__init__(uri, align_bytes=4,
                         recurse_directories=recurse_directories)
        self._index: List[Tuple[int, int]] = []  # (offset, size)
        self._read_index_file(index_uri)
        self.batch_size = batch_size
        self._shuffle = shuffle
        self._rng = np.random.Generator(
            np.random.MT19937(self.K_RAND_MAGIC + seed))
        self._index_begin = 0
        self._index_end = 0
        self._current = 0
        self._n_overflow = 0
        self._permutation: List[int] = []

    def _read_index_file(self, index_uri: str) -> None:
        with create_stream(index_uri, "r") as stream:
            tokens = stream.read_all().split()
        check(len(tokens) % 2 == 0, "invalid index file: odd token count")
        offsets = sorted(int(tokens[i + 1]) for i in range(0, len(tokens), 2))
        check(len(offsets) > 0, "empty index file")
        total = self._file_offset[-1]
        for i, off in enumerate(offsets):
            nxt = offsets[i + 1] if i + 1 < len(offsets) else total
            self._index.append((off, nxt - off))

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        # record-count parts (indexed_recordio_split.cc:12-41)
        ntotal = len(self._index)
        nstep = (ntotal + num_parts - 1) // num_parts
        if part_index * nstep >= ntotal:
            self._index_begin = self._index_end = 0
            self._offset_begin = self._offset_end = 0
            self.before_first()
            return
        self._index_begin = part_index * nstep
        self._index_end = min((part_index + 1) * nstep, ntotal)
        self._offset_begin = self._index[self._index_begin][0]
        last_off, last_size = self._index[self._index_end - 1]
        self._offset_end = last_off + last_size
        self.before_first()

    def before_first(self) -> None:
        self._pending_records = []
        self._pending_idx = 0
        self._overflow = b""
        self._n_overflow = 0
        if self._shuffle:
            perm = np.arange(self._index_begin, self._index_end)
            self._rng.shuffle(perm)
            self._permutation = [int(i) for i in perm]
            self._current = 0
        else:
            self._current = self._index_begin
        self._offset_curr = self._offset_begin
        self._close_stream()
        if self._offset_begin < self._offset_end:
            self._file_ptr = self._file_index_for(self._offset_begin)
            self._stream = self._open(self._file_ptr)
            self._stream.seek(
                self._offset_begin - self._file_offset[self._file_ptr])

    def _read_span(self, offset: int, size: int) -> bytes:
        """The bytes [offset, offset + size) of the dataset, across
        files."""
        file_idx = self._file_index_for(offset)
        if self._stream is None or file_idx != self._file_ptr:
            self._close_stream()
            self._file_ptr = file_idx
            self._stream = self._open(file_idx)
        self._stream.seek(offset - self._file_offset[file_idx])
        self._offset_curr = offset
        parts: List[bytes] = []
        nleft = size
        while nleft > 0:
            data = self._stream.read(nleft)
            if not data:
                check(self._file_ptr + 1 < len(self._files),
                      "index points past end of data")
                self._file_ptr += 1
                self._close_stream()
                self._stream = self._open(self._file_ptr)
                continue
            parts.append(data)
            nleft -= len(data)
            self._offset_curr += len(data)
        _M_READ.inc(size)
        return b"".join(parts)

    def next_batch(self, n_records: int) -> Optional[bytes]:
        """A chunk of the next ``n_records`` records; a short batch is
        completed before a new one starts (the reference's n_overflow
        carry, NextBatchEx indexed_recordio_split.cc:158-211)."""
        n = self._n_overflow if self._n_overflow else n_records
        if self._shuffle:
            out: List[bytes] = []
            n_read = 0
            while n_read < n and self._current < len(self._permutation):
                off, size = self._index[self._permutation[self._current]]
                out.append(self._read_span(off, size))
                self._current += 1
                n_read += 1
            if n_read == 0:
                return None
            self._n_overflow = n - n_read
            return b"".join(out)
        if self._current >= self._index_end:
            return None
        last = min(self._current + n, self._index_end)
        self._n_overflow = self._current + n - last
        begin_off = self._index[self._current][0]
        end_off, end_size = self._index[last - 1]
        span = self._read_span(begin_off, end_off + end_size - begin_off)
        self._current = last
        return span

    def next_chunk(self) -> Optional[bytes]:
        return self.next_batch(self.batch_size)

    def next_record(self) -> Optional[bytes]:
        while self._pending_idx >= len(self._pending_records):
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._pending_records = self.extract_records(chunk)
            self._pending_idx = 0
        rec = self._pending_records[self._pending_idx]
        self._pending_idx += 1
        return rec

    def seek_record_begin(self, stream) -> int:
        raise DMLCError("indexed recordio does not seek by scanning")

    def find_last_record_begin(self, buf: bytes) -> int:
        raise DMLCError("indexed recordio does not split chunks by scanning")

    def extract_records(self, chunk: bytes) -> List[bytes]:
        return list(_rio.RecordIOChunkReader(chunk))


class SingleFileSplit(InputSplit):
    """Text records of standard input or of one file, not partitioned
    (src/io/single_file_split.h; ``uri == "stdin"``, src/io.cc:95-97)."""

    def __init__(self, path: str):
        self._path = path
        self._pending: List[bytes] = []
        self._idx = 0
        self._chunk_bytes = DEFAULT_CHUNK_BYTES
        self._tail = b""
        self._eof = False
        self._stream = None
        self.before_first()

    def _open(self):
        if self._path == "stdin":
            return sys.stdin.buffer
        return create_stream_for_read(self._path)

    def before_first(self) -> None:
        if self._stream is not None and self._path != "stdin":
            self._stream.close()
        self._stream = self._open()
        self._pending = []
        self._idx = 0
        self._tail = b""
        self._eof = False

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        check_eq(num_parts, 1, "SingleFileSplit does not support partitioning")
        self.before_first()

    def next_chunk(self) -> Optional[bytes]:
        while True:
            if self._eof:
                return None
            data = self._stream.read(self._chunk_bytes)
            if not data:
                self._eof = True
                out, self._tail = self._tail, b""
                return out or None
            _M_READ.inc(len(data))
            buf = self._tail + data
            pos = max(buf.rfind(b"\n"), buf.rfind(b"\r")) + 1
            if pos == 0:
                # no line break yet: read on to one or to the end
                self._tail = buf
                continue
            self._tail = buf[pos:]
            return buf[:pos]

    def next_record(self) -> Optional[bytes]:
        while self._idx >= len(self._pending):
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._pending = [ln for ln in chunk.splitlines() if ln]
            self._idx = 0
        rec = self._pending[self._idx]
        self._idx += 1
        return rec

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._chunk_bytes = chunk_size

    def get_total_size(self) -> int:
        if self._path == "stdin":
            return 0
        path = URI.parse(self._path)
        return get_filesystem(path).get_path_info(path).size

    def close(self) -> None:
        if self._stream is not None and self._path != "stdin":
            self._stream.close()
        self._stream = None


# ---------------------------------------------------------------------------
# decorators
# ---------------------------------------------------------------------------


class _Prefetched(InputSplit):
    """A split whose chunks a ``ThreadedIter`` produces. The thread starts
    at the first read, not at construction, so ``hint_chunk_size`` given
    before it holds from the first chunk; ``_stop_prefetch`` joins it."""

    PREFETCH = 2
    NAME = "input-split-prefetch"

    def __init__(self, base: InputSplitBase):
        self._base = base
        self._iter: Optional[ThreadedIter] = None

    def _chunk_source(self) -> Iterator[bytes]:
        raise NotImplementedError

    def _stop_prefetch(self) -> None:
        if self._iter is not None:
            self._iter.close()
            self._iter = None

    def next_chunk(self) -> Optional[bytes]:
        if self._iter is None:
            self._iter = ThreadedIter(self._chunk_source,
                                      max_capacity=self.PREFETCH,
                                      name=self.NAME)
        return self._iter.next()

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._base.hint_chunk_size(chunk_size)

    def get_total_size(self) -> int:
        return self._base.get_total_size()

    def close(self) -> None:
        self._stop_prefetch()
        self._base.close()


class ThreadedInputSplit(_Prefetched):
    """Chunk prefetch on a background thread, queue capacity 2
    (src/io/threaded_input_split.h:33); the factory's default."""

    def __init__(self, base: InputSplitBase, capacity: int = 2):
        super().__init__(base)
        self.PREFETCH = capacity
        self._pending: List[bytes] = []
        self._idx = 0

    def _chunk_source(self) -> Iterator[bytes]:
        while True:
            chunk = self._base.next_chunk()
            if chunk is None:
                return
            yield chunk

    def next_record(self) -> Optional[bytes]:
        while self._idx >= len(self._pending):
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._pending = self._base.extract_records(chunk)
            self._idx = 0
        rec = self._pending[self._idx]
        self._idx += 1
        return rec

    def before_first(self) -> None:
        self._stop_prefetch()
        self._base.before_first()
        self._pending = []
        self._idx = 0

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self._stop_prefetch()
        self._base.reset_partition(part_index, num_parts)
        self._pending = []
        self._idx = 0


class CachedInputSplit(_Prefetched):
    """The first epoch streams the base's chunks and writes them to a
    cache file as ``[u64 size][bytes]`` frames; later epochs, and later
    instances over the same file, replay the cache
    (src/io/cached_input_split.h:148-189). Chunks only.

    The cache counts only once a whole pass wrote it. A local one is
    written beside itself and renamed into place, as the JAX package
    does. A remote one is written as one object under its own name (an
    object store has no rename, and a stream that ends early still
    uploads what it holds), then marked complete by an empty
    ``<cache>.complete`` object; a remote cache without its marker is
    built again."""

    PREFETCH = 16  # cached_input_split.h:151
    NAME = "cached-split"

    def __init__(self, base: InputSplitBase, cache_file: str):
        super().__init__(base)
        self._cache_file = cache_file
        self._local = is_local(cache_file)
        if self._local:
            self._tmp_file = cache_file + ".tmp"
            self._cache_ready = exists(cache_file)
        else:
            self._tmp_file = cache_file
            self._marker = cache_file + ".complete"
            self._cache_ready = exists(self._marker) and exists(cache_file)

    def _chunk_source(self) -> Iterator[bytes]:
        if self._cache_ready:
            with create_stream(self._cache_file, "r") as fp:
                while True:
                    head = fp.read(8)
                    if len(head) < 8:
                        return
                    (size,) = struct.unpack("<Q", head)
                    yield fp.read_exact(size)
        else:
            if not self._local and exists(self._marker):
                delete(self._marker)  # its cache is gone: built anew
            with create_stream(self._tmp_file, "w") as out:
                while True:
                    chunk = self._base.next_chunk()
                    if chunk is None:
                        break
                    out.write(struct.pack("<Q", len(chunk)))
                    out.write(chunk)
                    yield chunk
            if self._local:
                os.replace(URI.parse(self._tmp_file).name,
                           URI.parse(self._cache_file).name)
            else:
                create_stream(self._marker, "w").close()
            self._cache_ready = True

    def next_record(self) -> Optional[bytes]:
        raise DMLCError(
            "CachedInputSplit is chunk-only (cached_input_split.h:57-60)")

    def before_first(self) -> None:
        self._stop_prefetch()
        if not self._cache_ready:
            self._base.before_first()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise DMLCError("CachedInputSplit cannot repartition after caching")


class InputSplitShuffle(InputSplit):
    """The "global" shuffle: this part cut into ``num_shuffle_parts``
    sub-splits, visited in a new order each epoch from one MT19937 engine
    seeded once with ``seed`` (include/dmlc/input_split_shuffle.h:24-33,
    138-147)."""

    def __init__(self, make_split, part_index: int, num_parts: int,
                 num_shuffle_parts: int, seed: int = 0):
        # make_split(sub_part, total) -> InputSplit
        self._make_split = make_split
        self._part_index = part_index
        self._num_parts = num_parts
        self._num_shuffle = num_shuffle_parts
        self._rng = np.random.Generator(np.random.MT19937(seed))
        self._split: Optional[InputSplit] = None
        self._order: List[int] = []
        self._pos = 0
        self.before_first()

    def before_first(self) -> None:
        self._order = [self._part_index * self._num_shuffle + i
                       for i in range(self._num_shuffle)]
        self._rng.shuffle(self._order)
        self._pos = 0
        self._advance()

    def _advance(self) -> None:
        if self._split is not None:
            self._split.close()
            self._split = None
        if self._pos < len(self._order):
            self._split = self._make_split(
                self._order[self._pos], self._num_parts * self._num_shuffle)
            self._pos += 1

    def next_record(self) -> Optional[bytes]:
        while self._split is not None:
            rec = self._split.next_record()
            if rec is not None:
                return rec
            self._advance()
        return None

    def next_chunk(self) -> Optional[bytes]:
        while self._split is not None:
            chunk = self._split.next_chunk()
            if chunk is not None:
                return chunk
            self._advance()
        return None

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self._part_index = part_index
        self._num_parts = num_parts
        self.before_first()

    def get_total_size(self) -> int:
        return self._split.get_total_size() if self._split else 0

    def close(self) -> None:
        if self._split is not None:
            self._split.close()
            self._split = None


# ---------------------------------------------------------------------------
# factory (io.h:241-281, src/io.cc:82-131)
# ---------------------------------------------------------------------------


def create_input_split(uri: str, part_index: int, num_parts: int,
                       split_type: str = "text", *, index_uri: str = "",
                       shuffle: bool = False, seed: int = 0,
                       batch_size: int = 256,
                       recurse_directories: bool = False,
                       num_shuffle_parts: int = 0,
                       threaded: bool = True) -> InputSplit:
    """InputSplit::Create.

    ``split_type`` is "text", "recordio" or "indexed_recordio" (which
    needs ``index_uri``; ``shuffle``, ``seed`` and ``batch_size`` are its
    options). A ``#cachefile`` suffix selects :class:`CachedInputSplit`,
    ``uri == "stdin"`` :class:`SingleFileSplit`, ``num_shuffle_parts > 0``
    :class:`InputSplitShuffle` seeded with ``seed``; otherwise the split
    comes wrapped in a :class:`ThreadedInputSplit` unless ``threaded`` is
    False."""
    if uri == "stdin":
        return SingleFileSplit(uri)
    spec = URISpec(uri, part_index, num_parts)
    if num_shuffle_parts > 0:
        check(not spec.cache_file,
              "shuffle splits do not combine with cache files")

        def make_sub(sub_part: int, total: int) -> InputSplit:
            return create_input_split(
                spec.uri, sub_part, total, split_type, index_uri=index_uri,
                batch_size=batch_size,
                recurse_directories=recurse_directories, threaded=threaded)

        return InputSplitShuffle(make_sub, part_index, num_parts,
                                 num_shuffle_parts, seed=seed)
    base: InputSplitBase
    if split_type == "text":
        base = LineSplitter(spec.uri, recurse_directories)
    elif split_type == "recordio":
        base = RecordIOSplitter(spec.uri, recurse_directories)
    elif split_type == "indexed_recordio":
        check(bool(index_uri), "indexed_recordio requires index_uri")
        base = IndexedRecordIOSplitter(
            spec.uri, index_uri, batch_size=batch_size, shuffle=shuffle,
            seed=seed, recurse_directories=recurse_directories)
    else:
        raise DMLCError(f"unknown input split type {split_type!r}")
    base.reset_partition(part_index, num_parts)
    if spec.cache_file:
        return CachedInputSplit(base, spec.cache_file)
    if threaded:
        return ThreadedInputSplit(base)
    return base

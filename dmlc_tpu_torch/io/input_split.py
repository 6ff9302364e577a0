"""InputSplit: part k of n of a text dataset, every line exactly once.

The port of ``dmlc_tpu/io/input_split.py``'s text path
(``InputSplitBase`` + ``LineSplitter``, the reference's
src/io/input_split_base.cc and line_split.cc), for local files:

- the dataset is one ``;``-separated list of paths, each an exact path, a
  directory (its non-empty files), or a regex over the files of its parent
  directory (InputSplitBase::ConvertToURIs);
- partition boundaries are aligned byte offsets moved forward to the next
  line start (ResetPartition), so every line belongs to exactly one part;
- chunks hold whole lines only: bytes after the last line start wait in an
  ``overflow`` buffer, and a chunk with no line start inside doubles until
  it holds one (Chunk::Load).

Left out here: remote filesystems, RecordIO, chunk shuffle and the
prefetch thread. A ``#cachefile`` uri raises: ``data/row_iter.py`` serves
cache files.
"""

from __future__ import annotations

import bisect
import os
import re
from typing import List, Optional, Tuple

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.io.filesystem import local_path
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.utils.logging import DMLCError, check, check_eq

# 8 MiB chunk buffer (kBufferSize, src/io/input_split_base.h)
DEFAULT_CHUNK_BYTES = (2 << 20) * 4


# process-wide ingest byte counter (docs/observability.md); every split's
# raw reads funnel through it
_M_READ = obs.registry().counter(
    "dmlc_io_read_bytes_total", "payload bytes ingested by source",
    source="input_split")


def _expand_patterns(uri: str) -> List[str]:
    """Expand a ``;``-separated list of paths and regexes into concrete
    paths (InputSplitBase::ConvertToURIs): an exact path match in the
    parent directory wins, else the segment is a regex that must
    full-match non-empty regular files there."""
    out: List[str] = []
    for part in uri.split(";"):
        if not part:
            continue
        name = local_path(part)
        pos = name.rfind("/")
        if pos < 0 or pos + 1 == len(name):
            out.append(name)
            continue
        parent = name[:pos]
        try:
            entries = sorted(os.listdir(parent))
        except OSError:
            out.append(name)
            continue
        listed = [os.path.join(parent, e) for e in entries]
        target = name.rstrip("/")
        exact = [p for p in listed if p.rstrip("/") == target]
        if exact:
            out.append(exact[0])
            continue
        try:
            pattern = re.compile(name)
        except re.error as err:
            raise DMLCError(f"bad regex in uri {name!r}: {err}") from err
        matched = False
        for p in listed:
            if (os.path.isfile(p) and os.path.getsize(p) > 0
                    and pattern.fullmatch(p.rstrip("/"))):
                out.append(p)
                matched = True
        if not matched:
            out.append(name)
    return out


def list_split_files(uri: str) -> List[Tuple[str, int]]:
    """The flat list of non-empty ``(path, size)`` files of a dataset uri
    (InputSplitBase::InitInputFileInfo); raise if nothing matched."""
    files: List[Tuple[str, int]] = []
    for path in _expand_patterns(uri):
        if os.path.isdir(path):
            for entry in sorted(os.listdir(path)):
                full = os.path.join(path, entry)
                if os.path.isfile(full) and os.path.getsize(full) > 0:
                    files.append((full, os.path.getsize(full)))
        elif os.path.exists(path) and os.path.getsize(path) > 0:
            files.append((path, os.path.getsize(path)))
    if not files:
        raise DMLCError(
            f"Cannot find any files that match the URI pattern {uri!r}")
    return files


class InputSplitBase:
    """Multi-file byte-range splitting core (src/io/input_split_base.*)."""

    def __init__(self, uri: str, align_bytes: int):
        self._files = list_split_files(uri)
        self._file_offset = [0]
        for path, size in self._files:
            check(size % align_bytes == 0,
                  "file %s does not align by %d bytes", path, align_bytes)
            self._file_offset.append(self._file_offset[-1] + size)
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
        return open(self._files[file_index][0], "rb")

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

    def close(self) -> None:
        self._close_stream()


class LineSplitter(InputSplitBase):
    """Text records, one per line (src/io/line_split.cc). Runs of
    ``\\n``/``\\r`` collapse: empty lines produce no records."""

    def __init__(self, uri: str):
        super().__init__(uri, align_bytes=1)

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


def create_input_split(uri: str, part_index: int, num_parts: int,
                       split_type: str = "text") -> InputSplitBase:
    """InputSplit::Create for local text datasets."""
    check(split_type == "text",
          "only text input splits are supported, got %s", split_type)
    spec = URISpec(uri, part_index, num_parts)
    if spec.cache_file:
        raise DMLCError(
            f"cache files are not supported: {uri!r} names #{spec.cache_file}")
    base = LineSplitter(spec.uri)
    base.reset_partition(part_index, num_parts)
    return base

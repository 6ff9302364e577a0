"""RecordIO: the splittable binary record format, the port of
``dmlc_tpu/io/recordio.py`` (include/dmlc/recordio.h, src/recordio.cc).
Files are byte-identical to the JAX package's and the reference's:

- a frame is ``[kMagic 0xced7230a (u32 LE)][lrecord (u32 LE)][data][pad
  to 4 bytes]`` with ``lrecord = (cflag << 29) | length``
  (recordio.h:45-70);
- cflag 0 is a whole record; 1/2/3 are the start, middle and end parts
  of a record whose payload holds the magic word at a 4-byte-aligned
  offset: the writer splits there and drops that magic
  (recordio.cc:11-51), the reader puts it back (recordio.cc:53-82);
- records are shorter than 2^29 bytes;
- ``RecordIOChunkReader`` reads the records of an in-memory chunk and can
  cut the chunk into ``num_parts`` aligned ranges for parallel parses
  (recordio.cc:101-156).

``RecordIOWriter.write_records`` frames a whole batch in one pass of the
native core (``native.recordio_pack_records``) and ``RecordIOChunkReader``
decodes its part range in one native pass (``native.recordio_unpack_chunk``),
as the JAX package does with its library loaded; ``write_record``,
``RecordIOReader`` and the head scans are numpy passes over aligned u32
words. Both give the same bytes.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.utils.logging import check

RECORDIO_MAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", RECORDIO_MAGIC)
_MAX_RECORD = 1 << 29


def encode_lrec(cflag: int, length: int) -> int:
    """(cflag << 29) | length (recordio.h:53-56)."""
    return (cflag << 29) | length


def decode_flag(rec: int) -> int:
    return (rec >> 29) & 7


def decode_length(rec: int) -> int:
    return rec & ((1 << 29) - 1)


def _aligned_magic_positions(data: bytes) -> np.ndarray:
    """The 4-byte-aligned offsets of the magic word in ``data`` (the
    writer's scan, recordio.cc:22-27)."""
    lower = (len(data) >> 2) << 2
    if lower == 0:
        return np.empty(0, dtype=np.int64)
    words = np.frombuffer(data, dtype="<u4", count=lower >> 2)
    return (np.nonzero(words == RECORDIO_MAGIC)[0] << 2).astype(np.int64)


class RecordIOWriter:
    """Write records, splitting a payload at each embedded aligned magic
    (recordio.cc:11-51). ``except_counter`` counts those splits."""

    def __init__(self, stream: Stream):
        self._stream = stream
        self.except_counter = 0

    def write_record(self, data: bytes) -> None:
        check(len(data) < _MAX_RECORD,
              "RecordIO only accepts records < 2^29 bytes")
        out: List[bytes] = []
        dptr = 0
        for pos in _aligned_magic_positions(data):
            pos = int(pos)
            lrec = encode_lrec(1 if dptr == 0 else 2, pos - dptr)
            out.append(_MAGIC_BYTES)
            out.append(struct.pack("<I", lrec))
            if pos != dptr:
                out.append(data[dptr:pos])
            dptr = pos + 4
            self.except_counter += 1
        lrec = encode_lrec(3 if dptr != 0 else 0, len(data) - dptr)
        out.append(_MAGIC_BYTES)
        out.append(struct.pack("<I", lrec))
        if len(data) != dptr:
            out.append(data[dptr:])
        pad = (-(len(data) - dptr)) % 4
        if pad:
            out.append(b"\x00" * pad)
        self._stream.write(b"".join(out))

    def write_records(self, records) -> None:
        """Frame the whole batch in one native pass and write it with one
        stream write (csrc/recordio.cc ``recordio_pack_batch``)."""
        from dmlc_tpu_torch import native

        records = list(records)  # may be a generator: read twice
        lens = np.fromiter((len(r) for r in records), dtype=np.int64,
                           count=len(records))
        check(bool((lens < _MAX_RECORD).all()),
              "RecordIO only accepts records < 2^29 bytes")
        packed = native.recordio_pack_records(records)
        # each embedded magic costs one more 8-byte header and takes its own
        # 4 bytes out of the padded payload: the count from the size delta
        plain = 8 * len(records) + int(((lens + 3) & ~3).sum())
        self.except_counter += (len(packed) - plain) // 4
        self._stream.write(packed)


class RecordIOReader:
    """Read records one after another, reassembling multi-part ones
    (recordio.cc:53-82)."""

    def __init__(self, stream: Stream):
        self._stream = stream
        self._eos = False
        self._m_read = obs.registry().counter(
            "dmlc_io_read_bytes_total", "payload bytes ingested by source",
            source="recordio")

    def next_record(self) -> Optional[bytes]:
        if self._eos:
            return None
        parts: List[bytes] = []
        nread = 0
        while True:
            header = self._stream.read(8)
            if len(header) == 0 and not parts:
                self._eos = True
                return None
            check(len(header) == 8, "Invalid RecordIO file: truncated header")
            nread += 8
            magic, lrec = struct.unpack("<II", header)
            check(magic == RECORDIO_MAGIC, "Invalid RecordIO file: bad magic")
            cflag = decode_flag(lrec)
            length = decode_length(lrec)
            upper = (length + 3) & ~3
            if upper:
                payload = self._stream.read_exact(upper)
                parts.append(payload[:length])
                nread += upper
            if cflag in (0, 3):
                break
            parts.append(_MAGIC_BYTES)
        self._m_read.inc(nread)
        return b"".join(parts)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def find_next_record_head(data: bytes, begin: int, end: int) -> int:
    """The first aligned offset in [begin, end) that holds a record head,
    the magic followed by an lrecord of cflag 0 or 1
    (FindNextRecordIOHead, recordio.cc:85-99); ``end`` when there is
    none. The lrecord word must lie inside the range too."""
    check((begin & 3) == 0 and (end & 3) == 0,
          "chunk bounds must be 4B-aligned")
    if end - begin < 8:
        return end
    words = np.frombuffer(data, dtype="<u4", offset=begin,
                          count=(end - begin) >> 2)
    hits = np.nonzero(words[:-1] == RECORDIO_MAGIC)[0]
    if hits.size:
        flags = (words[hits + 1] >> 29) & 7
        good = hits[(flags == 0) | (flags == 1)]
        if good.size:
            return begin + (int(good[0]) << 2)
    return end


def last_record_head(buf: bytes) -> int:
    """The offset of the last record head in ``buf`` past its first byte,
    or 0 when there is none (RecordIOSplitter::FindLastRecordBegin)."""
    words = np.frombuffer(buf, dtype="<u4")
    hits = np.nonzero(words[:-1] == RECORDIO_MAGIC)[0]
    if hits.size:
        flags = (words[hits + 1] >> 29) & 7
        good = hits[(flags == 0) | (flags == 1)]
        if good.size:
            return int(good[-1]) << 2
    return 0


class RecordIOChunkReader:
    """The records of an in-memory chunk, or of part ``part_index`` of
    ``num_parts`` aligned ranges of it (recordio.cc:101-156)."""

    def __init__(self, chunk: bytes, part_index: int = 0, num_parts: int = 1):
        size = len(chunk)
        nstep = (size + num_parts - 1) // num_parts
        nstep = (nstep + 3) & ~3
        begin = min(size, nstep * part_index)
        end = min(size, nstep * (part_index + 1))
        self._data = chunk
        self._pbegin = find_next_record_head(chunk, begin, size)
        self._pend = find_next_record_head(chunk, end, size)
        # the whole part range decoded in one native pass
        self._decoded: Optional[Tuple[bytes, np.ndarray]] = None
        self._decoded_idx = 0
        if self._pbegin < self._pend:
            from dmlc_tpu_torch import native

            data, offsets, consumed = native.recordio_unpack_chunk(
                chunk[self._pbegin:self._pend])
            check(consumed == self._pend - self._pbegin,
                  "Invalid RecordIO format (partial frame inside part)")
            self._decoded = (data, offsets)

    def next_record(self) -> Optional[bytes]:
        if self._decoded is None:
            return None
        data, offsets = self._decoded
        i = self._decoded_idx
        if i >= len(offsets) - 1:
            return None
        self._decoded_idx = i + 1
        return data[offsets[i]:offsets[i + 1]]

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def build_index(uri: str, index_uri: str) -> int:
    """Write the IndexedRecordIO index of the RecordIO file ``uri``: one
    ``key<TAB>offset`` line a record, the text ReadIndexFile reads
    (indexed_recordio_split.cc:43-61); a multi-part record is indexed by
    its first frame. Returns the record count."""
    from dmlc_tpu_torch.io.filesystem import create_stream

    entries: List[Tuple[int, int]] = []
    pos = 0
    # a bytearray: extend and compact stay linear when a frame spans
    # many reads
    pending = bytearray()
    record_start = -1  # offset of the current record's first frame
    with create_stream(uri, "r") as stream:
        while True:
            data = stream.read(4 << 20)
            if not data:
                break
            pending += data
            off = 0
            while off + 8 <= len(pending):
                magic, lrec = struct.unpack_from("<II", pending, off)
                check(magic == RECORDIO_MAGIC, "Invalid RecordIO format")
                cflag = decode_flag(lrec)
                frame = 8 + ((decode_length(lrec) + 3) & ~3)
                if off + frame > len(pending):
                    break
                if cflag in (0, 1):
                    check(record_start < 0, "Invalid RecordIO format")
                    record_start = pos + off
                else:
                    check(record_start >= 0, "Invalid RecordIO format")
                if cflag in (0, 3):
                    entries.append((len(entries), record_start))
                    record_start = -1
                off += frame
            pos += off
            del pending[:off]
        check(not pending and record_start < 0,
              "truncated RecordIO file: trailing partial record")
    with create_stream(index_uri, "w") as out:
        out.write("".join(f"{k}\t{offset}\n"
                          for k, offset in entries).encode())
    return len(entries)

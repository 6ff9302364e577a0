"""Binary row-group records: CSR slices inside RecordIO frames, the port of
``dmlc_tpu/data/rowrec.py``. Text is parsed once (``convert_to_recordio``,
its libsvm chunks tokenized by the ``tokenize_boundaries`` kernel on the
parser's device); every later epoch reads framed typed arrays with no
scan and no tokenizer.

Payload layout (little-endian), byte for byte the JAX package's:

    u8  tag 0x52 ('R')
    u8  flags: 1=weights, 2=qids, 4=values
    u16 reserved (0)
    u32 nrows
    u32 nnz
    labels  f32[nrows]
    weights f32[nrows]      (iff flags & 1)
    qids    i64[nrows]      (iff flags & 2)
    row_nnz u32[nrows]
    indices u32[nnz]
    values  f32[nnz]        (iff flags & 4)

libfm ``field`` arrays are not carried: a libfm block raises, as in the
JAX package. Its native decoder is not ported; this is its Python twin.
"""

from __future__ import annotations

import struct
from typing import Iterable, Optional

import numpy as np

from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io.recordio import RecordIOWriter
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import DMLCError, check

ROW_GROUP_TAG = 0x52
HAS_WEIGHT = 1
HAS_QID = 2
HAS_VALUE = 4

_HEADER = struct.Struct("<BBHII")


def encode_row_group(block: RowBlock) -> bytes:
    """One row-group payload of the rows of ``block``."""
    check(block.field is None, "row-group records do not carry libfm fields")
    flags = 0
    if block.weight is not None:
        flags |= HAS_WEIGHT
    if block.qid is not None:
        flags |= HAS_QID
    if block.value is not None:
        flags |= HAS_VALUE
    parts = [_HEADER.pack(ROW_GROUP_TAG, flags, 0, len(block),
                          block.num_nonzero),
             np.ascontiguousarray(block.label, np.float32).tobytes()]
    if block.weight is not None:
        parts.append(np.ascontiguousarray(block.weight, np.float32).tobytes())
    if block.qid is not None:
        parts.append(np.ascontiguousarray(block.qid, np.int64).tobytes())
    row_nnz = np.diff(np.asarray(block.offset, np.int64)).astype(np.uint32)
    parts.append(row_nnz.tobytes())
    parts.append(np.ascontiguousarray(block.index, np.uint32).tobytes())
    if block.value is not None:
        parts.append(np.ascontiguousarray(block.value, np.float32).tobytes())
    return b"".join(parts)


def decode_row_group(payload: bytes) -> RowBlock:
    """The RowBlock of one row-group payload; its arrays are views of
    ``payload``."""
    if len(payload) < _HEADER.size:
        raise DMLCError("row-group record too short")
    tag, flags, _resv, n, nnz = _HEADER.unpack_from(payload, 0)
    if tag != ROW_GROUP_TAG:
        raise DMLCError("not a row-group record (bad tag)")
    pos = _HEADER.size

    def take(count: int, dtype) -> np.ndarray:
        nonlocal pos
        nbytes = count * np.dtype(dtype).itemsize
        if pos + nbytes > len(payload):
            raise DMLCError("truncated row-group record")
        out = np.frombuffer(payload, dtype=dtype, count=count, offset=pos)
        pos += nbytes
        return out

    label = take(n, np.float32)
    weight = take(n, np.float32) if flags & HAS_WEIGHT else None
    qid = take(n, np.int64) if flags & HAS_QID else None
    row_nnz = take(n, np.uint32)
    index = take(nnz, np.uint32)
    value = take(nnz, np.float32) if flags & HAS_VALUE else None
    if pos != len(payload):
        raise DMLCError("row-group record has trailing bytes")
    offset = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_nnz, out=offset[1:])
    if int(offset[-1]) != nnz:
        raise DMLCError("row-group nnz mismatch")
    return RowBlock(offset=offset, label=label, index=index, value=value,
                    weight=weight, qid=qid)


class RowGroupWriter:
    """Write RowBlocks as row-group records of at most ``rows_per_group``
    rows each (records balance the recordio parts)."""

    def __init__(self, stream, rows_per_group: int = 1024):
        check(rows_per_group > 0, "rows_per_group must be positive")
        self._writer = RecordIOWriter(stream)
        self._rows_per_group = rows_per_group

    def write_block(self, block: RowBlock) -> None:
        for start in range(0, len(block), self._rows_per_group):
            stop = min(start + self._rows_per_group, len(block))
            self._writer.write_record(
                encode_row_group(block.slice(start, stop)))


def write_recordio_rows(uri: str, blocks: Iterable[RowBlock],
                        rows_per_group: int = 1024) -> None:
    """Write RowBlocks to the local file ``uri`` as row-group RecordIO."""
    from dmlc_tpu_torch.io.filesystem import create_stream

    with create_stream(uri, "w") as out:
        writer = RowGroupWriter(out, rows_per_group=rows_per_group)
        for block in blocks:
            writer.write_block(block)


def convert_to_recordio(src_uri: str, dst_uri: str,
                        data_format: str = "auto",
                        rows_per_group: int = 1024, nthread: int = 2,
                        device=None) -> int:
    """Parse ``src_uri`` once (``create_parser`` on ``device``; None means
    cuda) and write its rows to ``dst_uri`` as row-group RecordIO.
    Returns the rows written."""
    from dmlc_tpu_torch.data.parsers import create_parser

    parser = create_parser(src_uri, 0, 1, data_format=data_format,
                           nthread=nthread, device=device)
    rows = 0

    def _blocks():
        nonlocal rows
        for block in parser:
            rows += len(block)
            yield block

    try:
        write_recordio_rows(dst_uri, _blocks(), rows_per_group=rows_per_group)
    finally:
        parser.close()
    return rows


class RecordIORowParser:
    """The parser of row-group RecordIO data: one RowBlock a record, read
    from a recordio InputSplit. It launches no kernel; ``device`` is
    carried for the parser interface."""

    def __init__(self, source, args=None, nthread: int = 2, device=None):
        self._source = source
        self.device = resolve_device(device)
        self._bytes_read = 0

    @property
    def bytes_read(self) -> int:
        """Payload bytes of the records read (framing excluded)."""
        return self._bytes_read

    def next_block(self) -> Optional[RowBlock]:
        while True:
            rec = self._source.next_record()
            if rec is None:
                return None
            self._bytes_read += len(rec)
            block = decode_row_group(bytes(rec))
            if len(block):
                return block

    def __iter__(self):
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block

    def before_first(self) -> None:
        self._source.before_first()

    def close(self) -> None:
        self._source.close()

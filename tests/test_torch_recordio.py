"""The port's RecordIO (``dmlc_tpu_torch/io/recordio.py``) against the JAX
package's on the same seeded records: the files are byte-equal, each
package reads the other's, multi-part records (payloads holding the magic
word at an aligned offset) come back whole, the chunk reader's parts
cover every record once, and the index text is the same. Host code over
bytes: every comparison is equality."""

import struct

import numpy as np
import pytest

from dmlc_tpu.io import recordio as ref_rio
from dmlc_tpu.io.stream import MemoryStream as RefMemoryStream
from dmlc_tpu.tools import recordio as ref_tool
from dmlc_tpu_torch.io import MemoryStream, recordio
from dmlc_tpu_torch.tools import recordio as tool
from dmlc_tpu_torch.utils import DMLCError

MAGIC = struct.pack("<I", recordio.RECORDIO_MAGIC)


@pytest.fixture(autouse=True)
def python_stack(monkeypatch):
    """The JAX package's Python RecordIO, never its native batch writer
    or chunk decoder (the port has neither)."""
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")


def _records(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return [rng.bytes(int(rng.randint(0, 300))) for _ in range(200)]
    if kind == "magic":
        # the magic word at aligned and unaligned offsets, at the start,
        # at the end, twice in a row, and a payload that is only magic
        out = []
        for i in range(120):
            body = bytearray(rng.bytes(4 * int(rng.randint(1, 40))
                                       + int(rng.randint(0, 4))))
            for _ in range(i % 4):
                pos = 4 * int(rng.randint(0, len(body) // 4))
                body[pos:pos + 4] = MAGIC
            out.append(bytes(body))
        return out + [MAGIC, MAGIC * 3, MAGIC + b"x", b"ab" + MAGIC,
                      b"", b"\x0a\x23\xd7\xce" * 2]
    if kind == "tool":
        return tool.gen_records(300, seed)
    raise ValueError(kind)


KINDS = ["random", "magic", "tool"]


def _write_port(records):
    out = MemoryStream()
    writer = recordio.RecordIOWriter(out)
    for rec in records:
        writer.write_record(rec)
    return out.getvalue(), writer.except_counter


def _write_ref(records):
    out = RefMemoryStream()
    writer = ref_rio.RecordIOWriter(out)
    for rec in records:
        writer.write_record(rec)
    return out.getvalue(), writer.except_counter


@pytest.mark.parametrize("kind", KINDS)
def test_files_are_byte_equal(kind):
    records = _records(kind)
    got, splits = _write_port(records)
    want, ref_splits = _write_ref(records)
    assert got == want
    assert splits == ref_splits
    if kind == "magic":
        assert splits > 100  # multi-part records were written
    # the batch writer writes the same bytes
    out = MemoryStream()
    recordio.RecordIOWriter(out).write_records(iter(records))
    assert out.getvalue() == want


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_reads_the_others_file(kind):
    records = _records(kind, seed=3)
    port_file, _ = _write_port(records)
    ref_file, _ = _write_ref(records)
    assert list(recordio.RecordIOReader(MemoryStream(ref_file))) == records
    assert list(ref_rio.RecordIOReader(RefMemoryStream(port_file))) \
        == records
    reader = recordio.RecordIOReader(MemoryStream(port_file))
    assert list(reader) == records and reader.next_record() is None


@pytest.mark.parametrize("num_parts", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_chunk_reader_parts_match_reference(kind, num_parts):
    records = _records(kind, seed=5)
    data, _ = _write_port(records)
    every = []
    for part in range(num_parts):
        got = list(recordio.RecordIOChunkReader(data, part, num_parts))
        want = list(ref_rio.RecordIOChunkReader(data, part, num_parts))
        assert got == want
        every.extend(got)
    assert every == records


def test_truncated_and_bad_frames_raise():
    data, _ = _write_port([b"abcd" * 5, MAGIC + b"tail"])
    with pytest.raises(DMLCError, match="truncated"):
        list(recordio.RecordIOReader(MemoryStream(data[:4])))
    with pytest.raises(DMLCError, match="bad magic"):
        list(recordio.RecordIOReader(MemoryStream(b"\0" * 8)))
    with pytest.raises(EOFError):
        list(recordio.RecordIOReader(MemoryStream(data[:-4])))
    with pytest.raises(DMLCError, match="2\\^29"):
        recordio.RecordIOWriter(MemoryStream()).write_record(_Huge())


class _Huge(bytes):
    """A payload that reports 2^29 bytes (the writer checks the length
    first), without allocating them."""

    def __len__(self):
        return 1 << 29


def test_lrecord_fields():
    for cflag in range(4):
        for length in (0, 1, 5, (1 << 29) - 1):
            rec = recordio.encode_lrec(cflag, length)
            assert rec == ref_rio.encode_lrec(cflag, length)
            assert recordio.decode_flag(rec) == cflag
            assert recordio.decode_length(rec) == length


@pytest.mark.parametrize("kind", KINDS)
def test_build_index_text_matches_reference(tmp_path, kind):
    records = _records(kind, seed=9)
    path = tmp_path / "r.rec"
    path.write_bytes(_write_port(records)[0])
    n = recordio.build_index(str(path), str(tmp_path / "port.idx"))
    ref_n = ref_rio.build_index(str(path), str(tmp_path / "ref.idx"))
    assert n == ref_n == len(records)
    assert (tmp_path / "port.idx").read_bytes() \
        == (tmp_path / "ref.idx").read_bytes()
    # a multi-part record is indexed by its first frame
    lines = (tmp_path / "port.idx").read_text().splitlines()
    data = path.read_bytes()
    for line in lines:
        off = int(line.split("\t")[1])
        magic, lrec = struct.unpack_from("<II", data, off)
        assert magic == recordio.RECORDIO_MAGIC
        assert recordio.decode_flag(lrec) in (0, 1)


def test_build_index_refuses_a_torn_file(tmp_path):
    path = tmp_path / "torn.rec"
    path.write_bytes(_write_port([b"x" * 40, b"y" * 40])[0][:-8])
    with pytest.raises(DMLCError, match="truncated"):
        recordio.build_index(str(path), str(tmp_path / "i.idx"))


def test_tool_records_and_round_trip_match_reference(tmp_path):
    assert tool.gen_records(50, 4) == ref_tool._gen_records(50, 4)
    port_path, ref_path = tmp_path / "port.rec", tmp_path / "ref.rec"
    assert tool.main([str(port_path), "--n", "90", "--nsplit", "3",
                      "--write-index", str(tmp_path / "port.idx")]) == 0
    assert ref_tool.main([str(ref_path), "--n", "90", "--nsplit", "3"]) == 0
    assert port_path.read_bytes() == ref_path.read_bytes()

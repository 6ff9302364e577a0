"""The small host surfaces against the JAX package: ``Serializable``,
``FixedMemoryStream``, ``Stream.try_read_exact``, ``read_uint32`` /
``write_uint32`` (the same bytes both ways) and
``Snapshotter.version_number``."""

import numpy as np
import pytest

import dmlc_tpu.io as ref_io
import dmlc_tpu_torch.io as port_io
from dmlc_tpu_torch.io.stream import FixedMemoryStream, MemoryStream


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_typed_scalars_are_the_references_bytes(writer):
    w, r = (port_io, ref_io) if writer == "port" else (ref_io, port_io)
    out = w.MemoryStream()
    out.write_uint32(7)
    out.write_uint32(0xFFFFFFFF)
    out.write_uint64(1 << 40)
    out.write_bytes_prefixed(b"hello")
    data = out.getvalue()
    assert len(data) == 4 + 4 + 8 + 8 + 5
    inp = r.MemoryStream(data)
    assert inp.read_uint32() == 7
    assert inp.read_uint32() == 0xFFFFFFFF
    assert inp.read_uint64() == 1 << 40
    assert inp.read_bytes_prefixed() == b"hello"


class _Chunky(port_io.MemoryStream):
    """Hands out at most 3 bytes a read."""

    def read(self, nbytes):
        return super().read(min(nbytes, 3))


@pytest.mark.parametrize("data,n,want", [
    (b"", 4, None),  # a clean end
    (b"abcdefgh", 4, b"abcd"),
    (b"abcdefgh", 8, b"abcdefgh"),  # over three short reads
])
def test_try_read_exact(data, n, want):
    for cls in (_Chunky, port_io.MemoryStream):
        assert cls(data).try_read_exact(n) == want
    assert ref_io.MemoryStream(data).try_read_exact(n) == want


def test_try_read_exact_raises_mid_record():
    with pytest.raises(EOFError):
        _Chunky(b"abcde").try_read_exact(8)
    with pytest.raises(EOFError):
        ref_io.MemoryStream(b"abcde").try_read_exact(8)


def test_fixed_memory_stream_matches_the_reference():
    for mod in (port_io, ref_io):
        buf = bytearray(8)
        s = mod.FixedMemoryStream(buf)
        s.write(b"abcd")
        with pytest.raises(IOError):
            s.write(b"toolong67")
        assert s.tell() == 4
        s.write_uint32(0x01020304)
        assert bytes(buf) == b"abcd\x04\x03\x02\x01"
        s.seek(0)
        assert s.read(4) == b"abcd"
        assert s.read_uint32() == 0x01020304
        assert s.read(4) == b""
        with pytest.raises(IOError):
            s.seek(9)


def test_serializable_is_a_runtime_protocol():
    class Model:
        def __init__(self):
            self.w = np.arange(4, dtype=np.float32)

        def save(self, stream):
            stream.write_uint32(len(self.w))
            stream.write(self.w.tobytes())

        def load(self, stream):
            n = stream.read_uint32()
            self.w = np.frombuffer(stream.read_exact(4 * n), np.float32)

    m = Model()
    assert isinstance(m, port_io.Serializable)
    assert isinstance(m, ref_io.Serializable)
    assert not isinstance(object(), port_io.Serializable)
    buf = bytearray(4 + 16)
    m.save(FixedMemoryStream(buf))
    back = Model()
    back.w = None
    back.load(MemoryStream(bytes(buf)))
    assert np.array_equal(back.w, m.w)


def test_snapshotter_version_number(tmp_path):
    """The newest committed version, as the JAX package's reads it."""
    from dmlc_tpu.collective import JobSnapshot as RefJobSnapshot
    from dmlc_tpu_torch.collective import JobSnapshot, Snapshotter
    from dmlc_tpu_torch.resilience import preempt

    uri = str(tmp_path / "snap")
    snap = JobSnapshot(uri)
    snapper = Snapshotter(snap, every_epochs=1)
    try:
        assert snapper.version_number == 0
        for epoch in range(3):
            snapper.capture(epoch, {"w": np.full(3, epoch, np.float32)})
        assert snapper.drain(timeout=30)
        assert snapper.version_number == snap.version_number == 3
        assert RefJobSnapshot(uri).version_number == 3
    finally:
        snapper.close()
        preempt.uninstall()  # the snapshotter armed SIGTERM

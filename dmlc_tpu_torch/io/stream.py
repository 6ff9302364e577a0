"""Byte streams (``dmlc::Stream`` / ``SeekStream`` / ``Serializable``,
include/dmlc/io.h, and the in-memory streams of memory_io.h), the port of
``dmlc_tpu/io/stream.py``.

``read(n)`` returns up to ``n`` bytes (b"" at the end); ``write(data)``
writes all of them. The typed helpers are little-endian fixed-width
scalars and u64-length-prefixed blobs, byte for byte as the JAX package
writes them.
"""

from __future__ import annotations

import io as _pyio
import struct
from typing import Optional, Protocol, Union, runtime_checkable


class Stream:
    """Abstract byte stream with typed little-endian helpers."""

    def read(self, nbytes: int) -> bytes:
        raise NotImplementedError

    def write(self, data: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def read_exact(self, nbytes: int) -> bytes:
        """Exactly ``nbytes``, or EOFError (a partial read raises too)."""
        chunks = []
        remaining = nbytes
        while remaining > 0:
            chunk = self.read(remaining)
            if not chunk:
                raise EOFError(f"Stream ended: wanted {nbytes} bytes, got "
                               f"{nbytes - remaining}")
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def try_read_exact(self, nbytes: int) -> Optional[bytes]:
        """As :meth:`read_exact`, but None at a clean end of the stream
        (no byte of the record read)."""
        first = self.read(nbytes)
        if not first:
            return None
        if len(first) == nbytes:
            return first
        return first + self.read_exact(nbytes - len(first))

    def read_all(self) -> bytes:
        """Every byte up to the end of the stream."""
        parts = []
        while True:
            piece = self.read(1 << 20)
            if not piece:
                return b"".join(parts)
            parts.append(piece)

    def write_fmt(self, fmt: str, *values) -> None:
        self.write(struct.pack("<" + fmt, *values))

    def read_fmt(self, fmt: str):
        size = struct.calcsize("<" + fmt)
        vals = struct.unpack("<" + fmt, self.read_exact(size))
        return vals if len(vals) > 1 else vals[0]

    def write_uint32(self, v: int) -> None:
        self.write_fmt("I", v)

    def read_uint32(self) -> int:
        return self.read_fmt("I")

    def write_uint64(self, v: int) -> None:
        self.write_fmt("Q", v)

    def read_uint64(self) -> int:
        return self.read_fmt("Q")

    def write_bytes_prefixed(self, data: bytes) -> None:
        """u64 length, then the bytes (Stream::Write(std::string))."""
        self.write_uint64(len(data))
        self.write(data)

    def read_bytes_prefixed(self) -> bytes:
        return self.read_exact(self.read_uint64())


class SeekStream(Stream):
    """Stream with random access (io.h:89-107)."""

    def seek(self, pos: int) -> None:
        raise NotImplementedError

    def tell(self) -> int:
        raise NotImplementedError


@runtime_checkable
class Serializable(Protocol):
    """An object that round-trips through a Stream (io.h:112-126)."""

    def save(self, stream: Stream) -> None: ...

    def load(self, stream: Stream) -> None: ...


class FileObjStream(SeekStream):
    """A stream over a Python binary file object."""

    def __init__(self, fileobj):
        self._f = fileobj

    def read(self, nbytes: int) -> bytes:
        return self._f.read(nbytes)

    def write(self, data: bytes) -> None:
        self._f.write(data)

    def seek(self, pos: int) -> None:
        self._f.seek(pos)

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        self._f.close()


class MemoryStream(SeekStream):
    """Growable in-memory stream (MemoryStringStream, memory_io.h)."""

    def __init__(self, data: bytes = b""):
        self._buf = _pyio.BytesIO(data)

    def read(self, nbytes: int) -> bytes:
        return self._buf.read(nbytes)

    def write(self, data: bytes) -> None:
        self._buf.write(data)

    def seek(self, pos: int) -> None:
        self._buf.seek(pos)

    def tell(self) -> int:
        return self._buf.tell()

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


class FixedMemoryStream(SeekStream):
    """A SeekStream over a fixed-size buffer the caller owns
    (``MemoryFixedSizeStream``, memory_io.h:21-63): a write past its end
    raises."""

    def __init__(self, buf: Union[bytearray, memoryview]):
        self._view = memoryview(buf)
        self._pos = 0

    def read(self, nbytes: int) -> bytes:
        end = min(self._pos + nbytes, len(self._view))
        out = bytes(self._view[self._pos:end])
        self._pos = end
        return out

    def write(self, data: bytes) -> None:
        end = self._pos + len(data)
        if end > len(self._view):
            raise IOError(
                f"FixedMemoryStream overflow: {end} > {len(self._view)}")
        self._view[self._pos:end] = data
        self._pos = end

    def seek(self, pos: int) -> None:
        if pos < 0 or pos > len(self._view):
            raise IOError(f"seek out of range: {pos}")
        self._pos = pos

    def tell(self) -> int:
        return self._pos

"""Byte streams (``dmlc::Stream`` / ``SeekStream``, include/dmlc/io.h), the
part of ``dmlc_tpu/io/stream.py`` the cache pages and the serializer use.

``read(n)`` returns up to ``n`` bytes (b"" at the end); ``write(data)``
writes all of them. The typed helpers are little-endian fixed-width
scalars and u64-length-prefixed blobs, byte for byte as the JAX package
writes them.
"""

from __future__ import annotations

import io as _pyio
import struct


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

"""Typed binary serialization of Python values over a Stream
(include/dmlc/serializer.h), copied from ``dmlc_tpu/io/serializer.py``.

A runtime tag before each value and a little-endian wire format (not
pickle: loading runs no code). The bytes equal the JAX package's for every
supported type, so a cache page written by either package loads in the
other. Supported: None, bool, int (int64, wider as a length-prefixed
big int), float (f64), bytes, str, list, tuple, dict, set and numpy
ndarrays (dtype + shape + raw buffer).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

from dmlc_tpu_torch.io.stream import Stream

_T_NONE = 0
_T_BOOL = 1
_T_INT = 2
_T_FLOAT = 3
_T_BYTES = 4
_T_STR = 5
_T_LIST = 6
_T_TUPLE = 7
_T_DICT = 8
_T_SET = 9
_T_NDARRAY = 10
_T_BIGINT = 11  # ints outside int64 range, as length-prefixed bytes


class SerializationError(TypeError):
    """Unsupported type (the runtime analog of UndefinedSerializerFor)."""


def save_obj(stream: Stream, obj: Any) -> None:
    _save(stream, obj)


def load_obj(stream: Stream) -> Any:
    return _load(stream)


def _save_items(s: Stream, tag: int, items) -> None:
    s.write_fmt("B", tag)
    s.write_uint64(len(items))
    for item in items:
        _save(s, item)


def _save(s: Stream, obj: Any) -> None:
    if obj is None:
        s.write_fmt("B", _T_NONE)
    elif isinstance(obj, bool):
        s.write_fmt("BB", _T_BOOL, 1 if obj else 0)
    elif isinstance(obj, int):
        if -(2**63) <= obj < 2**63:
            s.write_fmt("Bq", _T_INT, obj)
        else:
            s.write_fmt("B", _T_BIGINT)
            nbytes = (obj.bit_length() + 8) // 8  # room for the sign
            s.write_uint64(nbytes)
            s.write(obj.to_bytes(nbytes, "little", signed=True))
    elif isinstance(obj, float):
        s.write_fmt("Bd", _T_FLOAT, obj)
    elif isinstance(obj, bytes):
        s.write_fmt("B", _T_BYTES)
        s.write_bytes_prefixed(obj)
    elif isinstance(obj, str):
        s.write_fmt("B", _T_STR)
        s.write_bytes_prefixed(obj.encode("utf-8"))
    elif isinstance(obj, list):
        _save_items(s, _T_LIST, obj)
    elif isinstance(obj, tuple):
        _save_items(s, _T_TUPLE, obj)
    elif isinstance(obj, dict):
        s.write_fmt("B", _T_DICT)
        s.write_uint64(len(obj))
        for key, val in obj.items():
            _save(s, key)
            _save(s, val)
    elif isinstance(obj, (set, frozenset)):
        # a fixed order, for reproducible bytes
        _save_items(s, _T_SET, sorted(obj, key=repr))
    elif isinstance(obj, np.ndarray):
        s.write_fmt("B", _T_NDARRAY)
        # the original shape: ascontiguousarray makes a 0-d array (1,)
        arr = np.ascontiguousarray(obj)
        s.write_bytes_prefixed(str(arr.dtype).encode("ascii"))
        s.write_uint64(obj.ndim)
        for dim in obj.shape:
            s.write_uint64(dim)
        s.write(arr.tobytes())
    elif isinstance(obj, np.integer):
        _save(s, int(obj))
    elif isinstance(obj, np.floating):
        _save(s, float(obj))
    else:
        raise SerializationError(
            f"No serializer defined for type {type(obj).__name__}")


def _load(s: Stream) -> Any:
    tag = s.read_fmt("B")
    if tag == _T_NONE:
        return None
    if tag == _T_BOOL:
        return bool(s.read_fmt("B"))
    if tag == _T_INT:
        return s.read_fmt("q")
    if tag == _T_BIGINT:
        nbytes = s.read_uint64()
        return int.from_bytes(s.read_exact(nbytes), "little", signed=True)
    if tag == _T_FLOAT:
        return s.read_fmt("d")
    if tag == _T_BYTES:
        return s.read_bytes_prefixed()
    if tag == _T_STR:
        return s.read_bytes_prefixed().decode("utf-8")
    if tag == _T_LIST:
        return [_load(s) for _ in range(s.read_uint64())]
    if tag == _T_TUPLE:
        return tuple(_load(s) for _ in range(s.read_uint64()))
    if tag == _T_DICT:
        out = {}
        for _ in range(s.read_uint64()):
            key = _load(s)
            out[key] = _load(s)
        return out
    if tag == _T_SET:
        return {_load(s) for _ in range(s.read_uint64())}
    if tag == _T_NDARRAY:
        dtype = np.dtype(s.read_bytes_prefixed().decode("ascii"))
        ndim = s.read_uint64()
        shape = tuple(s.read_uint64() for _ in range(ndim))
        count = int(np.prod(shape)) if shape else 1
        data = s.read_exact(count * dtype.itemsize)
        return np.frombuffer(data, dtype=dtype).reshape(shape).copy()
    raise SerializationError(f"Corrupt stream: unknown tag {tag}")

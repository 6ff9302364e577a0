"""ctypes bindings for the native core, the port of ``dmlc_tpu/native``.

The library is the port's own copy of the JAX package's C++
(``native/csrc``: the chunk parsers, RecordIO framing and the threaded
ingest pipeline with its batch staging), built from source at first use by
``native/_build.py`` into ``native/_build/``. The port never loads the JAX
package's ``cpp/libdmlc_tpu.so``. There is no loading policy: the first
call builds (if needed) and loads the library, and raises DMLCError when
it cannot; nothing falls back to a Python twin. The C++ reads no
environment variable: its SIMD tier comes from CPUID alone, the mmap
reader runs whenever a range lies in one local file, and the glibc tuning
and block pool are on, as the JAX package's defaults are.

- ``parse_libsvm_chunk`` / ``parse_libfm_chunk`` / ``parse_csv_chunk`` /
  ``count_tokens``: one chunk → arrays (None where the native number scan
  rejects a token, as the JAX package's bindings do);
- ``recordio_pack_records`` / ``recordio_unpack_chunk`` /
  ``recordio_find_head``: the RecordIO framing (cpp/recordio.cc);
- ``IngestPipeline``: reader thread + parse workers + ordered queue, fed by
  local files or pushed bytes (``push``, ``push_reserve`` /
  ``push_commit``, ``drive_push``), drained as zero-copy blocks
  (``next_block``) or as fixed-shape batches written into the caller's
  arrays (``stage_batch`` then ``fetch_batch_dense`` / ``coo`` /
  ``coo_sharded``);
- ``simd_level``, ``library_path`` and the ABI gate, which holds the
  loaded library to ``DMLC_TPU_ABI_VERSION`` of ``csrc/dmlc_tpu.h``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from dmlc_tpu_torch.native import _build
from dmlc_tpu_torch.utils.logging import DMLCError

_OK = 0
_EOVERFLOW = -1
_EPARSE = -2

HAS_WEIGHT = 1
HAS_QID = 2
HAS_VALUE = 4

INGEST_LIBSVM = 0
INGEST_LIBFM = 1
INGEST_CSV = 2
INGEST_RECORDIO = 3  # row-group records (data/rowrec.py layout)

#: ``ingest_stats``'s counters, in order
STATS_KEYS = ("bytes_read", "chunks", "reader_io_ns", "reader_wait_ns",
              "parse_ns", "worker_wait_ns", "consumer_wait_ns")

HEADER = _build.SRC_DIR / "dmlc_tpu.h"

_lib = None
_lib_path: Optional[Path] = None
_lock = threading.Lock()

# the fetch callback of ingest_drive_push: (ctx, offset, dst, want) -> bytes
# written (0 at end of stream, < 0 on error)
FETCH_FN = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_void_p, ctypes.c_int64)


def _bind(lib) -> None:
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    vp = ctypes.c_void_p
    lib.parse_libsvm.restype = ctypes.c_int
    lib.parse_libsvm.argtypes = [
        ctypes.c_char_p, i64, vp, vp, vp, vp, vp, vp, i64, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_int),
    ]
    lib.parse_libfm.restype = ctypes.c_int
    lib.parse_libfm.argtypes = [
        ctypes.c_char_p, i64, vp, vp, vp, vp, vp, i64, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.parse_csv.restype = ctypes.c_int
    lib.parse_csv.argtypes = [
        ctypes.c_char_p, i64, vp, i64, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.count_tokens.restype = None
    lib.count_tokens.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.recordio_pack_bound.restype = i64
    lib.recordio_pack_bound.argtypes = [ctypes.c_char_p, i64]
    lib.recordio_pack.restype = i64
    lib.recordio_pack.argtypes = [ctypes.c_char_p, i64, vp]
    lib.recordio_pack_batch.restype = i64
    lib.recordio_pack_batch.argtypes = [ctypes.c_char_p, vp, i64, vp]
    lib.recordio_pack_batch_bound.restype = i64
    lib.recordio_pack_batch_bound.argtypes = [ctypes.c_char_p, vp, i64]
    lib.recordio_unpack.restype = ctypes.c_int
    lib.recordio_unpack.argtypes = [
        ctypes.c_char_p, i64, vp, vp,
        ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.recordio_find_head.restype = i64
    lib.recordio_find_head.argtypes = [ctypes.c_char_p, i64, i64]
    lib.ingest_open_ex.restype = vp
    lib.ingest_open_ex.argtypes = [
        ctypes.c_char_p, vp, i32, i32, i32, i32, i32, i64, i32, i64, i64,
    ]
    lib.ingest_open_push.restype = vp
    lib.ingest_open_push.argtypes = [i32, i32, i64, i32, i64]
    lib.ingest_push.restype = ctypes.c_int
    # c_void_p, not c_char_p: writable buffers pass without a bytes copy
    lib.ingest_push.argtypes = [vp, vp, i64]
    lib.ingest_push_eof.restype = ctypes.c_int
    lib.ingest_push_eof.argtypes = [vp]
    lib.ingest_push_reserve.restype = vp
    lib.ingest_push_reserve.argtypes = [vp, i64]
    lib.ingest_push_commit.restype = ctypes.c_int
    lib.ingest_push_commit.argtypes = [vp, i64]
    lib.ingest_push_abort.restype = None
    lib.ingest_push_abort.argtypes = [vp]
    lib.ingest_drive_push.restype = ctypes.c_int
    lib.ingest_drive_push.argtypes = [vp, FETCH_FN, vp, i64, i64]
    lib.ingest_peek.restype = ctypes.c_int
    lib.ingest_peek.argtypes = [
        vp, ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(i32),
    ]
    lib.ingest_fetch_view.restype = vp
    lib.ingest_fetch_view.argtypes = [vp] + [ctypes.POINTER(vp)] * 7
    lib.ingest_block_free.restype = None
    lib.ingest_block_free.argtypes = [vp]
    lib.ingest_stage_batch.restype = ctypes.c_int
    lib.ingest_stage_batch.argtypes = [
        vp, i64, ctypes.POINTER(i64), ctypes.POINTER(i64),
    ]
    lib.ingest_fetch_batch_dense.restype = i64
    lib.ingest_fetch_batch_dense.argtypes = [vp, vp, vp, vp, i64, i64]
    lib.ingest_fetch_batch_coo.restype = i64
    lib.ingest_fetch_batch_coo.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64,
                                           i64]
    lib.ingest_staged_max_shard_nnz.restype = i64
    lib.ingest_staged_max_shard_nnz.argtypes = [vp, i64, i64]
    lib.ingest_fetch_batch_coo_sharded.restype = i64
    lib.ingest_fetch_batch_coo_sharded.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                   i64, i64, i64]
    lib.ingest_stats.restype = None
    lib.ingest_stats.argtypes = [vp, vp, i32]
    lib.ingest_bytes_read.restype = i64
    lib.ingest_bytes_read.argtypes = [vp]
    lib.ingest_close.restype = None
    lib.ingest_close.argtypes = [vp]
    lib.dmlc_tpu_abi_version.restype = ctypes.c_int
    lib.dmlc_tpu_abi_version.argtypes = []
    lib.dmlc_tpu_simd_level.restype = ctypes.c_int
    lib.dmlc_tpu_simd_level.argtypes = []


def expected_abi_version(header: Optional[Path] = None) -> int:
    """``DMLC_TPU_ABI_VERSION`` of the port's own header (:data:`HEADER`
    unless ``header`` is given): the contract ``_bind``'s signatures were
    written against."""
    header = Path(header or HEADER)
    for line in header.read_text().splitlines():
        if line.startswith("#define DMLC_TPU_ABI_VERSION"):
            return int(line.split()[2])
    raise DMLCError(f"no DMLC_TPU_ABI_VERSION in {header}")


def load_library(path) -> ctypes.CDLL:
    """dlopen + bind + the ABI gate; raises DMLCError for a file that is
    not a library, lacks a bound symbol or carries another ABI version."""
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as err:
        raise DMLCError(f"cannot load the native core {path}: {err}") from err
    try:
        _bind(lib)
        found = lib.dmlc_tpu_abi_version()
    except AttributeError as err:
        raise DMLCError(
            f"{path} is not the native core this port binds: {err}") from err
    want = expected_abi_version()
    if found != want:
        raise DMLCError(f"{path} has ABI version {found}, the port's header "
                        f"{HEADER} has {want}")
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built from ``native/csrc`` on first use."""
    global _lib, _lib_path
    if _lib is None:
        with _lock:
            if _lib is None:
                path = _build.ensure_built()
                _lib = load_library(path)
                _lib_path = path
    return _lib


def library_path() -> Path:
    """The file the loaded library came from."""
    get_lib()
    return _lib_path


def available() -> bool:
    """True once the library is loaded; a failed build raises instead (the
    name is the JAX package's, whose library may be absent)."""
    return get_lib() is not None


def simd_level() -> int:
    """The SIMD tier the parse engine selected from CPUID: 0 = portable
    scalar, 2 = AVX2+BMI2. Results are the same bits at every tier."""
    return int(get_lib().dmlc_tpu_simd_level())


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _bounds(chunk: bytes):
    """(max_rows, max_nnz) from the chunk length alone: every row and every
    feature token takes at least 2 bytes, so len/2 bounds both. np.empty
    is a virtual allocation, and the parse returns exact counts to trim."""
    bound = len(chunk) // 2 + 2
    return bound, bound


def parse_libsvm_chunk(chunk: bytes) -> Optional[dict]:
    """One libsvm chunk → {labels f32[n], weights f32[n], qids i64[n],
    counts i64[n], indices u64[nnz], values f32[nnz], flags}; None when
    the native number scan rejects a token (inf, nan, hex)."""
    lib = get_lib()
    max_rows, max_nnz = _bounds(chunk)
    labels = np.empty(max_rows, dtype=np.float32)
    weights = np.empty(max_rows, dtype=np.float32)
    qids = np.empty(max_rows, dtype=np.int64)
    counts = np.empty(max_rows, dtype=np.int64)
    indices = np.empty(max_nnz, dtype=np.uint64)
    values = np.empty(max_nnz, dtype=np.float32)
    out_rows = ctypes.c_int64()
    out_nnz = ctypes.c_int64()
    out_flags = ctypes.c_int()
    rc = lib.parse_libsvm(
        chunk, len(chunk),
        _ptr(labels), _ptr(weights), _ptr(qids), _ptr(counts),
        _ptr(indices), _ptr(values), max_rows, max_nnz,
        ctypes.byref(out_rows), ctypes.byref(out_nnz), ctypes.byref(out_flags))
    if rc == _EPARSE:
        return None
    if rc != _OK:
        raise DMLCError(f"native libsvm parse failed rc={rc}")
    n, nnz = out_rows.value, out_nnz.value
    return {"labels": labels[:n], "weights": weights[:n], "qids": qids[:n],
            "counts": counts[:n], "indices": indices[:nnz],
            "values": values[:nnz], "flags": out_flags.value}


def parse_libfm_chunk(chunk: bytes) -> Optional[dict]:
    """One libfm chunk → {labels, counts, fields u64, indices u64, values};
    None when the native number scan rejects a token."""
    lib = get_lib()
    max_rows, max_nnz = _bounds(chunk)
    labels = np.empty(max_rows, dtype=np.float32)
    counts = np.empty(max_rows, dtype=np.int64)
    fields = np.empty(max_nnz, dtype=np.uint64)
    indices = np.empty(max_nnz, dtype=np.uint64)
    values = np.empty(max_nnz, dtype=np.float32)
    out_rows = ctypes.c_int64()
    out_nnz = ctypes.c_int64()
    rc = lib.parse_libfm(
        chunk, len(chunk), _ptr(labels), _ptr(counts),
        _ptr(fields), _ptr(indices), _ptr(values), max_rows, max_nnz,
        ctypes.byref(out_rows), ctypes.byref(out_nnz))
    if rc == _EPARSE:
        return None
    if rc != _OK:
        raise DMLCError(f"native libfm parse failed rc={rc}")
    n, nnz = out_rows.value, out_nnz.value
    return {"labels": labels[:n], "counts": counts[:n],
            "fields": fields[:nnz], "indices": indices[:nnz],
            "values": values[:nnz]}


def parse_csv_chunk(chunk: bytes, expect_cols: int = 0):
    """One dense csv chunk → f32[rows, cols]; None for a ragged table or a
    rejected token."""
    lib = get_lib()
    max_rows = chunk.count(b"\n") + 2
    if expect_cols <= 0:
        nl = chunk.find(b"\n")
        first = chunk[: nl if nl >= 0 else len(chunk)]
        expect_cols = first.count(b",") + 1
    out = np.empty((max_rows, expect_cols), dtype=np.float32)
    out_rows = ctypes.c_int64()
    out_cols = ctypes.c_int64()
    rc = lib.parse_csv(chunk, len(chunk), _ptr(out), max_rows, expect_cols,
                       ctypes.byref(out_rows), ctypes.byref(out_cols))
    if rc == _EPARSE:
        return None
    if rc != _OK:
        raise DMLCError(f"native csv parse failed rc={rc}")
    return out[: out_rows.value, : out_cols.value]


def count_tokens(chunk: bytes):
    """(lines, whitespace-separated tokens) of a chunk."""
    lines = ctypes.c_int64()
    tokens = ctypes.c_int64()
    get_lib().count_tokens(chunk, len(chunk), ctypes.byref(lines),
                           ctypes.byref(tokens))
    return lines.value, tokens.value


# ---------------------------------------------------------------------------
# RecordIO framing (csrc/recordio.cc, the reference's src/recordio.cc)
# ---------------------------------------------------------------------------


def recordio_pack_records(records) -> bytes:
    """Frame a batch of payloads (any iterable of bytes-likes) into
    RecordIO bytes."""
    lib = get_lib()
    records = list(records)
    offsets = np.zeros(len(records) + 1, dtype=np.int64)
    for i, r in enumerate(records):
        offsets[i + 1] = offsets[i] + len(r)
    data = b"".join(bytes(r) for r in records)
    bound = lib.recordio_pack_batch_bound(data, _ptr(offsets), len(records))
    out = np.empty(int(bound), dtype=np.uint8)
    n = lib.recordio_pack_batch(data, _ptr(offsets), len(records), _ptr(out))
    if n < 0:
        raise DMLCError("RecordIO only accepts records < 2^29 bytes")
    return out[:n].tobytes()


def recordio_unpack_chunk(chunk: bytes) -> tuple:
    """Every complete record of a chunk that starts at a record head →
    (payloads: bytes, offsets: i64[n+1], consumed bytes). Raises
    DMLCError on corrupt framing."""
    lib = get_lib()
    # reassembly puts back elided magics: the output never exceeds the
    # input length plus one magic
    out_data = np.empty(len(chunk) + 4, dtype=np.uint8)
    out_offsets = np.zeros(len(chunk) // 8 + 3, dtype=np.int64)
    nrec = ctypes.c_int64()
    dlen = ctypes.c_int64()
    consumed = ctypes.c_int64()
    rc = lib.recordio_unpack(
        chunk, len(chunk), _ptr(out_data), _ptr(out_offsets),
        ctypes.byref(nrec), ctypes.byref(dlen), ctypes.byref(consumed))
    if rc != _OK:
        raise DMLCError("Invalid RecordIO format (native unpack)")
    n = nrec.value
    return (out_data[: dlen.value].tobytes(), out_offsets[: n + 1].copy(),
            consumed.value)


def recordio_find_head(buf: bytes, start: int = 0) -> int:
    """The first plausible record-head offset >= start, -1 when none."""
    return int(get_lib().recordio_find_head(buf, len(buf), start))


# ---------------------------------------------------------------------------
# The ingest pipeline (csrc/pipeline.cc): reader thread + parse workers +
# ordered output queue, the reference's ThreadedInputSplit / ThreadedParser
# composition as one native unit
# ---------------------------------------------------------------------------


class _NativeBlock:
    """Owner of a block handed off by ``ingest_fetch_view``. Every numpy
    view over the block's arrays holds it (through the ctypes buffer in its
    base chain), and so does any tensor made from such a view with
    ``torch.from_numpy``: the native buffers are freed when the last of
    them is collected."""

    __slots__ = ("_lib", "_ptr", "__weakref__")

    def __init__(self, lib, ptr):
        self._lib = lib
        self._ptr = ptr

    def __del__(self):
        ptr, self._ptr = self._ptr, None
        if ptr:
            try:
                self._lib.ingest_block_free(ptr)
            except Exception:
                pass


def _block_view(owner, addr, n, ctype, dtype):
    """Zero-copy numpy view over ``n`` elements of native memory."""
    if n == 0 or not addr:
        return np.empty(0, dtype=dtype)
    cbuf = (ctype * n).from_address(addr)
    cbuf._dmlc_block = owner  # lifetime: array.base -> cbuf -> owner
    return np.frombuffer(cbuf, dtype=dtype)


def _out(arr, shape, dtype):
    """The caller's output array (checked), or a fresh one."""
    if arr is None:
        return np.empty(shape, dtype=dtype)
    if (arr.shape != tuple(np.atleast_1d(shape)) or arr.dtype != dtype
            or not arr.flags.c_contiguous):
        raise DMLCError(f"output array must be C-contiguous {dtype} of shape "
                        f"{shape}, got {arr.dtype} {arr.shape}")
    return arr


class IngestPipeline:
    """A handle over the native pipeline.

    Over local files (``paths``, ``sizes``) the C++ reader thread reads
    part ``part`` of ``nparts`` (the InputSplit's exactly-once partition);
    with ``push=True`` the caller streams the partition's bytes in.
    ``shuffle_seed >= 0`` visits a single local file's chunks in seeded
    order. ``next_block()`` returns a dict of zero-copy arrays, None at the
    end of the stream, and raises DMLCError on a parse or I/O error inside
    the pipeline; ``stage_batch`` / ``fetch_batch_*`` are the fixed-shape
    batch route instead (do not mix the two on one handle)."""

    def __init__(self, paths, sizes, fmt: int, part: int, nparts: int,
                 nthread: int = 2, chunk_bytes: int = (2 << 20) * 4,
                 capacity: int = 8, csv_expect_cols: int = 0,
                 push: bool = False, shuffle_seed: int = -1):
        lib = get_lib()
        self._lib = lib
        self._fmt = fmt
        self._handle = None
        self._closed_bytes_read = 0
        if push:
            self._handle = lib.ingest_open_push(
                fmt, nthread, chunk_bytes, capacity, csv_expect_cols)
        else:
            path_blob = b"".join(
                (p.encode() if isinstance(p, str) else bytes(p)) + b"\0"
                for p in paths)
            size_arr = np.asarray(sizes, dtype=np.int64)
            self._handle = lib.ingest_open_ex(
                path_blob, _ptr(size_arr), len(paths), fmt, part, nparts,
                nthread, chunk_bytes, capacity, csv_expect_cols, shuffle_seed)
        if not self._handle:
            raise DMLCError(
                "ingest_open failed (bad arguments"
                + (", or a chunk shuffle over more than one file"
                   if shuffle_seed >= 0 else "") + ")")

    def _live(self):
        """The native handle; DMLCError once closed (a freed handle must
        never reach the C++: the garbage collector may finalize this
        object before a parser that still reads it)."""
        if not self._handle:
            raise DMLCError("the ingest pipeline is closed")
        return self._handle

    # ---- push mode (remote ingest feeders) ---------------------------
    def push(self, data) -> None:
        """Append partition bytes (any buffer; no copy on the Python side);
        blocks while the parse workers are behind (ctypes drops the GIL)."""
        n = len(data)
        if isinstance(data, bytes):
            buf = data
        else:
            buf = ctypes.addressof((ctypes.c_char * n).from_buffer(data))
        rc = self._lib.ingest_push(self._live(), buf, n)
        if rc != 0:
            raise DMLCError(f"native ingest push failed rc={rc}")

    def push_reserve(self, want: int):
        """A writable memoryview over ``want`` bytes of the pipeline's own
        tail buffer, valid until the next reserve, commit or push: a remote
        response is read into native memory with no Python-side copy."""
        ptr = self._lib.ingest_push_reserve(self._live(), want)
        if not ptr:
            raise DMLCError("native ingest push_reserve failed")
        return memoryview((ctypes.c_char * want).from_address(ptr)).cast("B")

    def push_commit(self, n: int) -> None:
        rc = self._lib.ingest_push_commit(self._live(), n)
        if rc != 0:
            raise DMLCError(f"native ingest push_commit failed rc={rc}")

    def push_eof(self) -> None:
        rc = self._lib.ingest_push_eof(self._live())
        if rc != 0:
            raise DMLCError(f"native ingest push_eof failed rc={rc}")

    def push_abort(self) -> None:
        """Fail the pipeline, so that a consumer blocked in next_block
        wakes."""
        if self._handle:
            self._lib.ingest_push_abort(self._handle)

    def drive_push(self, fetch, total: int = -1,
                   fetch_bytes: int = 1 << 20) -> None:
        """Run the whole push loop in C++ (``ingest_drive_push``):
        ``fetch(offset, view)`` fills a writable memoryview of up to
        ``fetch_bytes`` of the pipeline's buffer with the stream's bytes at
        ``offset`` and returns how many it wrote, 0 at the end of the
        stream (an end before ``total``, when that is known, fails the
        pipeline); the pipeline then sees end of stream. An exception from
        ``fetch`` aborts the pipeline and is raised here."""
        errors = []

        def trampoline(_ctx, offset, dst, want):
            try:
                view = memoryview(
                    (ctypes.c_char * want).from_address(dst)).cast("B")
                return int(fetch(offset, view))
            except BaseException as err:  # noqa: BLE001 (raised below)
                errors.append(err)
                return -1

        rc = self._lib.ingest_drive_push(self._live(), FETCH_FN(trampoline),
                                         None, total, fetch_bytes)
        if errors:
            raise errors[0]
        if rc != 0:
            raise DMLCError(f"native ingest drive_push failed rc={rc}")

    # ---- blocks --------------------------------------------------------
    def next_block(self) -> Optional[dict]:
        rows = ctypes.c_int64()
        nnz = ctypes.c_int64()
        ncols = ctypes.c_int64()
        flags = ctypes.c_int32()
        rc = self._lib.ingest_peek(
            self._live(), ctypes.byref(rows), ctypes.byref(nnz),
            ctypes.byref(ncols), ctypes.byref(flags))
        if rc == 0:
            return None
        if rc < 0:
            raise DMLCError(f"native ingest pipeline failed rc={rc}")
        n, z, fl = rows.value, nnz.value, flags.value
        ptrs = [ctypes.c_void_p() for _ in range(7)]
        block = self._lib.ingest_fetch_view(
            self._live(), *[ctypes.byref(q) for q in ptrs])
        if not block:
            raise DMLCError("ingest_fetch_view with no staged block")
        owner = _NativeBlock(self._lib, block)
        (labels_p, weights_p, qids_p, offsets_p, indices_p, values_p,
         fields_p) = (q.value for q in ptrs)
        if self._fmt == INGEST_CSV:
            table = _block_view(owner, values_p, n * ncols.value,
                                ctypes.c_float, np.float32)
            return {"table": table.reshape(n, ncols.value)}
        out = {
            "labels": _block_view(owner, labels_p, n, ctypes.c_float,
                                  np.float32),
            "offsets": _block_view(owner, offsets_p, n + 1, ctypes.c_int64,
                                   np.int64),
            "indices": _block_view(owner, indices_p, z, ctypes.c_uint32,
                                   np.uint32),
            "values": _block_view(owner, values_p, z, ctypes.c_float,
                                  np.float32),
            "flags": fl,
        }
        if self._fmt in (INGEST_LIBSVM, INGEST_RECORDIO):
            if fl & HAS_WEIGHT:
                out["weights"] = _block_view(owner, weights_p, n,
                                             ctypes.c_float, np.float32)
            if fl & HAS_QID:
                out["qids"] = _block_view(owner, qids_p, n, ctypes.c_int64,
                                          np.int64)
        else:
            out["fields"] = _block_view(owner, fields_p, z, ctypes.c_uint32,
                                        np.uint32)
        return out

    # ---- fixed-shape batch staging --------------------------------------
    def stage_batch(self, batch_size: int):
        """Stage the next batch → (rows, nnz), None at the end of the
        stream; rows = min(batch_size, rows left). The matching fetch
        consumes it."""
        rows = ctypes.c_int64()
        nnz = ctypes.c_int64()
        rc = self._lib.ingest_stage_batch(
            self._live(), batch_size, ctypes.byref(rows), ctypes.byref(nnz))
        if rc == 0:
            return None
        if rc < 0:
            raise DMLCError(f"native ingest pipeline failed rc={rc}")
        return rows.value, nnz.value

    def fetch_batch_dense(self, batch_size: int, num_features: int,
                          x=None, labels=None, weights=None):
        """Consume the staged batch densified to [batch, F] → (x, labels,
        weights, rows); rows past ``rows`` are zero (weight 0). The arrays
        are written in place when given (pinned staging), else made."""
        x = _out(x, (batch_size, num_features), np.float32)
        labels = _out(labels, batch_size, np.float32)
        weights = _out(weights, batch_size, np.float32)
        rows = self._lib.ingest_fetch_batch_dense(
            self._live(), _ptr(x), _ptr(labels), _ptr(weights), batch_size,
            num_features)
        if rows < 0:
            raise DMLCError(f"native dense batch fetch failed rc={rows}")
        return x, labels, weights, int(rows)

    def fetch_batch_coo(self, batch_size: int, nnz_bucket: int, labels=None,
                        weights=None, indices=None, values=None,
                        row_ids=None, offsets=None):
        """Consume the staged batch as padded COO → (labels, weights,
        indices, values, row_ids, offsets, rows); offsets is the
        [batch_size + 1] CSR twin of row_ids. Arrays given are written in
        place."""
        labels = _out(labels, batch_size, np.float32)
        weights = _out(weights, batch_size, np.float32)
        indices = _out(indices, nnz_bucket, np.int32)
        values = _out(values, nnz_bucket, np.float32)
        row_ids = _out(row_ids, nnz_bucket, np.int32)
        offsets = _out(offsets, batch_size + 1, np.int32)
        rows = self._lib.ingest_fetch_batch_coo(
            self._live(), _ptr(labels), _ptr(weights), _ptr(indices),
            _ptr(values), _ptr(row_ids), _ptr(offsets), batch_size,
            nnz_bucket)
        if rows < 0:
            raise DMLCError(f"native coo batch fetch failed rc={rows}")
        return labels, weights, indices, values, row_ids, offsets, int(rows)

    def staged_max_shard_nnz(self, batch_size: int, num_shards: int) -> int:
        """The largest per-shard nnz of the staged batch under a row-range
        split."""
        out = self._lib.ingest_staged_max_shard_nnz(
            self._live(), batch_size, num_shards)
        if out < 0:
            raise DMLCError("bad sharded staging arguments")
        return int(out)

    def fetch_batch_coo_sharded(self, batch_size: int, num_shards: int,
                                nnz_bucket: int):
        """Consume the staged batch partitioned per shard → (labels,
        weights, indices, values, row_ids, offsets, rows): flat
        [num_shards * nnz_bucket] entry arrays with LOCAL row ids, and flat
        [num_shards * (batch / num_shards + 1)] local CSR offsets."""
        labels = np.empty(batch_size, dtype=np.float32)
        weights = np.empty(batch_size, dtype=np.float32)
        total = num_shards * nnz_bucket
        indices = np.empty(total, dtype=np.int32)
        values = np.empty(total, dtype=np.float32)
        row_ids = np.empty(total, dtype=np.int32)
        offsets = np.empty(num_shards * (batch_size // num_shards + 1),
                           dtype=np.int32)
        rows = self._lib.ingest_fetch_batch_coo_sharded(
            self._live(), _ptr(labels), _ptr(weights), _ptr(indices),
            _ptr(values), _ptr(row_ids), _ptr(offsets), batch_size,
            num_shards, nnz_bucket)
        if rows < 0:
            raise DMLCError(f"native sharded coo fetch failed rc={rows}")
        return labels, weights, indices, values, row_ids, offsets, int(rows)

    def stats(self) -> dict:
        """The pipeline's seven stage counters (:data:`STATS_KEYS`)."""
        out = np.zeros(len(STATS_KEYS), dtype=np.float64)
        self._lib.ingest_stats(self._live(), _ptr(out), len(STATS_KEYS))
        return {k: (int(v) if k in ("bytes_read", "chunks") else float(v))
                for k, v in zip(STATS_KEYS, out)}

    @property
    def bytes_read(self) -> int:
        if not self._handle:
            return self._closed_bytes_read
        return int(self._lib.ingest_bytes_read(self._handle))

    def close(self) -> None:
        if self._handle:
            handle, self._handle = self._handle, None
            self._closed_bytes_read = int(
                self._lib.ingest_bytes_read(handle))
            self._lib.ingest_close(handle)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

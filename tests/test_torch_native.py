"""The port's native core (``dmlc_tpu_torch/native``) against the JAX
package's library (``dmlc_tpu.native``, which builds ``cpp/`` itself when
its ``.so`` is missing): the same C++ built with the same flags, so every
comparison here is bit for bit (``tobytes``), or the same error.

- the library: built from ``native/csrc`` into ``native/_build/``, never
  ``cpp/libdmlc_tpu.so``; the ABI gate tracks the port's header; a file
  that is not the library is refused; a failed build raises with the
  compiler's output; the C++ reads no environment variable; both packages'
  libraries live in one process, each handle bound to its own file;
- the chunk parsers over the corpora of ``tests/test_native.py`` and
  ``tests/test_parse_parity.py`` (fixed, seeded random, huge and denormal
  numbers, leading-zero runs, compensating exponents, long fractions),
  and in a subprocess against the JAX library's scalar tier
  (``DMLC_TPU_SIMD=0`` set for it alone: the port's tier is CPUID's);
- RecordIO pack / unpack / find-head against the JAX library and the
  port's Python framing;
- the JAX package's C++ unit tier (``cpp/unit_tests.cc``) compiled against
  the port's copy, and its ASan and TSan builds where the toolchain has
  their runtimes.
"""

import ctypes
import ctypes.util
import os
import random
import shutil
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

import test_parse_parity as tpp
from dmlc_tpu import native as ref_native
from dmlc_tpu.io import recordio as ref_recordio
from dmlc_tpu_torch import native
from dmlc_tpu_torch.io import recordio
from dmlc_tpu_torch.io.stream import MemoryStream
from dmlc_tpu_torch.native import _build
from dmlc_tpu_torch.utils.logging import DMLCError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "dmlc_tpu_torch", "native", "csrc")


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The JAX package with its library loaded, at its default tier."""
    monkeypatch.delenv("DMLC_TPU_NATIVE", raising=False)
    monkeypatch.delenv("DMLC_TPU_NATIVE_LIB", raising=False)
    assert ref_native.available()


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------


def _dladdr_file(fn) -> str:
    """The file the dynamic linker mapped a function pointer from."""

    class DlInfo(ctypes.Structure):
        _fields_ = [("dli_fname", ctypes.c_char_p),
                    ("dli_fbase", ctypes.c_void_p),
                    ("dli_sname", ctypes.c_char_p),
                    ("dli_saddr", ctypes.c_void_p)]

    libdl = ctypes.CDLL(None)
    libdl.dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(DlInfo)]
    info = DlInfo()
    assert libdl.dladdr(ctypes.cast(fn, ctypes.c_void_p), ctypes.byref(info))
    return os.path.realpath(info.dli_fname.decode())


def test_library_is_built_from_the_ports_sources():
    path = native.library_path()
    build_dir = os.path.join(REPO, "dmlc_tpu_torch", "native", "_build")
    assert os.path.dirname(os.path.realpath(path)) == build_dir
    assert path.name.startswith("libdmlc_native_") and path.suffix == ".so"
    assert _build.build_log_path().exists()
    # each handle's functions come from its own file
    port_file = _dladdr_file(native.get_lib().parse_libsvm)
    ref_file = _dladdr_file(ref_native.get_lib().parse_libsvm)
    assert port_file == os.path.realpath(path)
    assert ref_file == os.path.realpath(
        os.path.join(REPO, "cpp", "libdmlc_tpu.so"))
    # the loaded port library never maps cpp/'s
    maps = open("/proc/self/maps").read()
    assert os.path.realpath(path) in maps


def test_symbols_bind_inside_each_library():
    """-Wl,-Bsymbolic and -fno-gnu-unique: the port's library exports the
    same names as the JAX package's, yet no unique symbol is shared and
    the dynamic section asks for symbolic binding."""
    out = subprocess.run(["readelf", "-dW", str(native.library_path())],
                         capture_output=True, text=True)
    if out.returncode != 0:
        pytest.skip("readelf unavailable")
    assert "SYMBOLIC" in out.stdout
    syms = subprocess.run(["nm", "-D", "--defined-only",
                           str(native.library_path())],
                          capture_output=True, text=True).stdout
    assert " u " not in syms
    assert " T parse_libsvm" in syms


def test_abi_gate_tracks_the_ports_header(tmp_path, monkeypatch):
    header = open(native.HEADER).read()
    version = native.expected_abi_version()
    assert "#define DMLC_TPU_ABI_VERSION %d" % version in header
    assert native.get_lib().dmlc_tpu_abi_version() == version
    bumped = tmp_path / "dmlc_tpu.h"
    bumped.write_text(header.replace(
        "#define DMLC_TPU_ABI_VERSION %d" % version,
        "#define DMLC_TPU_ABI_VERSION %d" % (version + 1)))
    monkeypatch.setattr(native, "HEADER", bumped)
    with pytest.raises(DMLCError, match="ABI version"):
        native.load_library(native.library_path())


def test_a_garbage_library_is_rejected(tmp_path):
    junk = tmp_path / "libjunk.so"
    junk.write_bytes(b"\x7fELF this is not a shared object" * 10)
    with pytest.raises(DMLCError, match="cannot load"):
        native.load_library(junk)
    # a real shared object that is not the native core
    with pytest.raises(DMLCError, match="not the native core"):
        native.load_library(ctypes.util.find_library("m"))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cc").write_text("int f() { return undefined_name; }\n")
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(DMLCError, match="undefined_name"):
        _build.ensure_built()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_the_cxx_reads_no_environment():
    for name in os.listdir(CSRC):
        text = open(os.path.join(CSRC, name)).read()
        assert "getenv" not in text, name
        for knob in ("DMLC_TPU_SIMD\"", "DMLC_TPU_MMAP", "MALLOC_TUNE",
                     "BLOCK_POOL"):
            assert knob not in text, (name, knob)


# every code line the port's copy adds to cpp/: an env-gated expression
# replaced by its default, and the shuffle reader's stop check moved out of
# the lock that FinishReader takes again (the reference's reader deadlocks
# there when a shuffled pipeline closes during its segment scan)
_ADDED_CODE = {
    "pipeline.cc": {
        "pool_->cap = static_cast<size_t>(out_capacity_ + nthread_ + 4);",
        "bool stopped;", "stopped = stop_ || error_ != 0;", "}",
        "if (stopped) {", "FinishReader(0);", "return true;",
        "if (nfiles != 1) return nullptr;"},
    "parse.cc": {"if (len >= 256 && SimdKernelLevel() >= 2 && "
                 "ProbeLongIds(data, len)) {"},
}


@pytest.mark.parametrize("name", ["dmlc_tpu.h", "parse_common.h", "parse.cc",
                                  "parse_simd.cc", "recordio.cc",
                                  "pipeline.cc"])
def test_the_copy_keeps_the_references_code(name):
    """Everything but the getenv sites, the one deadlock fix and comments
    is the JAX package's code: the lines the copy adds are those above."""
    import difflib

    ref = open(os.path.join(REPO, "cpp", name)).read().splitlines()
    port = open(os.path.join(CSRC, name)).read().splitlines()
    added = {ln[2:].strip() for ln in difflib.ndiff(ref, port)
             if ln.startswith("+ ")}
    code = {ln for ln in added if ln and not ln.startswith(("//", "/*", "*"))}
    assert code <= _ADDED_CODE.get(name, set()), code


def test_a_closed_pipeline_never_hands_its_handle_to_the_cxx(tmp_path):
    """Closed (as the garbage collector may close it before a parser that
    still reads it), the pipeline keeps its byte count and refuses every
    other call with DMLCError instead of passing a freed handle on."""
    path = tmp_path / "c.svm"
    path.write_text("".join("%d 1:%d\n" % (i % 2, i) for i in range(50)))
    pipe = native.IngestPipeline([str(path)], [path.stat().st_size],
                                 native.INGEST_LIBSVM, 0, 1)
    while pipe.next_block() is not None:
        pass
    read = pipe.bytes_read
    pipe.close()
    assert read == path.stat().st_size == pipe.bytes_read
    for call in (pipe.next_block, pipe.stats, lambda: pipe.stage_batch(4),
                 lambda: pipe.fetch_batch_dense(4, 2), pipe.push_eof):
        with pytest.raises(DMLCError, match="closed"):
            call()
    pipe.push_abort()
    pipe.close()


def test_closing_a_shuffled_pipeline_before_any_read_returns(tmp_path):
    path = tmp_path / "s.svm"
    path.write_text("".join("%d 1:%d 3:0.5\n" % (i % 2, i)
                            for i in range(400)))
    for _ in range(3):
        pipe = native.IngestPipeline([str(path)], [path.stat().st_size],
                                     native.INGEST_LIBSVM, 0, 1,
                                     shuffle_seed=3)
        done = []
        closer = threading.Thread(target=lambda: (pipe.close(),
                                                  done.append(1)),
                                  daemon=True)
        closer.start()
        closer.join(10)
        assert done, "ingest_close did not return"


def test_simd_level_is_the_cpus():
    level = native.simd_level()
    assert level in (0, 2)
    flags = open("/proc/cpuinfo").read()
    has = all(f in flags.split() for f in ("avx2", "bmi1", "bmi2"))
    assert level == (2 if has else 0)


# ---------------------------------------------------------------------------
# the chunk parsers, bit for bit
# ---------------------------------------------------------------------------


def _same(got, want, what):
    """Both None, or the same keys with the same dtype, shape and bytes."""
    assert (got is None) == (want is None), (what, got, want)
    if got is None:
        return
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert got.tobytes() == want.tobytes(), what
        return
    assert set(got) == set(want), what
    for key, val in want.items():
        if isinstance(val, np.ndarray):
            assert got[key].dtype == val.dtype, (what, key)
            assert got[key].tobytes() == val.tobytes(), (what, key)
        else:
            assert got[key] == val, (what, key)


def _outcome(fn, chunk):
    try:
        return "OK", fn(chunk)
    except Exception as err:  # noqa: BLE001 (error parity is the contract)
        return "ERR", type(err).__name__


def _check(port_fn, ref_fn, chunk):
    got, want = _outcome(port_fn, chunk), _outcome(ref_fn, chunk)
    assert got[0] == want[0], (got, want, chunk[:120])
    if got[0] == "ERR":
        assert got[1] == want[1], chunk[:120]
    else:
        _same(got[1], want[1], chunk[:120])


def _numeric_corpus():
    """Tokens that stress the number scan."""
    r = random.Random(11)
    toks = [b"1e-999999999", b"1e999999999", b"-4.5e-400", b"2e400",
            b"4.9e-324", b"2.2250738585072014e-308", b"1.17549435e-38",
            b"1.4e-45", b"3.4028235e38", b"3.4028236e38", b"0.1", b"-0.0",
            b"00000000000000000000001.5", b"0.000000000000000000000001",
            b"123456789012345678901234567890", b"1" + b"0" * 40 + b"e-40",
            b"0." + b"0" * 30 + b"1e30", b"12345678901234567890e-20",
            b"1.00000005960464477539062", b"1.0000000596046447753906251",
            b"9.999999999999999999999999999", b".5", b"5.", b"+3"]
    for _ in range(400):
        kind = r.randint(0, 5)
        if kind == 0:
            toks.append(("%.*f" % (r.randint(1, 25), r.random())).encode())
        elif kind == 1:
            toks.append(("%.17g" % (r.random() * 10 ** r.randint(-45, 39)))
                        .encode())
        elif kind == 2:
            zeros = b"0" * r.randint(1, 30)
            toks.append(zeros + str(r.randint(0, 10 ** 9)).encode())
        elif kind == 3:
            e = r.randint(-50, 50)
            mant = str(r.randint(1, 10 ** 12)).encode()
            toks.append(mant + b"e" + str(e).encode())
        elif kind == 4:
            # compensating exponents: many digits, an exponent undoing them
            digits = str(r.randint(10 ** 20, 10 ** 25)).encode()
            toks.append(digits + b"e-" + str(len(digits) - 1).encode())
        else:
            toks.append(("%g" % r.uniform(-5e-324, 5e-310)).encode())
    return toks


def _libfm_chunk(r):
    lines = []
    for _ in range(r.randint(0, 30)):
        feats = " ".join("%d:%d:%s" % (r.randint(0, 9), r.randint(0, 10 ** 6),
                                       r.choice(["1", "%.6f" % r.random(),
                                                 "%.3e" % r.random()]))
                         for _ in range(r.randint(0, 6)))
        lines.append(("%d %s" % (r.randint(0, 1), feats)).strip())
    return ("\n".join(lines) + "\n").encode()


class TestChunkParsers:
    def test_libsvm_fixed_corpus(self):
        chunks = list(tpp.TestLibSVMParity.FIXED) + [
            b"1 1:0.5 7:2.25\n0 3:1e-3 4:-2.5e2\n1 2:0.125\n",
            b"1:5.0 1:1 2:2\n0 3:3\n", b"2 qid:7 1:0.5 4\n1 qid:8 2\n",
            b"1 1:2\r\n\r\n0 2:3\n\n", b"notanumber 1:2\n"]
        for chunk in chunks:
            _check(native.parse_libsvm_chunk, ref_native.parse_libsvm_chunk,
                   chunk)

    @pytest.mark.parametrize("seed", range(4))
    def test_libsvm_seeded_random(self, seed):
        r = random.Random(1000 + seed)
        for _ in range(150):
            _check(native.parse_libsvm_chunk, ref_native.parse_libsvm_chunk,
                   tpp._libsvm_chunk(r))

    def test_numbers_huge_denormal_long(self):
        toks = _numeric_corpus()
        # one token a line, and one long line; big enough for the SIMD
        # engine's tile when the CPU has it
        chunks = [b"".join(b"1 %d:%s\n" % (i + 1000003, t)
                           for i, t in enumerate(toks)),
                  b"1 " + b" ".join(b"%d:%s" % (i + 1, t)
                                    for i, t in enumerate(toks)) + b"\n"]
        chunks += [b"1 1:%s\n" % t for t in toks]
        for chunk in chunks:
            _check(native.parse_libsvm_chunk, ref_native.parse_libsvm_chunk,
                   chunk)

    def test_criteo_shaped_chunk_on_the_simd_shape(self):
        """Long feature ids: the shape the first-line probe sends to the
        AVX2 engine."""
        rng = np.random.RandomState(5)
        lines = []
        for i in range(3000):
            ids = np.sort(rng.randint(1, 2 ** 20, 39))
            lines.append("%d %s" % (i % 2, " ".join(
                "%d:%s" % (j, rng.choice(["1", "%.6f" % rng.rand()]))
                for j in ids)))
        chunk = ("\n".join(lines) + "\n").encode()
        _check(native.parse_libsvm_chunk, ref_native.parse_libsvm_chunk,
               chunk)

    @pytest.mark.parametrize("seed", range(3))
    def test_libfm_seeded_random(self, seed):
        r = random.Random(2000 + seed)
        fixed = [b"", b"1 1:2:3\n", b"0 1:2\n", b"1 a:2:3\n", b"1 1:2:3:4\n",
                 b"1 1:2:nan\n", b"1\n0 3:4:0.5 3:4:0.25\n"]
        for chunk in fixed + [_libfm_chunk(r) for _ in range(100)]:
            _check(native.parse_libfm_chunk, ref_native.parse_libfm_chunk,
                   chunk)

    @pytest.mark.parametrize("seed", range(3))
    def test_csv_corpora(self, seed):
        r = random.Random(3000 + seed)
        chunks = list(tpp.TestCSVParity.FIXED) + [
            tpp._csv_chunk(r) for _ in range(150)]
        for chunk in chunks:
            _check(native.parse_csv_chunk, ref_native.parse_csv_chunk, chunk)

    def test_count_tokens(self):
        r = random.Random(9)
        for chunk in [b"", b"1 2 3\n4 5\n", b"  \n\t\n"] + [
                tpp._libsvm_chunk(r) for _ in range(50)]:
            lines, toks = ctypes.c_int64(), ctypes.c_int64()
            ref_native.get_lib().count_tokens(chunk, len(chunk),
                                              ctypes.byref(lines),
                                              ctypes.byref(toks))
            assert native.count_tokens(chunk) == (lines.value, toks.value)


_TIER_SCRIPT = textwrap.dedent("""
    import os, random, sys
    import numpy as np
    assert os.environ["DMLC_TPU_SIMD"] == "0"
    sys.path.insert(0, %(tests)r)
    import test_parse_parity as tpp
    from dmlc_tpu import native as ref_native
    from dmlc_tpu_torch import native
    assert ref_native.simd_level() == 0, ref_native.simd_level()
    assert native.simd_level() == %(port_level)d
    rng = np.random.RandomState(5)
    lines = []
    for i in range(2000):
        ids = np.sort(rng.randint(1, 2 ** 20, 39))
        lines.append("%%d %%s" %% (i %% 2, " ".join(
            "%%d:%%.6f" %% (j, rng.rand()) for j in ids)))
    chunks = [("\\n".join(lines) + "\\n").encode()]
    r = random.Random(77)
    chunks += [tpp._libsvm_chunk(r) for _ in range(300)]
    for chunk in chunks:
        try:
            got = native.parse_libsvm_chunk(chunk)
        except Exception as err:
            got = type(err).__name__
        try:
            want = ref_native.parse_libsvm_chunk(chunk)
        except Exception as err:
            want = type(err).__name__
        assert type(got) is type(want), (got, want)
        if isinstance(got, dict):
            for k in want:
                a, b = got[k], want[k]
                if isinstance(b, np.ndarray):
                    assert a.tobytes() == b.tobytes(), k
                else:
                    assert a == b, k
    print("tiers agree", len(chunks))
""")


def test_ports_tier_against_the_references_scalar_tier():
    """The JAX library at DMLC_TPU_SIMD=0 (scalar) in a subprocess; the
    port ignores the variable and keeps the CPU's tier. Together with the
    in-process cases (the JAX library's default tier) the port's tier is
    held against both of the reference's."""
    env = dict(os.environ, DMLC_TPU_SIMD="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    env.pop("DMLC_TPU_NATIVE", None)
    script = _TIER_SCRIPT % {"tests": os.path.join(REPO, "tests"),
                             "port_level": native.simd_level()}
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "tiers agree" in out.stdout


# ---------------------------------------------------------------------------
# RecordIO
# ---------------------------------------------------------------------------


def _records(kind):
    rng = np.random.RandomState(3)
    magic = recordio._MAGIC_BYTES
    if kind == "random":
        return [rng.bytes(int(rng.randint(0, 300))) for _ in range(300)]
    if kind == "magic":
        # the magic at aligned and unaligned offsets, at the ends, twice
        return [magic, magic * 3, b"ab" + magic + b"cd",
                b"abcd" + magic + b"efgh" + magic, magic + b"xyz",
                b"12345678" + magic, b"", b"a", b"abc" + magic * 2]
    return [b"", b"", b"x" * 1000]


@pytest.mark.parametrize("kind", ["random", "magic", "edge"])
def test_recordio_pack_unpack_find_head(kind):
    records = _records(kind)
    packed = native.recordio_pack_records(records)
    assert packed == ref_native.recordio_pack_records(records)
    # the port's Python framing writes the same bytes
    stream = MemoryStream()
    writer = recordio.RecordIOWriter(stream)
    for rec in records:
        writer.write_record(rec)
    assert stream.getvalue() == packed
    # write_records (the native batch) keeps except_counter too
    batch_stream = MemoryStream()
    batch = recordio.RecordIOWriter(batch_stream)
    batch.write_records(iter(records))
    assert batch_stream.getvalue() == packed
    assert batch.except_counter == writer.except_counter
    data, offsets, consumed = native.recordio_unpack_chunk(packed)
    ref_data, ref_offsets, ref_consumed = ref_native.recordio_unpack_chunk(
        packed)
    assert data == ref_data and consumed == ref_consumed == len(packed)
    assert offsets.tobytes() == ref_offsets.tobytes()
    assert [data[offsets[i]:offsets[i + 1]]
            for i in range(len(records))] == records
    for start in range(0, min(len(packed), 400), 4):
        assert (native.recordio_find_head(packed, start)
                == ref_native.recordio_find_head(packed, start))
    # the chunk reader over parts gives the JAX package's records
    for nparts in (1, 3):
        for part in range(nparts):
            got = list(recordio.RecordIOChunkReader(packed, part, nparts))
            want = list(ref_recordio.RecordIOChunkReader(packed, part,
                                                         nparts))
            assert got == want


def test_recordio_unpack_refuses_corrupt_framing():
    packed = native.recordio_pack_records([b"abcdefgh", b"ijkl"])
    bad = b"\x00\x00\x00\x00" + packed[4:]
    with pytest.raises(DMLCError):
        native.recordio_unpack_chunk(bad)
    with pytest.raises(Exception):
        ref_native.recordio_unpack_chunk(bad)
    assert native.recordio_find_head(b"\x00" * 64) == -1


# ---------------------------------------------------------------------------
# the reference's C++ unit tier over the port's copy
# ---------------------------------------------------------------------------

_HAVE_GXX = shutil.which("g++") is not None


def _build_unit(tmp_path, flags, name):
    """cpp/unit_tests.cc copied beside nothing else, so that its
    ``#include "dmlc_tpu.h"`` finds the port's header through -I."""
    src = tmp_path / "unit_tests.cc"
    shutil.copy(os.path.join(REPO, "cpp", "unit_tests.cc"), src)
    sources = sorted(os.path.join(CSRC, n) for n in os.listdir(CSRC)
                     if n.endswith(".cc"))
    exe = tmp_path / name
    return subprocess.run(
        ["g++", *flags, "-std=c++17", "-Wall", "-Wextra", "-I", CSRC,
         str(src), *sources, "-lpthread", "-o", str(exe)],
        capture_output=True, text=True, timeout=600), exe


@pytest.mark.skipif(not _HAVE_GXX, reason="no native toolchain")
def test_cpp_unit_tier_over_the_ports_copy(tmp_path):
    build, exe = _build_unit(tmp_path, ["-O2"], "unit_tests")
    assert build.returncode == 0, build.stderr
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "cpp unit tests ok" in run.stdout


@pytest.mark.skipif(not _HAVE_GXX, reason="no native toolchain")
@pytest.mark.parametrize("sanitizer", ["address,undefined", "thread"])
def test_cpp_sanitizer_tiers_over_the_ports_copy(tmp_path, sanitizer):
    """Skipped only when the toolchain lacks the sanitizer's runtime, as
    tests/test_cpp_unit.py is."""
    build, exe = _build_unit(
        tmp_path, ["-O1", "-g", "-fsanitize=" + sanitizer,
                   "-fno-omit-frame-pointer"], "unit_tests_san")
    if build.returncode != 0:
        pytest.skip(f"sanitizer build unavailable: {build.stderr[-200:]}")
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1")
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path, env=env)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "cpp unit tests ok" in run.stdout

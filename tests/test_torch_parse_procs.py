"""The port's process parse pool (``PipelinedParser(procs=N)``, the JAX
package's ``DMLC_TPU_PARSE_PROCS``) on the CPU.

- rows: libsvm, libfm and csv read through the pool equal the JAX
  package's pooled rows (its numpy parse, ``DMLC_TPU_PARSE_BACKEND=vector``,
  no native core, the pool armed for the reference alone) and the port's
  threads, block for block, bit for bit, over chunks small enough that
  many are in flight;
- errors: a bad token's error and the ``parse.chunk`` faultpoint surface at
  their chunk's position and poison the window, with the pool and without;
  ``DMLCError``, ``ValueError`` and ``InjectedFault`` raised in a pool
  process keep their types;
- the pipeline: the audit's chains are the threads' chains; an epoch
  replays through the same pool; a parser with no import path parses on
  the threads; ``create_parser(procs=2)`` takes the Python stack where the
  native route would; ``close`` leaves no process; a pool process imports
  neither JAX nor the JAX package;
- the kernels' build under its file lock: two processes that meet a cold
  build directory build once.

Each pooled parser spawns processes that import torch (and the JAX
package's, jax), a few seconds each, so the file keeps its pools few and
small, and each test has its own time limit.
"""

import multiprocessing
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from dmlc_tpu.data.parsers import PARSER_REGISTRY as REF_REGISTRY
from dmlc_tpu.data.pipeline import PipelinedParser as RefPipelinedParser
from dmlc_tpu.io.input_split import create_input_split as ref_create_split
from dmlc_tpu.io.uri_spec import URISpec as RefURISpec
from dmlc_tpu_torch.data import (PARSER_REGISTRY, LibSVMParser, Parser,
                                 PipelinedParser, RowBlockContainer,
                                 create_parser, create_row_block_iter)
from dmlc_tpu_torch.data.parsers import NativePipelineParser
from dmlc_tpu_torch.io import create_input_split
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.obs import audit
from dmlc_tpu_torch.resilience import InjectedFault, faults
from dmlc_tpu_torch.utils import DMLCError

import test_parse_parity as tpp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 4096  # test_parse_parity's chunk hint: many chunks in flight
TEST_SECONDS = 120  # each test's limit: a pool starts in a few seconds


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own time limit (SIGALRM in the main thread, where the
    consumer waits on the window): a pooled read that hangs fails its own
    test, not the run."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded %d s" % TEST_SECONDS)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_SECONDS)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def vector_backend(monkeypatch):
    """The JAX package's numpy parse, never its native core."""
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")


def _libfm_text(rng, rows):
    return "".join("%d %s\n" % (rng.randint(0, 2), " ".join(
        "%d:%d:%.4f" % (rng.randint(0, 5), rng.randint(0, 200), rng.rand())
        for _ in range(rng.randint(0, 6)))) for _ in range(rows))


def _csv_text(rng, rows):
    return "".join(",".join([str(rng.randint(0, 2))] + [
        "%.4f" % v for v in rng.randn(4)]) + "\n" for _ in range(rows))


def _write(tmp_path, fmt):
    """(path, uri args) of a corpus of several dozen 4096-byte chunks."""
    path = str(tmp_path / (fmt + ".txt"))
    if fmt == "libsvm":
        tpp._write_corpus(path, rows=2000, seed=9)
        return path, ""
    rng = np.random.RandomState(11)
    with open(path, "w") as fh:
        fh.write(_libfm_text(rng, 3000) if fmt == "libfm"
                 else _csv_text(rng, 3000))
    return path, "?label_column=0" if fmt == "csv" else ""


def _port(path, fmt="libsvm", args="", procs=0, nthread=2, chunk=CHUNK):
    split = create_input_split(path, 0, 1, "text", threaded=False)
    split.hint_chunk_size(chunk)
    base = PARSER_REGISTRY.find(fmt)(split, URISpec(path + args, 0, 1).args,
                                     1, "cpu")
    return PipelinedParser(base, nthread=nthread, procs=procs)


def _reference(monkeypatch, path, fmt, args, procs):
    """The JAX package's PipelinedParser with DMLC_TPU_PARSE_PROCS set
    while it latches it, and only then."""
    split = ref_create_split(path, 0, 1, "text", threaded=False)
    split.hint_chunk_size(CHUNK)
    base = REF_REGISTRY.find(fmt)(split, RefURISpec(path + args, 0, 1).args,
                                  1)
    monkeypatch.setenv("DMLC_TPU_PARSE_PROCS", str(procs))
    try:
        return RefPipelinedParser(base, nthread=2)
    finally:
        monkeypatch.delenv("DMLC_TPU_PARSE_PROCS")


def _drain(parser):
    try:
        blocks = list(parser)
        return blocks, parser.stats()
    finally:
        parser.close()


def _same_block(got, want):
    for name in ("offset", "label", "index", "value", "weight", "qid",
                 "field"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), name


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["libsvm", "libfm", "csv"])
def test_pooled_rows_equal_the_reference_pool_and_the_threads(
        tmp_path, monkeypatch, fmt):
    path, args = _write(tmp_path, fmt)
    pooled, stats = _drain(_port(path, fmt, args, procs=2))
    threads, thread_stats = _drain(_port(path, fmt, args))
    ref, ref_stats = _drain(_reference(monkeypatch, path, fmt, args, 2))
    assert stats["procs"] == ref_stats["procs"] == 2
    assert thread_stats["procs"] == 0
    assert stats["chunks"] == thread_stats["chunks"] == ref_stats["chunks"]
    assert len(pooled) == len(threads) == len(ref) > 10
    for got, thread, want in zip(pooled, threads, ref):
        _same_block(got, thread)
        _same_block(got, want)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


def _rows_before_error(parser, error):
    """Rows delivered before ``next_block`` raises ``error``; the window
    is poisoned after it: no block comes (the closed window refuses the
    next chunk, or there was none)."""
    rows = 0
    try:
        with pytest.raises(error) as info:
            while True:
                block = parser.next_block()
                assert block is not None, "the error never surfaced"
                rows += len(block)
        try:
            after = parser.next_block()
        except DMLCError as closed:
            assert "closed" in str(closed)
            after = None
        assert after is None
        return rows, info.value
    finally:
        parser.close()


def test_bad_token_surfaces_at_its_chunk_with_and_without_the_pool(
        tmp_path):
    path = str(tmp_path / "poison.svm")
    good = "\n".join("1 %d:1" % i for i in range(200))
    with open(path, "w") as fh:
        fh.write(good + "\nBADTOKEN 1:2\n" + good + "\n")
    got = {procs: _rows_before_error(_port(path, procs=procs, chunk=1024),
                                     ValueError)
           for procs in (0, 2)}
    assert got[0][0] == got[2][0] > 0
    assert str(got[0][1]) == str(got[2][1])


def test_parse_chunk_fault_poisons_at_its_chunk_with_the_pool(
        tmp_path, monkeypatch):
    """The faultpoint fires on the parent's worker thread: the third
    chunk fails, the two before it arrive."""
    path, _ = _write(tmp_path, "libsvm")
    blocks, _ = _drain(_port(path))
    monkeypatch.setenv("DMLC_TPU_FAULTS", "parse.chunk:nth=3")
    faults.reset()
    try:
        rows, _ = _rows_before_error(_port(path, procs=2), InjectedFault)
    finally:
        monkeypatch.delenv("DMLC_TPU_FAULTS")
        faults.reset()
    assert rows == len(blocks[0]) + len(blocks[1])


class RaisingParser(Parser):
    """Raises, in the pool process, the error a chunk's first line names
    (a class of this module: the pool process imports it by name)."""

    ERRORS = {b"dmlc": DMLCError, b"value": ValueError,
              b"injected": InjectedFault}

    def parse_chunk(self, chunk):
        raise self.ERRORS[chunk.split()[0]]("raised in a pool process")


@pytest.mark.parametrize("kind", ["dmlc", "value", "injected"])
def test_a_pool_process_error_keeps_its_type(tmp_path, kind):
    path = tmp_path / "x.txt"
    path.write_text(kind + "\n")
    split = create_input_split(str(path), 0, 1, "text", threaded=False)
    parser = PipelinedParser(RaisingParser(split, 1, "cpu"), procs=1)
    assert parser.stats()["procs"] == 1
    rows, err = _rows_before_error(parser, RaisingParser.ERRORS[kind.encode()])
    assert rows == 0 and type(err) is RaisingParser.ERRORS[kind.encode()]
    assert "raised in a pool process" in str(err)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def test_audit_chains_are_the_threads_chains(tmp_path, monkeypatch):
    path, _ = _write(tmp_path, "libsvm")
    monkeypatch.setenv("DMLC_TPU_AUDIT", "full")
    chains = {}
    try:
        for procs in (0, 2):
            audit.reset_auditor()
            _drain(_port(path, procs=procs))
            chains[procs] = audit.auditor().export()["chains"]
    finally:
        monkeypatch.delenv("DMLC_TPU_AUDIT")
        audit.reset_auditor()
    for stage in ("io_read", "parse"):
        assert chains[0][stage]["n"] > 10, stage
        # the parse chain's rolling head follows the workers' arrival order
        chains[0][stage].pop("head")
        chains[2][stage].pop("head")
        assert chains[0][stage] == chains[2][stage], stage


def _wait_for_no_children(seconds=30):
    """Let processes of earlier tests (the JAX package's pools, which it
    shuts down without waiting) exit."""
    for child in multiprocessing.active_children():
        child.join(seconds)


def test_an_epoch_replays_through_the_same_pool_and_close_ends_it(
        tmp_path):
    """Both processes start at the first chunk with one torch and one BLAS
    thread, serve a second epoch, and end with ``close()``."""
    _wait_for_no_children()
    assert multiprocessing.active_children() == []
    path, _ = _write(tmp_path, "libsvm")
    env = dict(os.environ)
    parser = _port(path, procs=2)
    try:
        first = list(parser)
        pool = parser._executor
        pids = {p.pid for p in multiprocessing.active_children()}
        assert pool is not None and len(pids) == 2
        # each process runs one torch and one BLAS thread; this process's
        # environment is as it was
        probe = ("(__import__('torch').get_num_threads(), "
                 "__import__('os').environ['OPENBLAS_NUM_THREADS'])")
        assert pool.submit(eval, probe).result() == (1, "1")
        assert dict(os.environ) == env
        parser.before_first()
        second = list(parser)
        assert parser._executor is pool
        assert {p.pid for p in multiprocessing.active_children()} == pids
        assert parser.stats()["chunks"] == 2 * len(first)
    finally:
        parser.close()
    assert multiprocessing.active_children() == []
    assert len(first) == len(second) > 10
    for a, b in zip(first, second):
        _same_block(a, b)
    with pytest.raises(DMLCError, match="closed"):
        parser.next_block()


def test_a_parser_with_no_import_path_parses_on_the_threads(tmp_path):
    class LocalParser(LibSVMParser):
        pass

    path, _ = _write(tmp_path, "libsvm")
    split = create_input_split(path, 0, 1, "text", threaded=False)
    split.hint_chunk_size(CHUNK)
    parser = PipelinedParser(LocalParser(split, 1, "cpu"), procs=2)
    blocks, stats = _drain(parser)
    assert stats["procs"] == 0 and parser._executor is None
    want, _ = _drain(_port(path))
    assert len(blocks) == len(want)
    for got, w in zip(blocks, want):
        _same_block(got, w)


def test_create_parser_with_procs_takes_the_python_stack(tmp_path):
    path, _ = _write(tmp_path, "libsvm")
    native = create_parser(path, device="cpu")
    assert isinstance(native, NativePipelineParser)
    native.close()
    parser = create_parser(path, device="cpu", procs=2)
    assert isinstance(parser, PipelinedParser)
    blocks, stats = _drain(parser)
    assert stats["procs"] == 2 and stats["nthread"] == 2
    it = create_row_block_iter(path, device="cpu")
    try:
        whole = RowBlockContainer()
        for block in blocks:
            whole.push_block(block)
        _same_block(whole.to_block(), next(iter(it)))
    finally:
        it.close()
    with pytest.raises(DMLCError, match="threaded"):
        create_parser(path, device="cpu", threaded=False, procs=2)
    with pytest.raises(DMLCError, match="procs"):
        create_parser(path, device="cpu", procs=-1)


def test_parse_cli_and_row_iter_take_procs(tmp_path, capsys, monkeypatch):
    """``parse --procs 1`` and ``create_row_block_iter(procs=1)`` hand the
    pool to create_parser."""
    from dmlc_tpu_torch.data import parsers
    from dmlc_tpu_torch.tools import parse

    path, _ = _write(tmp_path, "libsvm")
    seen = []
    real = parsers.create_parser

    def spy(*args, **kwargs):
        seen.append(kwargs.get("procs"))
        return real(*args, **kwargs)

    monkeypatch.setattr(parse, "create_parser", spy)
    assert parse.main([path, "--device", "cpu", "--procs", "1"]) == 0
    assert "2000 examples" in capsys.readouterr().out
    assert seen == [1]
    monkeypatch.setattr("dmlc_tpu_torch.data.row_iter.create_parser", spy)
    it = create_row_block_iter(path, device="cpu", procs=1)
    try:
        assert len(next(iter(it))) == 2000
    finally:
        it.close()
    assert seen == [1, 1]


def test_a_pool_process_imports_no_jax(tmp_path):
    """A pooled read in a process of the port alone: the pool's processes
    load neither jax nor the JAX package."""
    path, _ = _write(tmp_path, "libsvm")
    script = textwrap.dedent("""
        import sys
        from dmlc_tpu_torch.data import create_parser

        def main():
            parser = create_parser(sys.argv[1], device="cpu", procs=1)
            try:
                assert sum(len(b) for b in parser) == 2000
                probe = ("sorted(m for m in __import__('sys').modules "
                         "if m.split('.')[0] in ('jax', 'jaxlib', "
                         "'dmlc_tpu'))")
                print(parser._executor.submit(eval, probe).result())
            finally:
                parser.close()

        if __name__ == "__main__":
            main()
    """)
    (tmp_path / "pooled.py").write_text(script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, str(tmp_path / "pooled.py"), path],
                          capture_output=True, text=True, timeout=100,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# the kernels' build lock
# ---------------------------------------------------------------------------


def test_two_processes_at_a_cold_build_directory_build_once(tmp_path):
    """``ops/_build.ensure_built`` in two processes started together, with
    ``_build`` patched to log each call and write a stub library after a
    pause: one builds, the other waits for it and finds the library."""
    script = textwrap.dedent("""
        import os, sys, time
        from pathlib import Path
        from dmlc_tpu_torch.ops import _build

        tmp = Path(sys.argv[1])
        _build.BUILD_DIR = tmp / "build"

        def stub(target):
            with open(tmp / "builds.log", "a") as log:
                log.write("%d\\n" % os.getpid())
            time.sleep(1.0)
            target.write_bytes(b"stub")

        _build._build = stub
        (tmp / ("ready-%d" % os.getpid())).touch()
        while not (tmp / "go").exists():
            time.sleep(0.01)
        print(_build.ensure_built())
    """)
    (tmp_path / "build_once.py").write_text(script)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "build_once.py"), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for _ in range(2)]
    try:
        # both at the line before ensure_built, then both let go
        while len(list(tmp_path.glob("ready-*"))) < 2:
            assert all(p.poll() is None for p in procs), "a process died"
            time.sleep(0.01)
        (tmp_path / "go").touch()
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    built = {out.strip() for out, _ in outs}
    assert len(built) == 1
    assert (tmp_path / "builds.log").read_text().count("\n") == 1
    assert open(built.pop(), "rb").read() == b"stub"

"""Build the native core of ``native/csrc`` at first use.

Every ``*.cc`` file is compiled by its own ``g++`` process (the one on
``PATH``: the host compiler ``nvcc`` uses on a CUDA machine), all started
together, with the flags of the JAX package's ``cpp/Makefile``
(``-O3 -std=c++17 -fPIC -Wall -Wextra``), and the objects link into one
shared library (``-shared -lpthread``) loaded with ctypes. Two link-time
flags keep it apart from the JAX package's ``libdmlc_tpu.so`` when a process
loads both (the tests do), since both export the same names:
``-Wl,-Bsymbolic`` binds the library's own calls and data to itself, and
``-fno-gnu-unique`` keeps its function-local tables out of the process-wide
unique-symbol table. Neither changes the code the compiler emits, so the
parse gives the JAX package's library's bits.

The library lands in ``native/_build/`` under a name keyed by a hash of the
sources and flags, with the compiler's output in a ``.log`` beside it. One
build at a time holds a file lock, so processes and threads that race to
build wait for it and load its result; the library is written under a
temporary name and renamed. A failed build raises DMLCError carrying the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

from dmlc_tpu_torch.utils.logging import DMLCError

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-fno-gnu-unique"]
LINK_FLAGS = ["-shared", "-Wl,-Bsymbolic"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
#: seconds the build in this process took; None when the library was cached
build_seconds: Optional[float] = None


def find_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise DMLCError("g++ not found on PATH: the native core cannot be "
                        "built")
    return cxx


def _sources():
    return sorted(SRC_DIR.glob("*.cc")), sorted(SRC_DIR.glob("*.h"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256()
    ccs, headers = _sources()
    for path in ccs + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LINK_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libdmlc_native_{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def _compile(target: Path) -> None:
    global build_seconds
    cxx = find_cxx()
    ccs, _ = _sources()
    if not ccs:
        raise DMLCError(f"no C++ sources under {SRC_DIR}")
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in ccs:
            obj = work / (src.stem + ".o")
            cmd = [cxx, *CXX_FLAGS, "-I", str(SRC_DIR), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out.decode(errors='replace')}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise DMLCError("g++ failed for %s:\n%s"
                            % (", ".join(failed), "\n".join(log)))
        tmp_so = work / target.name
        link = subprocess.run(
            [cxx, *LINK_FLAGS, "-o", str(tmp_so),
             *[str(obj) for _src, obj, _p in procs], *LIBS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        log.append("== link\n" + link.stdout.decode(errors="replace"))
        if link.returncode != 0:
            raise DMLCError("linking the native core failed:\n"
                            + "\n".join(log))
        target.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_so, target)  # atomic: a concurrent loader sees all
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def ensure_built() -> Path:
    """The path of the library for the current sources, built on first
    use (under a file lock shared with other processes)."""
    target = library_path()
    if target.exists():
        return target
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not target.exists():
                _compile(target)
    return target

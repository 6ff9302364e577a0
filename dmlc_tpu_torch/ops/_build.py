"""Build the CUDA kernels of ``ops/csrc`` at first use.

Every ``*.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper); the objects link into one shared library
with a plain C interface, loaded with ctypes. The library lands in
``ops/_build/`` under a name keyed by a hash of the sources and flags, so a
checkout that holds only the sources builds it once and later processes
load it. One build at a time holds a file lock, so processes that meet a
cold build directory together (a parse pool's) wait for one build and load
its result. No ``torch`` headers are compiled: a build takes seconds.

A failed build raises DMLCError carrying nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: registers, shared memory and spills per kernel, kept in the
# build log beside the library
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
# the parse threads may all reach their first launch at once: one of them
# builds, the others wait for it
_lib_lock = threading.Lock()
#: seconds the build in this process took; None when the library was cached
build_seconds: Optional[float] = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise DMLCError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256()
    cus, headers = _sources()
    for path in cus + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdmlc_kernels_{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def _build(target: Path) -> None:
    global build_seconds
    nvcc = find_nvcc()
    cus, _ = _sources()
    if not cus:
        raise DMLCError(f"no CUDA sources under {SRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in cus:
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(SRC_DIR),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        log, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out.decode(errors='replace')}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise DMLCError("nvcc failed for %s:\n%s"
                            % (", ".join(failed), "\n".join(log)))
        tmp_so = work / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *[str(obj) for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise DMLCError("linking the CUDA kernels failed:\n"
                            + link.stdout.decode(errors="replace"))
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():
            _build(target)
    return target


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(ensure_built()))
    return _lib

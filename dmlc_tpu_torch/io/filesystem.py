"""Local files as streams: ``create_stream`` (``Stream::Create``,
src/io.cc), the local-file part of ``dmlc_tpu/io/filesystem.py``, with the
file operations the checkpoint code needs: :func:`list_dir`,
:func:`exists`, :func:`delete`, :func:`makedirs` and the crash-safe
:func:`atomic_write`.

A path is a plain path or a ``file://`` uri; any other scheme (s3://,
hdfs://, http://, ...) raises DMLCError: remote filesystems are not ported.
"""

from __future__ import annotations

import os
from typing import List, Optional

from dmlc_tpu_torch.io.stream import FileObjStream, Stream
from dmlc_tpu_torch.utils.logging import check


def local_path(uri: str) -> str:
    """The filesystem path of a local uri; raise for a remote scheme."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    check("://" not in uri, "only local files are supported, got %s", uri)
    return uri


def create_stream(uri: str, flag: str,
                  allow_null: bool = False) -> Optional[Stream]:
    """Open ``uri`` for reading ("r"), writing ("w") or appending ("a").
    With ``allow_null`` a missing file opened for reading gives None
    instead of raising FileNotFoundError."""
    check(flag in ("r", "w", "a"), "invalid open flag %s", flag)
    path = local_path(uri)
    try:
        return FileObjStream(open(path, flag + "b"))
    except FileNotFoundError:
        if allow_null and flag == "r":
            return None
        raise


def list_dir(uri: str) -> List[str]:
    """The names in directory ``uri``, sorted."""
    return sorted(os.listdir(local_path(uri)))


def exists(uri: str) -> bool:
    return os.path.exists(local_path(uri))


def delete(uri: str) -> None:
    """Remove the file ``uri``; a missing file is not an error."""
    try:
        os.remove(local_path(uri))
    except FileNotFoundError:
        pass


def makedirs(uri: str) -> None:
    os.makedirs(local_path(uri), exist_ok=True)


def atomic_write(uri: str, payload: bytes) -> None:
    """Write ``payload`` so that a crash never leaves a truncated file:
    a temporary file beside it, fsync, then ``os.replace``."""
    path = local_path(uri)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(payload)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)

"""Local files as streams: ``create_stream`` (``Stream::Create``,
src/io.cc), the local-file part of ``dmlc_tpu/io/filesystem.py``.

A path is a plain path or a ``file://`` uri; any other scheme (s3://,
hdfs://, http://, ...) raises DMLCError: remote filesystems are not ported.
"""

from __future__ import annotations

from typing import Optional

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

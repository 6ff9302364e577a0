"""Filesystem CLI: ``ls``, ``cat`` and ``cp`` over any registered uri
scheme (the port of ``dmlc_tpu/tools/filesys.py``; the reference's
test/filesys_test.cc:9-16)::

    python -m dmlc_tpu_torch.tools filesys ls <uri>
    python -m dmlc_tpu_torch.tools filesys cat <uri>
    python -m dmlc_tpu_torch.tools filesys cp <src-uri> <dst-uri>

``ls`` prints a line an entry (``file``/``dir``, size, uri); ``cp``
streams 4 MiB at a time and prints the bytes copied.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from dmlc_tpu_torch.io.filesystem import (FILE_TYPE_DIR, URI, create_stream,
                                          create_stream_for_read,
                                          get_filesystem)

_CHUNK = 4 << 20


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    cmd = argv[0]
    if cmd == "ls":
        uri = URI.parse(argv[1])
        for info in get_filesystem(uri).list_directory(uri):
            kind = "dir " if info.type == FILE_TYPE_DIR else "file"
            print(f"{kind} {info.size:>12} {info.path.str_full()}")
        return 0
    if cmd == "cat":
        with create_stream_for_read(argv[1]) as stream:
            while True:
                data = stream.read(_CHUNK)
                if not data:
                    break
                sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
        return 0
    if cmd == "cp":
        if len(argv) < 3:
            print("cp needs <src> <dst>", file=sys.stderr)
            return 2
        copied = 0
        with create_stream_for_read(argv[1]) as src, \
                create_stream(argv[2], "w") as dst:
            while True:
                data = src.read(_CHUNK)
                if not data:
                    break
                dst.write(data)
                copied += len(data)
        print(f"copied {copied} bytes")
        return 0
    print(f"unknown subcommand {cmd!r} (ls/cat/cp)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())

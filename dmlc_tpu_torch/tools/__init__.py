"""Command-line tools of the port, the counterparts of ``dmlc_tpu/tools``
that exist so far:

| command    | module                    | does                                        |
|------------|---------------------------|---------------------------------------------|
| ``bake``     | ``tools/bake.py``           | text corpus -> ``.dtsh`` shards              |
| ``dispatch`` | ``tools/dispatch.py``       | the data service's chunk lease tables        |
| ``filesys``  | ``tools/filesys.py``        | ls / cat / cp over any uri scheme            |
| ``parity``   | ``tools/parity.py``         | socket-engine world vs one process, ulps    |
| ``recordio`` | ``tools/recordio.py``       | RecordIO round trip (recordio_test.cc)      |
| ``rowrec``   | ``tools/rowrec.py``         | dataset -> row-group RecordIO               |
| ``serve``    | ``tools/serve.py``          | a parse host or fleet worker over TCP        |

Run ``python -m dmlc_tpu_torch.tools <command> [args]`` (or ``python -m
dmlc_tpu_torch.tools.<module>``); each module's ``main(argv) -> int``
runs in-process too. The tools that parse text, and ``dispatch``, take
``--device`` (the card unless ``--device cpu``).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from dmlc_tpu_torch.utils.logging import DMLCError

_COMMANDS = {
    "bake": "dmlc_tpu_torch.tools.bake",
    "dispatch": "dmlc_tpu_torch.tools.dispatch",
    "filesys": "dmlc_tpu_torch.tools.filesys",
    "parity": "dmlc_tpu_torch.tools.parity",
    "recordio": "dmlc_tpu_torch.tools.recordio",
    "rowrec": "dmlc_tpu_torch.tools.rowrec",
    "serve": "dmlc_tpu_torch.tools.serve",
}


def main(argv: Optional[List[str]] = None) -> int:
    """Run one command; a command the port lacks raises DMLCError naming
    the ported ones."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", " ".join(sorted(_COMMANDS)))
        return 0 if argv else 2
    cmd = argv[0]
    if cmd not in _COMMANDS:
        raise DMLCError(f"unknown or unported command {cmd!r}; the port "
                        f"has: {' '.join(sorted(_COMMANDS))}")
    import importlib

    return importlib.import_module(_COMMANDS[cmd]).main(argv[1:])

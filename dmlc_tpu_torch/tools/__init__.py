"""Command-line tools of the port, the counterparts of ``dmlc_tpu/tools``
(the reference's ``test/*.cc`` tier-2 harnesses among them):

| command        | module                    | does                                    |
|----------------|---------------------------|-----------------------------------------|
| ``audit_report`` | ``tools/audit_report.py``   | render determinism-audit bundles         |
| ``bake``         | ``tools/bake.py``           | text corpus -> ``.dtsh`` shards          |
| ``bench_gate``   | ``tools/bench_gate.py``     | bench record vs its history (sentry)     |
| ``dataiter``     | ``tools/dataiter.py``       | RowBlockIter epochs through the feed     |
| ``dispatch``     | ``tools/dispatch.py``       | the data service's chunk lease tables    |
| ``filesys``      | ``tools/filesys.py``        | ls / cat / cp over any uri scheme        |
| ``obs_report``   | ``tools/obs_report.py``     | post-run report: dumps, traces, a plane  |
| ``obs_top``      | ``tools/obs_top.py``        | live per-rank table of a status server   |
| ``parity``       | ``tools/parity.py``         | socket-engine world vs one process, ulps |
| ``parse``        | ``tools/parse.py``          | parser MB/s (libsvm, libfm, csv, ...)    |
| ``recordio``     | ``tools/recordio.py``       | RecordIO round trip (recordio_test.cc)   |
| ``rowrec``       | ``tools/rowrec.py``         | dataset -> row-group RecordIO            |
| ``serve``        | ``tools/serve.py``          | a parse host or fleet worker over TCP    |
| ``split_read``   | ``tools/split_read.py``     | InputSplit record MB/s                   |
| ``stream_read``  | ``tools/stream_read.py``    | Stream read / write MB/s                 |
| ``strtonum``     | ``tools/strtonum.py``       | number-scan fuzz against ``float()``     |

Run ``python -m dmlc_tpu_torch.tools <command> [args]`` (or ``python -m
dmlc_tpu_torch.tools.<module>``); a command may be spelled with ``-`` for
``_`` (``obs-report``, ``obs-top``, ``audit-report``, the JAX package's
names). Each module's ``main(argv) -> int`` runs in-process too. The tools that parse text, and ``serve``, take
``--device`` (the card unless ``--device cpu``).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from dmlc_tpu_torch.utils.logging import DMLCError

_COMMANDS = {
    "audit_report": "dmlc_tpu_torch.tools.audit_report",
    "bake": "dmlc_tpu_torch.tools.bake",
    "bench_gate": "dmlc_tpu_torch.tools.bench_gate",
    "dataiter": "dmlc_tpu_torch.tools.dataiter",
    "dispatch": "dmlc_tpu_torch.tools.dispatch",
    "filesys": "dmlc_tpu_torch.tools.filesys",
    "obs_report": "dmlc_tpu_torch.tools.obs_report",
    "obs_top": "dmlc_tpu_torch.tools.obs_top",
    "parity": "dmlc_tpu_torch.tools.parity",
    "parse": "dmlc_tpu_torch.tools.parse",
    "recordio": "dmlc_tpu_torch.tools.recordio",
    "rowrec": "dmlc_tpu_torch.tools.rowrec",
    "serve": "dmlc_tpu_torch.tools.serve",
    "split_read": "dmlc_tpu_torch.tools.split_read",
    "stream_read": "dmlc_tpu_torch.tools.stream_read",
    "strtonum": "dmlc_tpu_torch.tools.strtonum",
}


def main(argv: Optional[List[str]] = None) -> int:
    """Run one command; a command the port lacks raises DMLCError naming
    the ported ones."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", " ".join(sorted(_COMMANDS)))
        return 0 if argv else 2
    cmd = argv[0].replace("-", "_")
    if cmd not in _COMMANDS:
        raise DMLCError(f"unknown or unported command {argv[0]!r}; the port "
                        f"has: {' '.join(sorted(_COMMANDS))}")
    import importlib

    return importlib.import_module(_COMMANDS[cmd]).main(argv[1:])

"""The job submitter, the port of ``dmlc_tpu/tracker/submit.py``
(tracker/dmlc_tracker/submit.py): configures logging (submit.py:13-36)
and hands the options to the cluster's launcher (submit.py:43-56).

    python -m dmlc_tpu_torch.tracker.submit --cluster local -n 2 \\
        [--max-attempts 2] [--elastic --spares 1] [--status-port P] \\
        python train.py ...

The clusters: ``local``, ``gpu`` (one process per card, ``--gpu-hosts``),
``ssh``, ``mpi``, ``sge``, ``slurm``, ``yarn``, ``mesos``, ``kubernetes``.
``--status-port`` sets DMLC_TPU_STATUS_PORT, which arms the tracker's
status plane (obs/plane.py); ``--elastic`` sets DMLC_TPU_ELASTIC for the
tracker and, through the inherited env, for every task.
"""

from __future__ import annotations

import logging
import os
import sys

from dmlc_tpu_torch.tracker.launchers import get_launcher
from dmlc_tpu_torch.tracker.opts import get_opts


def config_logger(args) -> None:
    fmt = "%(asctime)-15s %(message)s"
    level = logging.DEBUG if args.log_level == "DEBUG" else logging.INFO
    logging.basicConfig(format=fmt, level=level)
    if args.log_file:
        handler = logging.FileHandler(args.log_file)
        handler.setFormatter(logging.Formatter(fmt))
        logging.getLogger().addHandler(handler)


def submit(args) -> None:
    # the tracker is built deep inside the launcher: it reads the env
    if args.status_port is not None:
        os.environ["DMLC_TPU_STATUS_PORT"] = str(args.status_port)
    if args.elastic:
        os.environ["DMLC_TPU_ELASTIC"] = "1"
    get_launcher(args.cluster).submit(args)


def main(argv=None) -> None:
    try:
        args = get_opts(argv)
    except ValueError as err:
        print(f"dmlc_tpu_torch.tracker.submit: {err}", file=sys.stderr)
        raise SystemExit(2)
    config_logger(args)
    submit(args)


if __name__ == "__main__":
    main()

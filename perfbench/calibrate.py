"""Read the numbers that set the limits deciding ``correct``, at a cell's
own size, on the card. The benchmark's own runs do not run this.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds <s>]

For each seed it reads the cell's numbers, as its job compares them, for:

- ``sound``: a run of the cell as it stands (``run.main``, a window of
  ``--seconds``);
- each fault of ``perfbench/faults.py`` that the cell's job can have,
  planted underneath the same run as the tests plant it;
- ``control``: the reference computed in bfloat16, the nearest precision
  below the configuration's float32, put in the program's place and
  compared with the reference in float32, on the rows a run makes.

Prints one JSON line a seed and kind: {"workload", "seed", "kind",
"correct", "checks"}.
"""

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from perfbench import faults, run  # noqa: E402
from perfbench.lib import bench  # noqa: E402


def fm_control(cfg: dict, seed: int, device) -> dict:
    from perfbench.reference import compare
    from perfbench.reference import fm as reference

    job = bench.load_module("jobs", "fm_fit")
    rows = job.make_rows(cfg, seed)
    start = job.start_params(cfg, seed, device)
    args = (rows.labels, rows.ids, rows.values, start, cfg["batch_size"],
            job.FIRST_STEPS, cfg["learning_rate"], cfg["l2"], device)
    ref = reference.sgd_steps(*args)
    ctrl = reference.sgd_steps(*args, dtype=torch.bfloat16)
    return compare.sgd_checks(ctrl["loss"], ctrl["params"], ref,
                              cfg["learning_rate"])


def gbdt_control(cfg: dict, seed: int, device) -> dict:
    from perfbench.gen import higgs
    from perfbench.reference import gbdt as reference

    job = bench.load_module("jobs", "gbdt_fit")
    xd, yd = higgs.higgs_rows(cfg["rows"], cfg["features"], seed, device,
                              cfg["data_seed"])
    ref_edges = reference.quantile_edges(xd, cfg["num_bins"])
    bins = reference.bin_rows(xd, ref_edges)
    ctrl_edges = reference.quantile_edges(xd.bfloat16(), cfg["num_bins"])
    del xd
    ref = reference.boost(bins, yd, job.FIRST_TREES, cfg)
    ctrl = reference.boost(bins, yd, job.FIRST_TREES, cfg,
                           dtype=torch.bfloat16)
    trees = {k: np.stack(ctrl[k]) for k in ("feature", "bin", "leaf")}
    return job.gbdt_checks(ctrl_edges, ctrl["loss"], trees, ref, ref_edges,
                           bins, cfg)


CONTROLS = {"fm_fit": fm_control, "gbdt_fit": gbdt_control}


def run_checks(workload: str, seed: int, seconds: float, device,
               overrides) -> dict:
    """The result line of one run of the cell in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", "0"],
                      device=device, overrides=overrides)
    if rc != 0:
        raise RuntimeError("run of %s exited %d" % (workload, rc))
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main(argv=None, device=None, overrides=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    cfg.update(overrides or {})
    if device is None:
        if not torch.cuda.is_available():
            print("needs a CUDA device", file=sys.stderr)
            sys.exit(3)
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    limits = cfg.get("limits", {})
    lines = []

    def emit(seed, kind, checks, correct):
        line = {"workload": args.workload, "seed": seed, "kind": kind,
                "correct": correct, "checks": checks}
        print(json.dumps(line), flush=True)
        lines.append(line)

    for seed in args.seeds:
        got = run_checks(args.workload, seed, args.seconds, device,
                         overrides)
        emit(seed, "sound", {k: v["value"] for k, v in got["checks"].items()},
             got["correct"])
        for fault in faults.BY_JOB[cell["job"]]:
            with pytest.MonkeyPatch.context() as mp:
                fault(mp)
                got = run_checks(args.workload, seed, args.seconds, device,
                                 overrides)
            emit(seed, fault.__name__, {k: v["value"] for k, v in
                                        got["checks"].items()},
                 got["correct"])
        checks = CONTROLS[cell["job"]](cfg, seed, device)
        emit(seed, "control", checks, all(
            v <= limits[k] for k, v in checks.items()))
    return lines


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark of ``dmlc_tpu_torch`` on this machine's
card(s) and print its result as the last line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is ``perfbench/cells/<cell>.json``: its configuration
(``perfbench/configs/<config>.json``), its job (``perfbench/jobs/
<job>.py``) and its traffic. The job sets up from the seed, measures for
``--seconds``, and works out the numbers that decide ``correct`` against
the plain reference in ``perfbench/reference/``. With ``--trace 0`` the
result carries the cell's end-to-end metrics of ``BENCHMARK.json``; with
``--trace 1`` its per-layer metrics, each read by
``perfbench/metrics/<metric>.py``, with the device's busy seconds and the
trace's breakdown. The numbers compared are printed beside their limits,
as the last lines of standard error and under ``checks``, the result's
last key. Without a CUDA device, or with fewer than the cell asks for,
it exits 3 and prints no result; with JAX or the JAX package loaded, 4.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path.pop(0)  # the package is imported as perfbench.*
sys.path.insert(0, str(ROOT))

from perfbench.lib import bench  # noqa: E402

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_limits(checks: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number compared; a number
    with no limit, or not a finite number, fails."""
    out = {}
    for name, value in checks.items():
        out[name] = {"value": value, "limit": limits.get(name)}
    return out


def passed(checks: dict) -> bool:
    return all(c["limit"] is not None and isinstance(c["value"], (int, float))
               and math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def value_of(values: dict, name: str):
    """The job's value of a metric. A name split by cell, such as
    ``rows_per_s.text``, is the job's ``rows_per_s`` where the job gives
    no value under the whole name."""
    if name in values:
        return values[name]
    return values.get(name.split(".", 1)[0])


def read_layer_fn(metrics: list):
    """The per-layer readers of the cell's metrics, as one callable that
    the job runs while its state is alive."""
    def read(readings: dict) -> dict:
        return {m["name"]: bench.load_module("metrics", m["name"]).read(
            readings) for m in metrics}
    return read


def main(argv=None, device=None, data_dir=None, overrides=None) -> int:
    """Run the cell. ``device`` (a torch device), ``data_dir`` and
    ``overrides`` (configuration keys) replace the card, the temporary
    directory and the configuration's sizes: for the tests, which run a
    cell small on the CPU."""
    args = parse_args(argv)
    spec = bench.benchmark()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload),
                 None)
    if entry is None:
        print("no workload %r in BENCHMARK.json" % args.workload,
              file=sys.stderr)
        return 2
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    config.update(overrides or {})

    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < entry["chips"]:
            print("needs %d CUDA device(s); found %d" % (
                entry["chips"], torch.cuda.device_count()
                if torch.cuda.is_available() else 0), file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kind = "trace" if args.trace else "end_to_end"
    metrics = bench.metrics_of(spec, "per_layer" if args.trace
                               else "end_to_end", args.workload)
    own_dir = data_dir is None
    if own_dir:
        data_dir = tempfile.mkdtemp(prefix="perfbench-")
    try:
        job = bench.load_module("jobs", cell["job"])
        out = job.run(SimpleNamespace(
            cell=cell, config=config, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device=device, data_dir=data_dir,
            t_process=T_PROCESS, read_layer=read_layer_fn(metrics)))
    finally:
        if own_dir:
            shutil.rmtree(data_dir, ignore_errors=True)

    found = bench.forbidden_loaded()
    if found:
        print("the process holds %s: the benchmark runs without JAX and "
              "the JAX package" % ", ".join(found), file=sys.stderr)
        return 4
    values = out["per_layer"] if args.trace else out["end_to_end"]
    result_metrics = {}
    for m in metrics:
        value = value_of(values, m["name"])
        if value is not None:
            result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = check_limits(out["checks"], config.get("limits", {}))
    correct = passed(checks) and out["failed"] == 0 and all(
        math.isfinite(v["value"]) for v in result_metrics.values())
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        "count": entry["chips"],
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": result_metrics,
            "device": dev_info}
    if out.get("trace"):
        dev_info["busy_s"] = out["trace"]["busy_s"]
        dev_info["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = checks
    print("%s %s: %s" % (args.workload, kind,
                         "correct" if correct else "NOT correct"),
          file=sys.stderr)
    for name, c in checks.items():
        print("check %s %r limit %r" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

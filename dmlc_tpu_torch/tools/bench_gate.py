"""bench-gate, the port of ``dmlc_tpu/tools/bench_gate.py``: fail when a
fresh bench record regresses against its history (obs/sentry.py: per
metric the median ± MAD of the last ``--window`` records), with a ranked
report. Host only.

Usage::

    python -m dmlc_tpu_torch.tools bench_gate \\
        --fresh bench_detail.json --history 'BENCH_r*.json'
    python -m dmlc_tpu_torch.tools bench_gate --smoke

The fresh record defaults to ``$DMLC_TPU_BENCH_DETAIL``, else
``$DMLC_TPU_BENCH_DIR/bench_detail.json``, else the newest history
record; a fresh record with no history is advisory (exit 0). ``--smoke``
checks the gate on the canned record pair: the clean one must pass, the
degraded twin must trip the headline and the stall stage. Exit 0 = within
tolerance, 1 = a regression, 2 = nothing to gate.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

from dmlc_tpu_torch.obs import sentry


def _default_fresh() -> Optional[str]:
    path = os.environ.get("DMLC_TPU_BENCH_DETAIL")
    if path and os.path.exists(path):
        return path
    bench_dir = os.environ.get("DMLC_TPU_BENCH_DIR")
    if bench_dir:
        path = os.path.join(bench_dir, "bench_detail.json")
        if os.path.exists(path):
            return path
    return None


def _smoke() -> int:
    series = sentry.metric_series(sentry.SMOKE_HISTORY)
    clean = sentry.gate(
        sentry.record_values(sentry.SMOKE_HISTORY[-1]), series)
    degraded = sentry.gate(
        sentry.record_values(sentry.smoke_degraded()), series)
    failures = []
    if clean:
        failures.append(
            "clean canned record flagged: %s" % [r["metric"] for r in clean])
    if not any(r["metric"] == "higgs_libsvm_ingest" for r in degraded):
        failures.append("20%% headline regression not caught")
    if not any(r["metric"] == "stall.host_wait_s" for r in degraded):
        failures.append("doubled stall stage not caught")
    if failures:
        for f in failures:
            print("bench-gate --smoke FAILED: %s" % f)
        return 1
    print("bench-gate --smoke OK: clean record passes, degraded record "
          "trips %d regression(s)" % len(degraded))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="bench-gate",
        description="noise-aware perf regression gate over bench history")
    ap.add_argument(
        "--fresh",
        help="fresh record (bench_detail.json or BENCH_r*.json; default "
             "$DMLC_TPU_BENCH_DETAIL, else the newest history record)")
    ap.add_argument(
        "--history", action="append", default=[],
        help="history file or glob; repeatable (default BENCH_r*.json)")
    ap.add_argument("--rel-tol", type=float, default=sentry.DEFAULT_REL_TOL,
                    help="relative tolerance floor (default %(default)s)")
    ap.add_argument("--mad-mult", type=float,
                    default=sentry.DEFAULT_MAD_MULT,
                    help="MAD multiplier (default %(default)s)")
    ap.add_argument("--window", type=int, default=sentry.DEFAULT_WINDOW,
                    help="recent rounds per baseline (default %(default)s)")
    ap.add_argument("--min-samples", type=int,
                    default=sentry.DEFAULT_MIN_SAMPLES,
                    help="history points required to gate a metric "
                         "(default %(default)s)")
    ap.add_argument("--smoke", action="store_true",
                    help="self-check on the canned record pair and exit")
    args = ap.parse_args(argv)

    if args.smoke:
        return _smoke()

    patterns = args.history or ["BENCH_r*.json"]
    paths: List[str] = []
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        paths.extend(hits if hits else ([pat] if os.path.exists(pat) else []))
    history = sentry.load_records(paths)
    fresh_path = args.fresh or _default_fresh()
    if fresh_path:
        fresh_recs = sentry.load_record(fresh_path)
        if not fresh_recs:
            print("bench-gate: no parseable record in %s" % fresh_path,
                  file=sys.stderr)
            return 2
        fresh_rec = fresh_recs[-1]
    elif history:
        fresh_rec = history[-1]
        fresh_path = fresh_rec.get("source", "<history tail>")
    else:
        print("bench-gate: no fresh record and no history "
              "(looked at: %s)" % ", ".join(patterns), file=sys.stderr)
        return 2

    if not history:
        # a first round has nothing to gate against: advisory, not a fail
        print("bench-gate ADVISORY: no history to gate %s against "
              "(looked at: %s); record it as the first baseline round"
              % (fresh_path, ", ".join(patterns)))
        return 0

    series = sentry.metric_series(history)
    # the fresh record's direction map wins, history fills the gaps
    directions = sentry.record_directions(history + [fresh_rec])
    regressions = sentry.gate(
        sentry.record_values(fresh_rec), series,
        rel_tol=args.rel_tol, mad_mult=args.mad_mult,
        window=args.window, min_samples=args.min_samples,
        directions=directions)
    if regressions:
        print(sentry.format_report(regressions, fresh_source=fresh_path))
        return 1
    print("bench-gate OK: %s within tolerance of %d history record(s)"
          % (fresh_path, len(history)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

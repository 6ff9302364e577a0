"""``python -m dmlc_tpu_torch.tools obs-report``, the port of
``dmlc_tpu/tools/obs_report.py``: a post-run job report.

Renders a human-readable summary of a job's observability artifacts:

- ``--flightrec DIR`` — scan ``flightrec-rank*.json`` crash dumps
  (obs/flight.py): per-rank dump reason, resilience-event totals
  (faults injected, retry give-ups, recoveries, checkpoint fallbacks),
  and the tail of recorded spans.
- ``--trace FILE`` — a merged job trace (the status server's ``/trace``
  download, or any Chrome-trace JSON): per-stage time by rank and the
  cross-rank slack table, widest stage first — the critical-path view.
- ``--status HOST:PORT`` — fetch ``/workers``, ``/data`` (the data
  dispatcher's worker/lease/requeue view, when one is attached — plus a
  per-job ledger table on multi-tenant fleets), and
  ``/trace`` from a *live* tracker status server instead of files; also
  renders the device
  telemetry section (per-rank first calls of the instrumented step sites
  and recompile anomalies, device memory, H2D bandwidth —
  obs/device_telemetry.py) from ``/metrics``.
- ``--top`` — with ``--status``: render the same per-rank table the live
  ``obs-top`` tool shows, once (the non-live fallback).
- ``--attribution`` — with ``--status``: fetch ``/goodput`` and render
  the per-rank + job-rolled stage-budget/roofline attribution tables
  (obs/goodput.py — the same code path the bench detail record and
  obs-top's goodput column use), binding constraint flagged per window.
- ``--xla`` — with ``--status``: fetch ``/xla`` and render the per-rank
  per-jit-site compiled-program cost tables (flops, bytes accessed,
  peak program bytes, in-graph collective bytes — obs/xla_cost.py's
  compile-time records).
- ``--audit`` — with ``--status``: fetch ``/audit`` and render the
  determinism audit plane's per-rank digest-chain summary + fork table
  (obs/audit.py — the same view ``audit-report --status`` renders);
  without ``--status``, scan the ``--flightrec`` dir (or cwd) for
  ``audit-rank*.json`` replay bundles instead.
- ``--diff A B`` — compare two traces (e.g. the last good run's
  ``/trace`` download vs the regressed run's): per-stage total time
  delta, biggest eater first — "which stage ate the regression", the
  follow-up question a failing bench-gate raises.

Exit 0 with a report, 2 when no artifact source yields anything (for
``--diff``, when either trace is unreadable).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

_RESILIENCE_KINDS = ("fault.injected", "retry.giveup", "collective.recover",
                     "ckpt.fallback", "uncaught", "service.requeue",
                     "service.worker_dead")


def _load_flightrecs(dirpath: str) -> List[Dict]:
    dumps = []
    for path in sorted(glob.glob(os.path.join(dirpath,
                                              "flightrec-rank*.json"))):
        try:
            with open(path) as fh:
                obj = json.load(fh)
        except (OSError, ValueError) as err:
            print(f"obs-report: skipping unreadable {path}: {err}",
                  file=sys.stderr)
            continue
        obj["_path"] = path
        dumps.append(obj)
    return dumps


def _report_flightrecs(dumps: List[Dict]) -> None:
    print("== flight recorder dumps ==")
    for obj in dumps:
        records = obj.get("records", [])
        kinds: Dict[str, int] = {}
        for rec in records:
            kinds[rec.get("kind", "?")] = kinds.get(rec.get("kind", "?"),
                                                    0) + 1
        print(f"rank {obj.get('rank', '?')}: reason={obj.get('reason')} "
              f"records={len(records)} ({obj['_path']})")
        resil = {k: v for k, v in kinds.items() if k in _RESILIENCE_KINDS}
        if resil:
            print("  resilience events: " + " ".join(
                f"{k}={v}" for k, v in sorted(resil.items())))
        tail = [r for r in records if r.get("kind") == "span"][-5:]
        if tail:
            print("  last spans: " + " ".join(
                str(r.get("name")) for r in tail))
        for rec in records:
            if rec.get("kind") == "uncaught":
                print(f"  uncaught: {rec.get('error')}: "
                      f"{rec.get('message')}")


def _report_reassignments(dumps: List[Dict]) -> None:
    """Chunk-reassignment event table from the flight-recorder dumps:
    every ``service.requeue`` the data dispatcher recorded (seq, the
    state the lease was in, which worker/client held it, how many times
    that chunk has requeued), plus worker-death events."""
    rows = []
    deaths = []
    for obj in dumps:
        for rec in obj.get("records", []):
            if rec.get("kind") == "service.requeue":
                rows.append(rec)
            elif rec.get("kind") == "service.worker_dead":
                deaths.append(rec)
    if not rows and not deaths:
        return
    print("== data service reassignments ==")
    for rec in deaths:
        print(f"worker {rec.get('worker')} ({rec.get('addr')}) "
              "declared dead")
    if rows:
        print(f"{'seq':>5} {'state':<10} {'worker':>6} {'client':>6} "
              f"{'requeues':>8}")
        for rec in rows:
            # multi-tenant dispatchers tag the event with the job name;
            # pre-fleet dumps have no tag and render exactly as before
            job = f"  job={rec['job']}" if rec.get("job") else ""
            print(f"{str(rec.get('seq')):>5} {str(rec.get('state')):<10} "
                  f"{str(rec.get('worker')):>6} "
                  f"{str(rec.get('client')):>6} "
                  f"{str(rec.get('requeues')):>8}{job}")


def _report_data(data: Dict) -> bool:
    """The ``/data`` endpoint rendered: dispatcher chunk accounting,
    per-worker liveness/lease counts, and the lease table rows that are
    not yet acked (the interesting ones post-mortem)."""
    if not data.get("attached"):
        return False
    if "error" in data:
        print(f"== data service: dispatcher error: {data['error']} ==")
        return True
    chunks = data.get("chunks", {})
    print("== data service ==")
    print("chunks: total=%s queued=%s leased=%s delivered=%s acked=%s | "
          "requeued=%s rejects=%s dup_acks=%s"
          % (chunks.get("total"), chunks.get("queued"),
             chunks.get("leased"), chunks.get("delivered"),
             chunks.get("acked"), data.get("requeued"),
             data.get("rejects"), data.get("duplicate_acks")))
    workers = data.get("workers", {})
    if workers:
        print(f"{'worker':>6} {'addr':<22} {'live':>5} {'lag_s':>7} "
              f"{'leased':>6}")
        for wid, info in sorted(workers.items(), key=lambda kv: kv[0]):
            print(f"{wid:>6} {str(info.get('addr')):<22} "
                  f"{str(info.get('live')):>5} {str(info.get('lag_s')):>7} "
                  f"{str(info.get('leased')):>6}")
    stuck = [row for row in data.get("lease_table", [])
             if row.get("state") != "acked" or row.get("requeues")]
    if stuck:
        print(f"{'seq':>5} {'state':<10} {'worker':>6} {'client':>6} "
              f"{'requeues':>8}")
        for row in stuck:
            print(f"{str(row.get('seq')):>5} {str(row.get('state')):<10} "
                  f"{str(row.get('worker')):>6} "
                  f"{str(row.get('client')):>6} "
                  f"{str(row.get('requeues')):>8}")
    jobs = data.get("jobs", {})
    if len(jobs) > 1 or (jobs and "default" not in jobs):
        # multi-tenant fleet: one ledger line per job, so a stalled or
        # throttled tenant is visible without untangling the aggregates
        print("== data service jobs ==")
        print(f"{'job':<14} {'epoch':>5} {'weight':>6} {'cap':>4} "
              f"{'queued':>6} {'infl':>5} {'acked':>6} {'requeued':>8} "
              f"{'busy':>5}")
        for name, job in sorted(jobs.items(),
                                key=lambda kv: kv[1].get("jid", 0)):
            chunks = job.get("chunks", {})
            inflight = (chunks.get("leased", 0) or 0) + \
                (chunks.get("delivered", 0) or 0)
            cap = job.get("max_inflight", 0)
            print(f"{name:<14} {str(job.get('epoch')):>5} "
                  f"{job.get('weight', 1.0):>6.1f} "
                  f"{(str(cap) if cap else '-'):>4} "
                  f"{str(chunks.get('queued')):>6} {inflight:>5} "
                  f"{str(chunks.get('acked')):>6} "
                  f"{str(job.get('requeued')):>8} "
                  f"{str(job.get('busy')):>5}")
    return True


def _stage_table(events: List[Dict]) -> Dict[str, Dict[int, float]]:
    per_stage: Dict[str, Dict[int, float]] = {}
    for e in events:
        if e.get("ph") not in (None, "X"):
            continue
        name = e.get("name", "?")
        rank = int(e.get("pid", 0))
        per_stage.setdefault(name, {}).setdefault(rank, 0.0)
        per_stage[name][rank] += float(e.get("dur", 0.0))
    return per_stage


def _report_trace(trace_obj: Dict) -> bool:
    events = trace_obj.get("traceEvents", [])
    per_stage = _stage_table(events)
    if not per_stage:
        print("== trace: no complete spans ==")
        return False
    print(f"== critical path ({len(events)} spans) ==")
    rows = []
    for name, per_rank in per_stage.items():
        slack = max(per_rank.values()) - min(per_rank.values())
        rows.append((slack, name, per_rank))
    rows.sort(reverse=True)
    print(f"{'stage':<28} {'slack_ms':>10} {'max_rank':>8}  per-rank ms")
    for slack, name, per_rank in rows[:15]:
        mx_rank = max(per_rank, key=lambda r: per_rank[r])
        per = " ".join(f"{r}:{v / 1e3:.1f}"
                       for r, v in sorted(per_rank.items()))
        print(f"{name:<28} {slack / 1e3:>10.1f} {mx_rank:>8}  {per}")
    return True


def _load_trace(path: str) -> Optional[Dict]:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError) as err:
        print(f"obs-report: cannot read trace {path}: {err}",
              file=sys.stderr)
        return None


def _report_diff(path_a: str, path_b: str) -> bool:
    """Critical-path delta table between two traces: per-stage total
    duration summed across ranks, sorted by how much B grew over A."""
    obj_a = _load_trace(path_a)
    obj_b = _load_trace(path_b)
    if obj_a is None or obj_b is None:
        return False
    totals = []
    for obj in (obj_a, obj_b):
        per_stage = _stage_table(obj.get("traceEvents", []))
        totals.append(
            {name: sum(per.values()) for name, per in per_stage.items()}
        )
    tot_a, tot_b = totals
    stages = sorted(set(tot_a) | set(tot_b))
    if not stages:
        print("== trace diff: no complete spans in either trace ==")
        return False
    rows = []
    for name in stages:
        a = tot_a.get(name, 0.0)
        b = tot_b.get(name, 0.0)
        pct = ((b - a) / a * 100.0) if a else float("inf")
        rows.append((b - a, pct, name, a, b))
    rows.sort(reverse=True)
    print(f"== trace diff: {path_a} -> {path_b} ==")
    print(f"{'stage':<28} {'A_ms':>10} {'B_ms':>10} {'delta_ms':>10} "
          f"{'delta':>8}")
    for delta, pct, name, a, b in rows:
        pct_s = f"{pct:+.0f}%" if pct != float("inf") else "new"
        print(f"{name:<28} {a / 1e3:>10.1f} {b / 1e3:>10.1f} "
              f"{delta / 1e3:>+10.1f} {pct_s:>8}")
    return True


def _report_workers(workers: Dict[str, Dict]) -> None:
    # /workers nests the per-rank map under "workers" next to the
    # membership header (world_version, ...); older flat payloads keep
    # the ranks at top level
    ranks = workers.get("workers", workers)
    print("== workers ==")
    print(f"{'rank':>4} {'lag_s':>8} {'straggler':>9} {'epoch':>6} "
          f"{'spans':>6} {'dropped':>7}")
    for rank, info in sorted(ranks.items(), key=lambda kv: int(kv[0])):
        print(f"{rank:>4} {str(info.get('lag_s')):>8} "
              f"{str(info.get('straggler')):>9} "
              f"{str(info.get('epoch')):>6} {str(info.get('spans')):>6} "
              f"{str(info.get('spans_dropped')):>7}")


def _fetch(status: str, endpoint: str) -> Optional[Dict]:
    from urllib.request import urlopen

    url = f"http://{status}{endpoint}"
    try:
        with urlopen(url, timeout=10) as resp:
            return json.loads(resp.read())
    except (OSError, ValueError) as err:
        print(f"obs-report: fetching {url} failed: {err}", file=sys.stderr)
        return None


def _fetch_metrics_text(status: str) -> Optional[str]:
    from urllib.request import urlopen

    url = f"http://{status}/metrics"
    try:
        with urlopen(url, timeout=10) as resp:
            return resp.read().decode("utf-8", "replace")
    except OSError as err:
        print(f"obs-report: fetching {url} failed: {err}", file=sys.stderr)
        return None


def _report_device(metrics_text: str) -> bool:
    """Device telemetry section from the merged ``/metrics`` text:
    per-rank compile totals (with the per-fn breakdown), recompile
    anomalies, device memory, and H2D transfer totals."""
    from dmlc_tpu_torch.tools.obs_top import parse_metrics

    samples = parse_metrics(metrics_text)
    per_rank: Dict[int, Dict] = {}
    fn_compiles: Dict[str, float] = {}
    for name, labels, value in samples:
        if "rank" not in labels:
            continue
        try:
            rank = int(labels["rank"])
        except ValueError:
            continue
        row = per_rank.setdefault(rank, {
            "compiles": 0.0, "recompiles": 0.0, "hbm": 0.0, "h2d_mb": 0.0})
        if name == "dmlc_xla_compiles_total":
            row["compiles"] += value
            fn = labels.get("fn", "?")
            fn_compiles[fn] = fn_compiles.get(fn, 0.0) + value
        elif name == "dmlc_xla_recompiles_total":
            row["recompiles"] += value
        elif name in ("dmlc_device_hbm_bytes", "dmlc_device_live_bytes"):
            row["hbm"] = max(row["hbm"], value)
        elif name == "dmlc_feed_h2d_bytes_total":
            row["h2d_mb"] += value / 1e6
    if not per_rank:
        return False
    print("== device telemetry ==")
    print(f"{'rank':>4} {'compiles':>8} {'recomp':>6} {'mem_MB':>8} "
          f"{'h2d_MB':>9}")
    for rank, row in sorted(per_rank.items()):
        print(f"{rank:>4} {int(row['compiles']):>8d} "
              f"{int(row['recompiles']):>6d} {row['hbm'] / 1e6:>8.1f} "
              f"{row['h2d_mb']:>9.1f}")
    if fn_compiles:
        print("  compiles by fn: " + " ".join(
            f"{fn}={int(v)}" for fn, v in sorted(fn_compiles.items())))
    return True


def _report_xla(xla_obj: Dict) -> bool:
    """The ``/xla`` endpoint rendered: one per-jit-site compiled-program
    cost table per reporting rank (flops, bytes accessed, peak program
    bytes, in-graph collective bytes — obs/xla_cost.py), plus the
    serving process's local record cache when it has one."""
    def _table(label: str, sites: Dict[str, Dict]) -> None:
        print(f"{label}:")
        print(f"{'fn':<28} {'flops':>12} {'bytes_acc':>12} "
              f"{'peak_MB':>8} {'coll_B':>10}")
        for fn in sorted(sites):
            rec = sites[fn] or {}
            print(f"{fn:<28} {rec.get('flops', 0.0):>12.3g} "
                  f"{rec.get('bytes_accessed', 0.0):>12.3g} "
                  f"{rec.get('peak_bytes', 0.0) / 1e6:>8.1f} "
                  f"{rec.get('collective_bytes', 0.0):>10.3g}")

    ranks = xla_obj.get("ranks") or {}
    local = (xla_obj.get("local") or {}).get("sites") or {}
    if not ranks and not local:
        print("== xla cost: no compiled sites reported yet ==")
        return False
    print("== xla cost attribution ==")
    for rank in sorted(ranks, key=lambda r: int(r)):
        _table(f"rank {rank}", ranks[rank])
    if local:
        _table("local", local)
    return True


def _report_attribution(goodput_obj: Dict) -> bool:
    """The ``/goodput`` endpoint rendered: one stage-budget/roofline
    table per reporting rank plus the job-rolled view, through the one
    shared formatter (goodput.format_attribution) every surface uses."""
    from dmlc_tpu_torch.obs import goodput

    ranks = goodput_obj.get("ranks") or {}
    job = goodput_obj.get("job")
    if not ranks and not job:
        print("== goodput: no attribution windows yet ==")
        return False
    print("== goodput attribution ==")
    for rank in sorted(ranks, key=lambda r: int(r)):
        att = ranks[rank]
        if att:
            print(goodput.format_attribution(att, label=f"rank {rank}"))
    if job:
        print(goodput.format_attribution(job, label="job"))
    return True


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="obs-report", description="Render a post-run job report from "
        "observability artifacts.")
    parser.add_argument("--flightrec", default=None,
                        help="Directory holding flightrec-rank*.json dumps.")
    parser.add_argument("--trace", default=None,
                        help="Merged Chrome-trace JSON (the /trace "
                        "download).")
    parser.add_argument("--status", default=None,
                        help="host:port of a live tracker status server.")
    parser.add_argument("--diff", nargs=2, metavar=("A", "B"),
                        default=None,
                        help="Two trace files: print the per-stage "
                        "critical-path delta table (B relative to A).")
    parser.add_argument("--top", action="store_true",
                        help="With --status: render the obs-top per-rank "
                        "table once (non-live fallback).")
    parser.add_argument("--attribution", action="store_true",
                        help="With --status: render the /goodput per-rank "
                        "+ job-rolled stage-budget attribution tables.")
    parser.add_argument("--audit", action="store_true",
                        help="Render the determinism audit plane: /audit "
                        "with --status, else audit-rank*.json bundles "
                        "under --flightrec (or the cwd).")
    parser.add_argument("--xla", action="store_true",
                        help="With --status: render the /xla per-site "
                        "compiled-program cost tables (flops, bytes, "
                        "peak memory, in-graph collective bytes).")
    args = parser.parse_args(argv)
    if (args.top or args.attribution or args.xla) and not args.status:
        print("obs-report: --top/--attribution/--xla need --status",
              file=sys.stderr)
        return 2
    reported = False
    if args.diff:
        reported = _report_diff(args.diff[0], args.diff[1])
    if args.status:
        workers = _fetch(args.status, "/workers")
        if workers is not None:
            _report_workers(workers)
            reported = True
        metrics_text = _fetch_metrics_text(args.status)
        if metrics_text is not None:
            reported = _report_device(metrics_text) or reported
            if args.top:
                from dmlc_tpu_torch.tools.obs_top import build_rows, render_table

                rows, _ = build_rows(metrics_text, workers)
                wv = (workers or {}).get("world_version")
                print("== obs-top (one frame) ==")
                print(render_table(rows, world_version=wv))
                reported = True
        if args.attribution:
            goodput_obj = _fetch(args.status, "/goodput")
            if goodput_obj is not None:
                reported = _report_attribution(goodput_obj) or reported
        if args.xla:
            xla_obj = _fetch(args.status, "/xla")
            if xla_obj is not None:
                reported = _report_xla(xla_obj) or reported
        if args.audit:
            audit_obj = _fetch(args.status, "/audit")
            if audit_obj is not None:
                from dmlc_tpu_torch.tools import audit_report

                print("== determinism audit ==")
                audit_report._render_view(audit_obj)
                reported = True
        data = _fetch(args.status, "/data")
        if data is not None:
            reported = _report_data(data) or reported
        trace_obj = _fetch(args.status, "/trace")
        if trace_obj is not None:
            reported = _report_trace(trace_obj) or reported
    if args.flightrec:
        dumps = _load_flightrecs(args.flightrec)
        if dumps:
            _report_flightrecs(dumps)
            _report_reassignments(dumps)
            reported = True
    if args.trace:
        trace_obj = _load_trace(args.trace)
        if trace_obj is not None:
            reported = _report_trace(trace_obj) or reported
    if args.audit and not args.status:
        from dmlc_tpu_torch.tools import audit_report

        bundles = audit_report._find_bundles(
            [args.flightrec] if args.flightrec else [])
        if bundles:
            print("== determinism audit bundles ==")
            for path in bundles:
                try:
                    audit_report._render_bundle(path)
                except (OSError, ValueError) as err:
                    print(f"obs-report: unreadable bundle {path}: {err}",
                          file=sys.stderr)
            reported = True
    if not reported:
        print("obs-report: nothing to report (pass --flightrec, --trace, "
              "--diff, or --status)", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

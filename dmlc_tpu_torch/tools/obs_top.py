"""``python -m dmlc_tpu_torch.tools obs-top``, the port of
``dmlc_tpu/tools/obs_top.py``: a live per-rank device/feed table.

The ``top(1)`` of a running job: polls a tracker status server's
``/metrics`` (Prometheus text merged across ranks) + ``/workers`` and
renders one row per rank — step time, H2D bandwidth, device memory,
first-call counts of the instrumented step sites (the ``compiles``
columns: ``dmlc_xla_compiles_total``, whose name the port keeps), and the
straggler flag — refreshing in place.

    rank  epoch   lag_s   step_ms  h2d_MBps   hbm_MB  compiles  recomp  flag
       0      3    0.21      14.2     812.5    122.4         2       0
       1      3    0.25      14.8     798.1    122.4         2       0
       2      3   61.02       0.0       0.0      0.0         0       0  STRAGGLER

- live mode (default): refresh every ``--interval`` seconds; H2D MB/s is
  the *rate* of ``dmlc_feed_h2d_bytes_total`` between polls once two
  samples exist (the histogram mean seeds the first frame).
- ``--once``: print a single frame and exit — the CI smoke and what
  ``obs-report --top`` renders as the non-live fallback.
- conditional columns (job, goodput/binding, mfu, audit) appear only
  when the tracker reports them — a frame without them stays
  byte-identical to the older layouts.

Stdlib only (urllib + the text parser below), like obs-report: the tool
must run on a machine with nothing but the checkout.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

_LINE_RE = re.compile(
    r'^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?\s+([^\s]+)$')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
# multi-tenant fleets: a rank heartbeating "... job=<name> ..." is labeled
# with its data-service job, and the table groups by it
_JOB_RE = re.compile(r"\bjob=([\w.\-/]+)")


def parse_metrics(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Prometheus exposition text → ``[(name, labels, value), ...]``.
    Comment/malformed lines are skipped; label values are unescaped."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        name, labelstr, value = m.groups()
        try:
            val = float(value)
        except ValueError:
            continue
        labels = {
            k: v.replace('\\"', '"').replace("\\n", "\n").replace(
                "\\\\", "\\")
            for k, v in _LABEL_RE.findall(labelstr or "")
        }
        out.append((name, labels, val))
    return out


def _rank_sums(
    samples: List[Tuple[str, Dict[str, str], float]], name: str
) -> Dict[int, float]:
    """Sum a metric over all its non-rank labels, per rank."""
    out: Dict[int, float] = {}
    for n, labels, val in samples:
        if n != name or "rank" not in labels:
            continue
        try:
            rank = int(labels["rank"])
        except ValueError:
            continue
        out[rank] = out.get(rank, 0.0) + val
    return out


def _rank_max(
    samples: List[Tuple[str, Dict[str, str], float]], name: str
) -> Dict[int, float]:
    """Max of a metric over its non-rank labels (e.g. device=), per rank."""
    out: Dict[int, float] = {}
    for n, labels, val in samples:
        if n != name or "rank" not in labels:
            continue
        try:
            rank = int(labels["rank"])
        except ValueError:
            continue
        out[rank] = max(out.get(rank, float("-inf")), val)
    return out


def build_rows(
    metrics_text: str,
    workers_obj: Optional[Dict],
    prev_h2d: Optional[Dict[int, float]] = None,
    dt_s: float = 0.0,
    goodput_obj: Optional[Dict] = None,
    audit_obj: Optional[Dict] = None,
) -> Tuple[List[Dict], Dict[int, float]]:
    """One table frame from a ``/metrics`` + ``/workers`` fetch.

    Returns ``(rows, h2d_bytes_by_rank)`` — callers in live mode feed the
    byte totals back in as ``prev_h2d`` so the next frame shows the true
    inter-poll transfer rate instead of the per-put histogram mean.

    ``goodput_obj`` is the tracker's ``/goodput`` JSON (obs/plane.py):
    when a rank has a window there, its row carries the goodput ratio and
    the live binding-stage verdict — same attribution code path as
    ``obs-report --attribution`` and the bench detail record.

    ``audit_obj`` is the tracker's ``/audit`` JSON (obs/audit.py
    AuditPlane.view): a rank with published digest chains gets an audit
    column — total digests chained, or the fork flag on divergence."""
    samples = parse_metrics(metrics_text)
    consume_sum = _rank_sums(samples, "dmlc_feed_consume_ns_sum")
    consume_count = _rank_sums(samples, "dmlc_feed_consume_ns_count")
    h2d_bytes = _rank_sums(samples, "dmlc_feed_h2d_bytes_total")
    h2d_sum = _rank_sums(samples, "dmlc_feed_h2d_mbps_sum")
    h2d_count = _rank_sums(samples, "dmlc_feed_h2d_mbps_count")
    hbm = _rank_max(samples, "dmlc_device_hbm_bytes")
    live = _rank_max(samples, "dmlc_device_live_bytes")
    compiles = _rank_sums(samples, "dmlc_xla_compiles_total")
    recompiles = _rank_sums(samples, "dmlc_xla_recompiles_total")

    workers = (workers_obj or {}).get("workers", {})
    ranks = set(consume_count) | set(compiles) | set(h2d_bytes) | set(hbm)
    ranks |= set(live)
    for key in workers:
        try:
            ranks.add(int(key))
        except ValueError:
            continue

    goodput_ranks = (goodput_obj or {}).get("ranks") or {}
    audit_ranks = (audit_obj or {}).get("ranks") or {}

    rows = []
    for rank in sorted(ranks):
        info = workers.get(str(rank), {})
        m = _JOB_RE.search(str(info.get("info") or ""))
        job = m.group(1) if m else None
        att = goodput_ranks.get(str(rank)) or {}
        aud = audit_ranks.get(str(rank))
        if aud is not None:
            audit_n = sum(
                int(c.get("n", 0) or 0)
                for c in (aud.get("chains") or {}).values())
            audit_diverged = bool(
                aud.get("diverged") or aud.get("worker_divergences"))
        else:
            audit_n = None
            audit_diverged = False
        gp = att.get("goodput") or {}
        count = consume_count.get(rank, 0.0)
        step_ms = (consume_sum.get(rank, 0.0) / count / 1e6) if count else 0.0
        if prev_h2d is not None and dt_s > 0 and rank in prev_h2d:
            delta = h2d_bytes.get(rank, 0.0) - prev_h2d[rank]
            h2d_mbps = max(0.0, delta) / dt_s / 1e6
        else:
            n = h2d_count.get(rank, 0.0)
            h2d_mbps = (h2d_sum.get(rank, 0.0) / n) if n else 0.0
        hbm_bytes = hbm.get(rank, 0.0)
        if hbm_bytes <= 0:
            hbm_bytes = live.get(rank, 0.0)  # cpu backends: census only
        rows.append({
            "rank": rank,
            "job": job,
            "epoch": info.get("epoch"),
            "lag_s": info.get("lag_s"),
            "straggler": bool(info.get("straggler")),
            "step_ms": step_ms,
            "h2d_mbps": h2d_mbps,
            "hbm_mb": hbm_bytes / 1e6,
            "compiles": int(compiles.get(rank, 0)),
            "recompiles": int(recompiles.get(rank, 0)),
            "goodput_ratio": gp.get("ratio"),
            "binding": att.get("binding"),
            "mfu": att.get("mfu"),
            "audit_n": audit_n,
            "audit_diverged": audit_diverged,
        })
    # multi-tenant fleet: ranks serving the same job sit together
    # (unlabeled ranks first, then jobs alphabetically, rank within)
    rows.sort(key=lambda r: (r["job"] is not None, r["job"] or "",
                             r["rank"]))
    return rows, h2d_bytes


def render_table(rows: List[Dict], world_version: Optional[int] = None) -> str:
    lines = []
    if world_version is not None:
        lines.append(f"world_version={world_version}")
    # the job column appears only when some rank is labeled, so the
    # single-tenant frame stays byte-identical to the pre-fleet layout;
    # same contract for the goodput/binding pair — they render only once
    # the plane has two metric snapshots to attribute between
    with_jobs = any(r.get("job") for r in rows)
    with_goodput = any(r.get("binding") for r in rows)
    # same contract again for the audit column: it appears only when the
    # audit plane has chains for some rank, so a no-audit frame keeps
    # the exact pre-audit byte layout
    with_audit = any(r.get("audit_n") is not None for r in rows)
    # and for the mfu column: a window that carried no model-based
    # verdict (no compiled hot step analyzed yet, or no peak) keeps the
    # pre-mfu byte layout
    with_mfu = any(r.get("mfu") is not None for r in rows)
    job_hdr = f"{'job':>10} " if with_jobs else ""
    gp_hdr = f"{'goodput':>7} {'binding':>11} " if with_goodput else ""
    mfu_hdr = f"{'mfu':>5} " if with_mfu else ""
    audit_hdr = f"{'audit':>7} " if with_audit else ""
    lines.append(
        f"{'rank':>4} {job_hdr}{'epoch':>6} {'lag_s':>7} {'step_ms':>8} "
        f"{'h2d_MBps':>9} {'hbm_MB':>8} {'compiles':>8} {'recomp':>6} "
        f"{gp_hdr}{mfu_hdr}{audit_hdr} flag")
    if not rows:
        lines.append("(no ranks reporting yet)")
    for r in rows:
        epoch = "-" if r["epoch"] is None else str(r["epoch"])
        lag = "-" if r["lag_s"] is None else f"{r['lag_s']:.2f}"
        flag = "STRAGGLER" if r["straggler"] else ""
        job_col = f"{(r.get('job') or '-'):>10} " if with_jobs else ""
        if with_goodput:
            ratio = r.get("goodput_ratio")
            gp = f"{ratio * 100.0:.0f}%" if ratio is not None else "-"
            gp_col = f"{gp:>7} {(r.get('binding') or '-'):>11} "
        else:
            gp_col = ""
        if with_mfu:
            mfu = r.get("mfu")
            mfu_cell = f"{mfu * 100.0:.0f}%" if mfu is not None else "-"
            mfu_col = f"{mfu_cell:>5} "
        else:
            mfu_col = ""
        if with_audit:
            if r.get("audit_diverged"):
                audit_cell = "FORK"
            elif r.get("audit_n") is not None:
                audit_cell = str(r["audit_n"])
            else:
                audit_cell = "-"
            audit_col = f"{audit_cell:>7} "
        else:
            audit_col = ""
        lines.append(
            f"{r['rank']:>4} {job_col}{epoch:>6} {lag:>7} "
            f"{r['step_ms']:>8.1f} "
            f"{r['h2d_mbps']:>9.1f} {r['hbm_mb']:>8.1f} "
            f"{r['compiles']:>8d} {r['recompiles']:>6d} "
            f"{gp_col}{mfu_col}{audit_col} {flag}")
    return "\n".join(lines)


def _fetch_text(status: str, endpoint: str) -> Optional[str]:
    from urllib.request import urlopen

    url = f"http://{status}{endpoint}"
    try:
        with urlopen(url, timeout=10) as resp:
            return resp.read().decode("utf-8", "replace")
    except OSError as err:
        print(f"obs-top: fetching {url} failed: {err}", file=sys.stderr)
        return None


def _fetch_frame(
    status: str,
) -> Optional[Tuple[str, Optional[Dict], Optional[Dict], Optional[Dict]]]:
    metrics_text = _fetch_text(status, "/metrics")
    if metrics_text is None:
        return None

    def _json(endpoint: str) -> Optional[Dict]:
        text = _fetch_text(status, endpoint)
        if text is None:
            return None
        try:
            return json.loads(text)
        except ValueError:
            return None

    return metrics_text, _json("/workers"), _json("/goodput"), _json("/audit")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="obs-top", description="Live per-rank device/feed table from a "
        "tracker status server.")
    parser.add_argument("--status", required=True,
                        help="host:port of the tracker status server.")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="Refresh period in seconds (live mode).")
    parser.add_argument("--once", action="store_true",
                        help="Print a single frame and exit (CI smoke; what "
                        "obs-report --top renders).")
    args = parser.parse_args(argv)

    frame = _fetch_frame(args.status)
    if frame is None:
        return 2
    metrics_text, workers_obj, goodput_obj, audit_obj = frame
    rows, h2d_prev = build_rows(metrics_text, workers_obj,
                                goodput_obj=goodput_obj,
                                audit_obj=audit_obj)
    wv = (workers_obj or {}).get("world_version")
    table = render_table(rows, world_version=wv)
    if args.once:
        print(table)
        return 0
    try:
        while True:
            # clear + home, like watch(1); the frame is small by design
            sys.stdout.write("\x1b[2J\x1b[H")
            print(f"obs-top @ {args.status}  "
                  f"(every {args.interval:.1f}s, ctrl-c to quit)")
            print(table)
            sys.stdout.flush()
            time.sleep(max(0.1, args.interval))
            frame = _fetch_frame(args.status)
            if frame is None:
                return 2
            metrics_text, workers_obj, goodput_obj, audit_obj = frame
            rows, h2d_prev = build_rows(
                metrics_text, workers_obj,
                prev_h2d=h2d_prev, dt_s=max(0.1, args.interval),
                goodput_obj=goodput_obj, audit_obj=audit_obj)
            wv = (workers_obj or {}).get("world_version")
            table = render_table(rows, world_version=wv)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())

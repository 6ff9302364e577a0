"""Render determinism-audit replay bundles (``audit-rank<k>.json``), the
port of ``dmlc_tpu/tools/audit_report.py``. A divergence (a digest chain
forking between ranks, epochs or a redelivered chunk) leaves a bundle
beside the flight-recorder dump (obs/audit.py ``write_bundle``); this
prints the fork (stage, rank, seq or epoch), the shard window to re-read,
the env snapshot to replay under and the digests around the fork. Host
only.

Usage::

    python -m dmlc_tpu_torch.tools audit_report [DIR_OR_FILE ...]
    python -m dmlc_tpu_torch.tools audit_report --status HOST:PORT

The default path is the flight-recorder dir (``DMLC_TPU_FLIGHTREC``,
``obs/flight.flightrec_dir``) or the cwd. ``--status`` reads a status
plane's ``/audit`` view over HTTP (the JAX package's tracker serves one;
the port has no plane yet). Exit 0 = rendered, no divergence; 1 = a
divergence; 2 = nothing to report.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

from dmlc_tpu_torch.obs.flight import flightrec_dir


def _find_bundles(paths: List[str]) -> List[str]:
    """Files pass through; a directory gives its ``audit-rank*.json``."""
    if not paths:
        paths = [flightrec_dir() or "."]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "audit-rank*.json"))))
        elif os.path.exists(p):
            out.append(p)
    return out


def _fork_context(chains: Dict, seq, width: int = 3) -> List[str]:
    """The digests within ``width`` of the forking seq, a line a side."""
    lines: List[str] = []
    for side in sorted(chains):
        entries = chains.get(side) or []
        near = [e for e in entries
                if isinstance(e, (list, tuple)) and len(e) == 2
                and abs(int(e[0]) - int(seq)) <= width]
        if near:
            frag = " ".join("%s:%s" % (e[0], e[1]) for e in near)
            lines.append("    %-9s %s" % (side, frag))
    return lines


def _render_bundle(path: str) -> bool:
    """Print one bundle; True (a bundle is a divergence report)."""
    with open(path) as fh:
        obj = json.load(fh)
    div = obj.get("divergence", {})
    shard = obj.get("shard", {})
    print("bundle %s (v%s, rank %s)" % (
        path, obj.get("v", "?"), obj.get("rank", "?")))
    print("  divergence: stage=%s seq=%s scope=%s" % (
        div.get("stage", "?"), div.get("seq", div.get("epoch", "?")),
        div.get("scope", "?")))
    print("    ours=%s theirs=%s" % (
        div.get("ours", "?"), div.get("theirs", "?")))
    against = ["%s=%s" % (k, div[k]) for k in ("against_rank",
                                                "against_epoch")
               if k in div]
    if against:
        print("    against: %s" % " ".join(against))
    if shard:
        print("  replay window: uri=%s part=%s/%s" % (
            shard.get("uri", shard.get("sig", "?")),
            shard.get("part", "?"), shard.get("nparts", "?")))
    kn = obj.get("knobs") or {}
    if kn:
        print("  knobs: %s" % " ".join(
            "%s=%s" % (k, v) for k, v in sorted(kn.items())))
    seq = div.get("seq")
    if seq is not None:
        for line in _fork_context(obj.get("chains") or {}, seq):
            print(line)
    return True


def _render_view(view: Dict) -> bool:
    """Print a live ``/audit`` view; True when it holds a divergence."""
    ranks = view.get("ranks") or {}
    if not ranks:
        print("audit plane: no rank has published chains")
        return False
    for rank, v in sorted(ranks.items()):
        chains = v.get("chains") or {}
        frag = " ".join(
            "%s[n=%s head=%s]" % (s, c.get("n", 0), c.get("head", ""))
            for s, c in sorted(chains.items()))
        print("rank %s epoch=%s shard=%s %s%s" % (
            rank, v.get("epoch", "?"), v.get("shard", ""),
            frag, " DIVERGED" if v.get("diverged") else ""))
    divs = view.get("divergences") or []
    for div in divs:
        print("fork: stage=%s seq=%s rank=%s vs rank=%s (%s != %s)" % (
            div.get("stage", "?"), div.get("seq", "?"),
            div.get("rank", "?"), div.get("against_rank", "?"),
            div.get("ours", "?"), div.get("theirs", "?")))
    return bool(divs)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="audit-report",
        description="render determinism-audit replay bundles")
    ap.add_argument("paths", nargs="*",
                    help="bundle files or directories "
                         "(default: flightrec dir or cwd)")
    ap.add_argument("--status", metavar="HOST:PORT",
                    help="render a status plane's /audit view")
    args = ap.parse_args(argv)

    if args.status:
        import urllib.request

        url = "http://%s/audit" % args.status
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                view = json.load(resp)
        except OSError as err:
            print("audit-report: cannot fetch %s: %s" % (url, err),
                  file=sys.stderr)
            return 2
        return 1 if _render_view(view) else 0

    bundles = _find_bundles(args.paths)
    if not bundles:
        print("audit-report: no audit-rank*.json bundles under %s" %
              (args.paths or [flightrec_dir() or "."]))
        return 2
    diverged = False
    for path in bundles:
        try:
            diverged = _render_bundle(path) or diverged
        except (OSError, ValueError) as err:
            print("audit-report: unreadable bundle %s: %s" % (path, err),
                  file=sys.stderr)
    return 1 if diverged else 0


if __name__ == "__main__":
    sys.exit(main())

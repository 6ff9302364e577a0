"""Deterministic fault injection: ``faultpoint("site")`` hooks that do
nothing until a spec arms them — the part of ``dmlc_tpu/resilience/
faults.py`` the snapshot plane uses.

The spec comes from ``configure(spec)`` (the in-process hook) or, read at
first use, from the job's ``DMLC_TPU_FAULTS`` setting, in the reference's
grammar (``;``-separated site clauses, ``:``-separated options)::

    DMLC_TPU_FAULTS="preempt.notice:nth=25;snap.commit:p=0.5:seed=7"

- ``nth=<int>``: fire exactly on the Nth pass through the site (1-based),
  once; ``times=<k>`` fires on the k passes from the Nth on;
- ``p=<float>``: fire with probability p a pass, drawn from a per-site
  ``random.Random(crc32(site) ^ seed)``, so the same spec fires at the
  same passes run after run whatever other sites are armed;
- ``seed=<int>``: that site's seed (default 0).

A fired faultpoint raises :class:`InjectedFault`, an ``OSError``: callers
treat it as the I/O or peer failure it stands in for. The sites this
package has: ``preempt.notice`` (resilience/preempt.py), ``ckpt.commit``,
``ckpt.read`` and ``snap.commit`` (collective/checkpoint.py,
collective/__init__.py), ``collective.connect`` (the socket engine's
tracker dial), ``tracker.join`` and ``tracker.evict``
(tracker/rendezvous.py); a program may pass its own (a training loop's
``worker.step``). Fired faults are counted in :func:`stats`.
"""

from __future__ import annotations

import os
import random
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from dmlc_tpu_torch.utils.logging import DMLCError


class InjectedFault(OSError):
    """The error a fired faultpoint raises."""


class FaultSpecError(DMLCError):
    """A malformed fault spec (fail loud, not silently)."""


class _SiteRule:
    """One armed site: probabilistic (p, seed) or scripted (nth, times)."""

    def __init__(self, site: str, p: float, seed: int, nth: int, times: int):
        self.site = site
        self.p = p
        self.nth = nth
        self.times = times
        self._rng = random.Random(zlib.crc32(site.encode()) ^ seed)
        self.passes = 0

    def should_fire(self) -> bool:
        self.passes += 1
        if self.nth > 0:
            return self.nth <= self.passes < self.nth + self.times
        return self._rng.random() < self.p


def parse_spec(spec: str) -> Dict[str, _SiteRule]:
    """Parse a fault spec into per-site rules."""
    rules: Dict[str, _SiteRule] = {}
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        site = parts[0].strip()
        if not site:
            raise FaultSpecError(f"empty site in fault spec clause "
                                 f"{clause!r}")
        opts = {"p": 0.0, "seed": 0, "nth": 0, "times": 1}
        for opt in parts[1:]:
            key, eq, val = opt.partition("=")
            if not eq:
                raise FaultSpecError(
                    f"fault option {opt!r} at {site!r} is not key=value")
            if key not in opts:
                raise FaultSpecError(
                    f"unknown fault option {key!r} at {site!r} "
                    f"(want p/seed/nth/times)")
            try:
                opts[key] = float(val) if key == "p" else int(val)
            except ValueError as err:
                raise FaultSpecError(
                    f"bad value for {key!r} at {site!r}: {val!r}") from err
        if opts["nth"] <= 0 and not 0.0 < opts["p"] <= 1.0:
            raise FaultSpecError(
                f"site {site!r} needs nth=<N> or p in (0, 1], got "
                f"p={opts['p']} nth={opts['nth']}")
        rules[site] = _SiteRule(site, opts["p"], opts["seed"], opts["nth"],
                                max(1, opts["times"]))
    return rules


_lock = threading.Lock()
_rules: Optional[Dict[str, _SiteRule]] = None  # None: read the env first
_fired: List[Tuple[str, int]] = []


def configure(spec: Optional[str]) -> None:
    """(Re)arm the sites from ``spec`` (None or "" disarms every site)."""
    global _rules
    with _lock:
        _rules = parse_spec(spec) if spec else {}


def reset() -> None:
    """Disarm and forget: the next :func:`faultpoint` reads
    ``DMLC_TPU_FAULTS`` again."""
    global _rules
    with _lock:
        _rules = None
        _fired.clear()


def faultpoint(site: str) -> None:
    """Raise :class:`InjectedFault` when ``site``'s rule fires on this
    pass; a dictionary lookup when nothing is armed."""
    global _rules
    with _lock:
        if _rules is None:
            _rules = parse_spec(os.environ.get("DMLC_TPU_FAULTS", ""))
        rule = _rules.get(site)
        if rule is None or not rule.should_fire():
            return
        _fired.append((site, rule.passes))
        passes = rule.passes
    raise InjectedFault(f"injected fault at {site} (pass {passes})")


def stats() -> Dict[str, object]:
    """The armed sites and the faults fired since the last :func:`reset`,
    as (site, pass) pairs."""
    with _lock:
        return {"sites": sorted(_rules or {}), "fired": list(_fired)}

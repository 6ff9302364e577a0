"""Cross-rank determinism audit: streaming stage digests (the port of
``dmlc_tpu/obs/audit.py``: the same chains, digest bytes, bundle layout
and :class:`AuditPlane`).

A silent divergence in a live job (parser drift, a double-counted chunk,
a reordered reduction) surfaces as a wrong model hours later with no
trail. dmlc-core's posture is that integrity is an *in-band* property of
the stream (RecordIO magic/CRC framing); this module applies the same
idea one level up: content digests at every pipeline stage.

- **Worker side** — :class:`Auditor` (via :func:`auditor`) keeps one
  seq-keyed digest chain per stage: ``io_read`` (raw chunk bytes, keyed
  by chunk seq), ``parse`` (the canonical columnar digest of the parsed
  RowBlockContainer — ``RowBlock.audit_arrays``, backend-independent by
  construction), ``batch`` (the same digest at feed emit, keyed by batch
  index), and ``model`` (a rolling hash over the epoch loss + a strided
  parameter sample, fetched once an epoch: on the card one small
  device-to-host copy an epoch and none a step). The same fetch powers
  the numeric-health sentinel: non-finite counts on loss and the sampled
  params ride the goodput window into the watchdog's ``numeric`` alert.
- **Self-check** — :meth:`Auditor.roll_epoch` compares each data-stage
  chain against the previous epoch's over the same shard: the same
  bytes must parse and batch identically epoch over epoch, so the first
  mismatching seq *localizes* a nondeterminism without any tracker.
- **Cross-rank** — :meth:`Auditor.export` is the payload a tracker
  compares; :class:`AuditPlane` merges chains from every (rank, epoch)
  into one reference per (stage, shard) and flags the first forking seq.
  The tracker's status plane (obs/plane.py) feeds it every heartbeat
  payload's ``audit`` key and serves its view as ``/audit``.
- **On divergence** — a typed ``audit.divergence`` flight event,
  ``dmlc_audit_divergences_total{stage=}``, and a minimal replay bundle
  ``audit-rank<k>.json`` beside the flightrec dump (shard window, the
  ``DMLC_TPU_*`` settings, the offending seq, both chains).

``DMLC_TPU_AUDIT`` off (the default) hands every call site the shared
:data:`NOOP_AUDITOR` — one attribute load and an empty method call;
``sample`` mode digests every ``DMLC_TPU_AUDIT_SAMPLE_N``-th seq.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import struct
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dmlc_tpu_torch.obs.flight import record_event
from dmlc_tpu_torch.obs.metrics import Registry, registry
from dmlc_tpu_torch.obs.flight import flightrec_dir
from dmlc_tpu_torch.params.env import get_env

logger = logging.getLogger("dmlc_tpu_torch.obs.audit")


def audit_mode() -> str:
    """Audit ledger mode (``DMLC_TPU_AUDIT``): ``full`` (aliases
    ``1``/``on``/``true``) digests every chunk, parsed block, emitted batch
    and model step; ``sample`` every :func:`audit_sample_n`-th seq;
    anything else (the default) is ``off``."""
    val = str(get_env("DMLC_TPU_AUDIT", "")).strip().lower()
    if val in ("1", "on", "full", "true"):
        return "full"
    if val == "sample":
        return "sample"
    return "off"


def audit_sample_n() -> int:
    """Digest stride for ``DMLC_TPU_AUDIT=sample``
    (``DMLC_TPU_AUDIT_SAMPLE_N``, default 16, floor 1)."""
    return max(1, get_env("DMLC_TPU_AUDIT_SAMPLE_N", 16))

#: digest width in bytes — 64-bit hex chains keep heartbeat payloads and
#: replay bundles small while collisions stay negligible at chunk counts
DIGEST_SIZE = 8

#: stages a worker chains, in pipeline order ("model" compares by
#: step/epoch index across ranks; the rest by chunk/batch seq)
STAGES = ("io_read", "parse", "batch", "model")

#: data stages are reset + self-compared at epoch boundaries; the model
#: chain spans the whole fit (loss changes every epoch by design)
DATA_STAGES = ("io_read", "parse", "batch")

#: entries shipped per stage on one heartbeat payload (newest seqs win;
#: ``n``/``head`` still summarize the full chain)
EXPORT_CAP = 512

#: in-memory entries kept per stage chain (oldest seqs evicted)
CHAIN_CAP = 4096


def _hasher() -> "hashlib._Hash":
    return hashlib.blake2b(digest_size=DIGEST_SIZE)


def digest_bytes(data) -> str:
    """Hex digest of one raw chunk (bytes-like or str)."""
    h = _hasher()
    if isinstance(data, str):
        data = data.encode()
    h.update(data)
    return h.hexdigest()


def rows_digest(obj) -> str:
    """Hex digest of a RowBlock / RowBlockContainer's canonical columnar
    stream (``audit_arrays`` — data/row_block.py). Field-major with
    per-row lengths and neutral defaults materialized, so the digest is
    invariant to chunking, slicing, and parse backend: equal rows ⇒
    equal digest."""
    h = _hasher()
    for tag, parts in obj.audit_arrays():
        h.update(b"\x1f")
        h.update(tag)
        h.update(b"\x1e")
        for a in parts:
            a = np.ascontiguousarray(a)
            h.update(a.data)
    return h.hexdigest()


def digest_arrays(fields: Dict[str, np.ndarray]) -> str:
    """Hex digest of a named array dict (the data-service wire payload) —
    the redelivery equality check hashes the delivered fields directly,
    before any RowBlock is built."""
    h = _hasher()
    for name in sorted(fields):
        arr = fields[name]
        h.update(b"\x1f")
        h.update(name.encode())
        h.update(b"\x1e")
        if arr is not None:
            a = np.ascontiguousarray(arr)
            h.update(a.data)
    return h.hexdigest()


def _param_sample(arr, k: int = 64):
    """A strided sample of up to ``k`` elements of one parameter array —
    small enough that the epoch-cadence fetch is negligible, strided so
    a corrupted span anywhere in the array is likely sampled. Stays on
    the array's device (a tensor stays a tensor)."""
    flat = arr.reshape(-1)
    size = int(flat.shape[0])
    if size == 0:
        return flat[:0]
    stride = max(1, size // k)
    return flat[::stride][:k]


def _param_samples(params) -> Dict[str, np.ndarray]:
    """Every parameter's strided sample as numpy, fetched from the device
    in ONE copy (the samples of one dtype are concatenated there)."""
    samples = {name: _param_sample(params[name]) for name in sorted(params)}
    tensors = {n: a for n, a in samples.items()
               if isinstance(a, torch.Tensor)}
    out = {n: np.asarray(a) for n, a in samples.items() if n not in tensors}
    by_dtype: Dict = {}
    for name, t in tensors.items():
        by_dtype.setdefault(t.dtype, []).append(name)
    for names in by_dtype.values():
        host = torch.cat([tensors[n] for n in names]).cpu().numpy()
        pos = 0
        for n in names:
            m = tensors[n].shape[0]
            out[n] = host[pos:pos + m]
            pos += m
    return out


class _NoopAuditor:
    """Shared disabled auditor (``DMLC_TPU_AUDIT`` off): every note is an
    empty method call, mirroring the no-op metrics child. Allocation-free
    on the hot path."""

    __slots__ = ()
    enabled = False
    every = 0
    shard = ""
    divergences = ()

    def set_shard(self, uri, part=0, nparts=1):
        pass

    def note_chunk(self, seq, data):
        pass

    def note_parse(self, seq, obj):
        pass

    def note_batch(self, idx, obj):
        pass

    def note_model(self, idx, loss, params=None):
        return 0

    def check_redelivery(self, seq, first_hex, redelivered_hex):
        return True

    def roll_epoch(self, epoch):
        return ()

    def export(self):
        return {}

    def snapshot(self):
        return {}

    def export_state(self):
        return {}

    def restore_state(self, st):
        return False


NOOP_AUDITOR = _NoopAuditor()


class Auditor:
    """Worker-side streaming digest ledger (construct via
    :func:`auditor`). Thread-safe: parse digests land from the
    pipeline's worker threads out of order — entries are keyed by seq,
    not append order, so a missing-vs-present seq is itself a signal."""

    enabled = True

    def __init__(self, reg: Optional[Registry] = None,
                 mode: Optional[str] = None,
                 sample_n: Optional[int] = None,
                 rank: Optional[int] = None):
        self._reg = reg if reg is not None else registry()
        mode = audit_mode() if mode is None else mode
        n = audit_sample_n() if sample_n is None else int(sample_n)
        self.every = n if mode == "sample" else 1
        self.rank = (int(os.environ.get("DMLC_TASK_ID", "0") or 0)
                     if rank is None else int(rank))
        self.epoch = 0
        self.shard = ""
        self._shard_info: Dict = {}
        self._lock = threading.Lock()
        self._chains: Dict[str, Dict[int, str]] = {}
        self._heads: Dict[str, str] = {}
        self._prev: Dict[str, Dict[int, str]] = {}
        self._prev_epoch = -1
        self._prev_shard = ""
        self.divergences: List[Dict] = []
        self._m_digests = {
            stage: self._reg.counter(
                "dmlc_audit_digests_total",
                "stage digests recorded by the audit ledger", stage=stage)
            for stage in STAGES
        }

    # ---- shard identity -------------------------------------------------
    def set_shard(self, uri, part: int = 0, nparts: int = 1) -> None:
        """Declare the data shard this worker's chains are computed over
        (``uri`` + part window). Chains only compare — across epochs,
        restarts, and ranks — within one shard signature; replicas
        reading the same window compare cross-rank, partitioned readers
        only against themselves."""
        sig = "%s|%d/%d" % (uri, int(part), int(nparts))
        with self._lock:
            if sig == self.shard:
                return
            self.shard = sig
            self._shard_info = {
                "uri": str(uri), "part": int(part), "nparts": int(nparts)}
            # a new shard invalidates every data chain comparison
            for stage in DATA_STAGES:
                self._chains.pop(stage, None)
                self._heads.pop(stage, None)
            self._prev = {}
            self._prev_epoch = -1
            self._prev_shard = sig

    # ---- digest points --------------------------------------------------
    def _record(self, stage: str, seq: int, hexd: str) -> None:
        seq = int(seq)
        with self._lock:
            chain = self._chains.setdefault(stage, {})
            chain[seq] = hexd
            self._heads[stage] = hashlib.blake2b(
                (self._heads.get(stage, "") + hexd).encode(),
                digest_size=DIGEST_SIZE).hexdigest()
            if len(chain) > CHAIN_CAP:
                del chain[min(chain)]
        self._m_digests[stage].inc()

    def note_chunk(self, seq: int, data) -> None:
        """Chunk-bytes digest at io_read, keyed by chunk seq."""
        if seq % self.every:
            return
        try:
            self._record("io_read", seq, digest_bytes(data))
        except TypeError:
            pass  # non-bytes chunk payloads (pre-parsed iterators) skip

    def note_parse(self, seq: int, obj) -> None:
        """Post-parse RowBlock(Container) digest, keyed by chunk seq."""
        if seq % self.every:
            return
        self._record("parse", seq, rows_digest(obj))

    def note_batch(self, idx: int, obj) -> None:
        """Batch digest at pool emit, keyed by batch index within the
        epoch."""
        if idx % self.every:
            return
        self._record("batch", idx, rows_digest(obj))

    def note_model(self, idx: int, loss, params=None) -> int:
        """Model digest-chain update at log cadence: loss bits + a
        strided sample of every parameter array. Returns the number of
        non-finite values seen in loss + samples — the numeric-health
        sentinel the fit loop feeds to the watchdog (one small fetch,
        shared with the digest)."""
        h = _hasher()
        nonfinite = 0
        if loss is not None:
            loss = float(loss)
            h.update(struct.pack("<d", loss))
            if not math.isfinite(loss):
                nonfinite += 1
        if params:
            samples = _param_samples(params)
            for name in sorted(params):
                sample = samples[name]
                h.update(name.encode())
                a = np.ascontiguousarray(sample)
                h.update(a.data)
                if np.issubdtype(a.dtype, np.floating):
                    nonfinite += int(a.size - np.isfinite(a).sum())
        self._record("model", idx, h.hexdigest())
        return nonfinite

    def check_redelivery(self, seq, first_hex: str,
                         redelivered_hex: str) -> bool:
        """Compare a requeued chunk redelivery's content digest against
        its first delivery's (data/service.py drops the duplicate either
        way). A mismatch means the requeue path rewrote content — a
        ``redelivery``-stage divergence. Returns True when equal."""
        if first_hex == redelivered_hex:
            return True
        self._divergence(stage="redelivery", seq=int(seq),
                         scope="redelivery", ours=redelivered_hex,
                         theirs=first_hex)
        return False

    # ---- epoch roll + self-check ---------------------------------------
    def roll_epoch(self, epoch: int) -> List[Dict]:
        """Close the epoch's data chains: compare them against the
        previous epoch's over the same shard (the same bytes must parse
        and batch identically), archive, and reset for the next epoch.
        Returns the divergences found (usually empty). Call *after* the
        epoch's payload publish so the full chains ride the heartbeat."""
        with self._lock:
            cur = {stage: dict(self._chains.get(stage, ()))
                   for stage in DATA_STAGES}
            prev = self._prev
            comparable = (self._prev_epoch >= 0
                          and self._prev_shard == self.shard)
            self._prev = cur
            self._prev_epoch = int(epoch)
            self._prev_shard = self.shard
            # exports during epoch N carry epoch=N (publish runs before
            # the roll), so the tracker can tell a rank's own chains
            # apart across epochs
            self.epoch = int(epoch) + 1
            for stage in DATA_STAGES:
                self._chains.pop(stage, None)
                self._heads.pop(stage, None)
        found: List[Dict] = []
        if not comparable:
            return found
        for stage in DATA_STAGES:
            ours, theirs = cur.get(stage, {}), prev.get(stage, {})
            for seq in sorted(set(ours) & set(theirs)):
                if ours[seq] != theirs[seq]:
                    found.append(self._divergence(
                        stage=stage, seq=seq, epoch=int(epoch),
                        ours=ours[seq], theirs=theirs[seq],
                        scope="epoch", against_epoch=self._prev_epoch - 1,
                        chains={"current": _chain_list(ours),
                                "previous": _chain_list(theirs)},
                    ))
                    break  # first divergence localizes; the rest cascade
        return found

    def _divergence(self, chains=None, **fields) -> Dict:
        div = dict(fields, rank=self.rank, shard=self.shard)
        emit_divergence(self._reg, div)
        self.divergences.append(div)
        write_bundle(self.rank, div, chains=chains,
                     shard_info=self._shard_info)
        return div

    # ---- export / introspection ----------------------------------------
    def export(self) -> Dict:
        """The ``audit`` key of one OBS1 heartbeat payload: per-stage
        chain windows (newest :data:`EXPORT_CAP` seqs), rolling heads,
        and totals. Empty dict when nothing was digested yet (the key is
        then omitted — payloads stay byte-stable with audit off)."""
        with self._lock:
            if not self._chains:
                return {}
            chains = {}
            for stage, chain in self._chains.items():
                seqs = sorted(chain)[-EXPORT_CAP:]
                chains[stage] = {
                    "n": len(chain),
                    "head": self._heads.get(stage, ""),
                    "d": [[seq, chain[seq]] for seq in seqs],
                }
            return {
                "shard": self.shard,
                "epoch": self.epoch,
                "every": self.every,
                "chains": chains,
                "divergences": len(self.divergences),
            }

    def export_state(self) -> Dict:
        """Resumable chain state for a job snapshot (JobSnapshot part).

        Full-fidelity where :meth:`export` windows: the model digest
        chain + rolling head (so a resumed run's final model head equals
        an uninterrupted run's) and the archived previous-epoch data
        chains (so the first resumed ``roll_epoch`` still self-checks
        against the interrupted run when the shard signature matches).
        Empty dict when nothing was digested yet.
        """
        with self._lock:
            model = self._chains.get("model")
            if model is None and not self._prev and self._prev_epoch < 0:
                return {}
            return {
                "epoch": self.epoch,
                "every": self.every,
                "model": {
                    "chain": dict(model or {}),
                    "head": self._heads.get("model", ""),
                },
                "prev": {s: dict(c) for s, c in self._prev.items()},
                "prev_epoch": self._prev_epoch,
                "prev_shard": self._prev_shard,
            }

    def restore_state(self, st: Dict) -> bool:
        """Re-inject chain state exported by :meth:`export_state`.

        Call *after* the data parser stamped :meth:`set_shard` for the
        resumed epoch — restore only refills chain/archive state, it
        never rewrites the live shard signature. Returns True when
        state was applied.
        """
        if not st:
            return False
        with self._lock:
            model = st.get("model") or {}
            chain = {int(k): v for k, v in (model.get("chain") or {}).items()}
            if chain:
                self._chains["model"] = chain
            if model.get("head"):
                self._heads["model"] = model["head"]
            self._prev = {
                stage: {int(k): v for k, v in c.items()}
                for stage, c in (st.get("prev") or {}).items()
            }
            self._prev_epoch = int(st.get("prev_epoch", -1))
            self._prev_shard = str(st.get("prev_shard", ""))
            self.epoch = int(st.get("epoch", self.epoch))
        return True

    def snapshot(self) -> Dict:
        """Local view for logs/tests: chain lengths + divergence list."""
        with self._lock:
            lengths = {s: len(c) for s, c in self._chains.items()}
        return {
            "rank": self.rank,
            "shard": self.shard,
            "every": self.every,
            "chains": lengths,
            "divergences": list(self.divergences),
        }


def _chain_list(chain: Dict[int, str], cap: int = EXPORT_CAP) -> List:
    return [[seq, chain[seq]] for seq in sorted(chain)[-cap:]]


def emit_divergence(reg: Optional[Registry], div: Dict) -> None:
    """The one divergence chokepoint both sides share: typed flight
    event + ``dmlc_audit_divergences_total{stage=}`` + a warning log."""
    record_event("audit.divergence", **div)
    (reg if reg is not None else registry()).counter(
        "dmlc_audit_divergences_total",
        "digest-chain forks detected by the audit plane",
        stage=str(div.get("stage", "?"))).inc()
    logger.warning("audit divergence: %s", div)


def bundle_path(rank: int, out_dir: Optional[str] = None) -> str:
    """Where rank ``k``'s replay bundle lands: ``audit-rank<k>.json``
    beside the flight-recorder dump (cwd when the recorder is off)."""
    base = out_dir if out_dir else (flightrec_dir() or ".")
    return os.path.join(base, "audit-rank%d.json" % int(rank))


def write_bundle(rank: int, div: Dict, chains: Optional[Dict] = None,
                 shard_info: Optional[Dict] = None,
                 out_dir: Optional[str] = None) -> Optional[str]:
    """Atomically write the minimal-repro bundle for one divergence:
    the fork coordinates, the shard window, a ``DMLC_TPU_*`` knob
    snapshot (seeds and backends ride here), and both chains. First
    divergence wins — the root cause; later ones cascade from it."""
    path = bundle_path(rank, out_dir)
    if os.path.exists(path):
        return None
    obj = {
        "v": 1,
        "rank": int(rank),
        "unix": round(time.time(), 3),
        "divergence": div,
        "shard": dict(shard_info or {}),
        "knobs": {k: v for k, v in sorted(os.environ.items())
                  if k.startswith("DMLC_TPU_")},
        "chains": chains or {},
    }
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as fh:
            json.dump(obj, fh, indent=1)
        os.replace(tmp, path)
    except OSError as err:  # a full disk must not take training down
        logger.warning("audit bundle write failed (%s): %s", path, err)
        return None
    return path


# ---------------------------------------------------------------------------
# process-wide auditor (the goodput.ledger / metrics.registry convention)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_AUDITOR = NOOP_AUDITOR
_INIT = False


def auditor():
    """The process auditor: a live :class:`Auditor` when
    ``DMLC_TPU_AUDIT`` is on, else the shared :data:`NOOP_AUDITOR`.
    Resolved once; call sites bind the result at construction so the
    disabled hot path is one empty method call."""
    global _AUDITOR, _INIT
    if _INIT:
        return _AUDITOR
    with _LOCK:
        if not _INIT:
            if audit_mode() != "off":
                _AUDITOR = Auditor()
            _INIT = True
    return _AUDITOR


def reset_auditor() -> None:
    """Forget the cached auditor (tests; env changed)."""
    global _AUDITOR, _INIT
    with _LOCK:
        _AUDITOR = NOOP_AUDITOR
        _INIT = False


# ---------------------------------------------------------------------------
# Tracker side: cross-rank / cross-epoch chain comparison
# ---------------------------------------------------------------------------


class AuditPlane:
    """Merges every rank's exported chains into one reference per
    (stage, shard) and localizes the first fork.

    The reference is built incrementally: the first digest seen for a
    (stage, shard, epoch-kind, seq) coordinate becomes the truth, every
    later arrival — from any rank, epoch, or restart — must match it.
    Data stages compare by chunk/batch seq (equal bytes ⇒ equal digests,
    whatever the arrival order); the model stage compares by step/epoch
    index (SPMD replicas must hold identical params). One divergence is
    flagged per (stage, rank) — the first fork localizes, the rest
    cascade."""

    def __init__(self, reg: Optional[Registry] = None,
                 out_dir: Optional[str] = None):
        self._reg = reg if reg is not None else registry()
        self._out_dir = out_dir
        self._lock = threading.Lock()
        # (stage, shard) -> seq -> (digest, rank, epoch)
        self._ref: Dict = {}
        self._flagged = set()
        self._divergences: List[Dict] = []
        self._ranks: Dict[int, Dict] = {}

    def note_audit(self, rank: int, obj: Dict) -> List[Dict]:
        """Ingest one payload's ``audit`` key; returns new divergences."""
        if not isinstance(obj, dict):
            return []
        rank = int(rank)
        shard = str(obj.get("shard", ""))
        epoch = int(obj.get("epoch", -1) or 0)
        chains = obj.get("chains")
        if not isinstance(chains, dict):
            return []
        found: List[Dict] = []
        with self._lock:
            view = self._ranks.setdefault(rank, {})
            view["shard"] = shard
            view["epoch"] = epoch
            view["worker_divergences"] = int(obj.get("divergences", 0) or 0)
            view.setdefault("chains", {})
            for stage, chain in chains.items():
                if not isinstance(chain, dict):
                    continue
                entries = chain.get("d") or []
                view["chains"][stage] = {
                    "n": int(chain.get("n", len(entries)) or 0),
                    "head": chain.get("head", ""),
                }
                # model chains are shard-independent (replicas must
                # agree); data chains compare within one shard window
                key = (stage, "" if stage == "model" else shard)
                ref = self._ref.setdefault(key, {})
                if (stage, rank) in self._flagged:
                    continue
                for seq_hex in entries:
                    try:
                        seq, hexd = int(seq_hex[0]), str(seq_hex[1])
                    except (TypeError, ValueError, IndexError):
                        continue
                    known = ref.get(seq)
                    if known is None:
                        ref[seq] = (hexd, rank, epoch)
                    elif known[0] != hexd and known[1:] != (rank, epoch):
                        self._flagged.add((stage, rank))
                        div = {
                            "stage": stage, "seq": seq, "rank": rank,
                            "epoch": epoch, "shard": shard,
                            "ours": hexd, "theirs": known[0],
                            "against_rank": known[1],
                            "against_epoch": known[2],
                            "scope": "cross-rank",
                        }
                        found.append(div)
                        break
        for div in found:
            emit_divergence(self._reg, div)
            with self._lock:
                self._divergences.append(div)
            write_bundle(div["rank"], div, out_dir=self._out_dir,
                         chains={"observed": [[div["seq"], div["ours"]]],
                                 "reference": [[div["seq"], div["theirs"]]]},
                         shard_info={"sig": div["shard"]})
        return found

    def view(self) -> Dict:
        """The ``/audit`` body: per-rank chain summaries + the fork
        table."""
        with self._lock:
            ranks = {
                str(rank): {
                    "shard": v.get("shard", ""),
                    "epoch": v.get("epoch", -1),
                    "chains": dict(v.get("chains", {})),
                    "worker_divergences": v.get("worker_divergences", 0),
                    "diverged": any(r == rank for _s, r in self._flagged),
                }
                for rank, v in sorted(self._ranks.items())
            }
            return {
                "enabled": bool(self._ranks),
                "ranks": ranks,
                "divergences": list(self._divergences),
            }

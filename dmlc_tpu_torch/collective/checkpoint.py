"""Rabit-style checkpoints and coordinated job snapshots over any
registered filesystem (the port of ``dmlc_tpu/collective/checkpoint.py``,
same layout and bytes, so each package restores the other's directory,
local or ``s3://``).

Layout under the checkpoint directory::

    ckpt_v{N}.bin          global state, written by rank 0 (or by every
                           rank with ``per_rank=True``: ckpt_v{N}.rank{R}.bin)
    LATEST                 text pointer "N", committed last, so a torn
                           write of the state file is never visible

    snap_v{N}.rank{R}      a JobSnapshot part: serialized state + a
                           (magic, crc32, length) trailer
    snap_v{N}.manifest     crc32 hex line + JSON naming every part
    snap.rank{R}.frontier  the newest version rank R wrote a part for

Tensors in a state tree are copied to host numpy on save (:func:`_to_host`).
:class:`JobSnapshot` is a two-phase commit: every rank writes its own part,
rank 0 waits for all parts of the version to land and verify, then
atomically writes the manifest and LATEST; a torn or partial write is
never visible to :meth:`JobSnapshot.restore`. The faultpoints
``ckpt.commit``, ``ckpt.read`` and ``snap.commit`` sit where the
reference's do. The directory is any uri of ``io/filesystem.py``: on local
files each pointer, manifest and part is written beside itself, fsynced
and renamed into place; on an object store it is one object write, which
appears only once its upload completes. Pruning deletes through the
directory's filesystem, best effort: a file that cannot be deleted stays,
and the commit stands.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.io.filesystem import (URI, atomic_write,
                                          create_stream, get_filesystem,
                                          makedirs)
from dmlc_tpu_torch.io.serializer import load_obj, save_obj
from dmlc_tpu_torch.io.stream import MemoryStream
from dmlc_tpu_torch.resilience import faultpoint, preempt
from dmlc_tpu_torch.utils.logging import DMLCError, check, log_warning


def _to_host(tree: Any) -> Any:
    """Tensors (and other array-likes) → numpy, recursively.

    Always a REAL copy, never a view: on the CPU ``tensor.numpy()`` shares
    the tensor's memory, and the training loop updates params in place
    (``donate_batch=True``) right after a capture while the snapshot
    writer thread may still be serializing the tree. A CUDA tensor is
    copied to the host once (``.to("cpu", copy=True)``)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        mapped = [_to_host(v) for v in tree]
        if isinstance(tree, tuple):
            if hasattr(type(tree), "_fields"):  # NamedTuple
                return type(tree)(*mapped)
            return tuple(mapped)
        return mapped
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if hasattr(tree, "__array__") and not isinstance(tree, np.ndarray):
        return np.array(tree, copy=True)
    return tree


def _read_all(uri: str) -> Optional[bytes]:
    stream = create_stream(uri, "r", allow_null=True)
    if stream is None:
        return None
    with stream:
        return stream.read_all()


def _prune_file(uri: str) -> None:
    """Delete ``uri`` if it is there, best effort (the reference's
    pruning): a backend that cannot delete leaves the file and logs why;
    the commit that pruned stands."""
    parsed = URI.parse(uri)
    fs = get_filesystem(parsed)
    try:
        if fs.exists(parsed):
            fs.delete(parsed)
    except Exception as err:  # noqa: BLE001 (pruning never fails a commit)
        log_warning("checkpoint prune of %s failed: %s", uri, err)


def _config_error(err: BaseException) -> bool:
    """A misconfigured directory surfaces instead of degrading to the
    fallback."""
    return isinstance(err, (FileNotFoundError, PermissionError,
                            IsADirectoryError, NotADirectoryError))


class CheckpointManager:
    """CheckPoint / LoadCheckPoint / version_number (the rabit API).

    ``rank`` selects the writer: only rank 0 commits the global state
    (every rank calls ``checkpoint``; the others just bump their
    version). ``per_rank=True`` writes one state file per rank and loads
    this rank's own.

    ``fallback_uri`` (default: the job's ``DMLC_TPU_CKPT_FALLBACK_URI``
    setting; "" disables it) is where a commit goes when the primary
    directory fails; ``load_checkpoint`` takes the newest committed
    version of the two.
    """

    def __init__(self, uri: str, rank: int = 0, world_size: int = 1,
                 per_rank: bool = False, keep: int = 2,
                 fallback_uri: Optional[str] = None):
        check(keep >= 1, "keep must be >= 1")
        self.uri = uri.rstrip("/")
        self.rank = rank
        self.world_size = world_size
        self.per_rank = per_rank
        self.keep = keep
        if fallback_uri is None:
            fallback_uri = os.environ.get("DMLC_TPU_CKPT_FALLBACK_URI", "")
        fallback_uri = (fallback_uri or "").rstrip("/") or None
        if fallback_uri is not None:
            check(fallback_uri != self.uri,
                  "fallback checkpoint URI must differ from the primary")
        self._fallback_uri = fallback_uri
        self._fallback = None
        makedirs(self.uri)
        self._version = self._read_latest() or 0

    # ---- rabit surface -------------------------------------------------
    @property
    def version_number(self) -> int:
        """Number of committed checkpoints (rabit VersionNumber)."""
        return self._version

    def checkpoint(self, state: Any) -> int:
        """Commit ``state`` as version ``version_number + 1``; returns it.
        A failed commit goes to the fallback directory when there is one
        (not for a misconfigured primary: that raises)."""
        version = self._version + 1
        try:
            self._commit(version, state)
        except (DMLCError, OSError) as err:
            fb = self._fallback_manager()
            if fb is None or _config_error(err):
                raise
            log_warning("checkpoint v%d commit to %s failed (%s); degrading "
                        "to fallback %s", version, self.uri, err, fb.uri)
            from dmlc_tpu_torch.obs import flight

            flight.record_event("ckpt.fallback", version=version,
                                uri=self.uri, error=str(err))
            fb._version = version - 1  # keep the numbering aligned
            fb._commit(version, state)
        self._version = version
        if self.rank == 0:
            self._prune(version)
        return version

    def _commit(self, version: int, state: Any) -> None:
        faultpoint("ckpt.commit")
        if self.per_rank or self.rank == 0:
            with create_stream(self._state_uri(version, self.rank),
                               "w") as stream:
                save_obj(stream, _to_host(state))
        if self.rank == 0:
            self._write_latest(version)

    def _fallback_manager(self):
        if self._fallback is None and self._fallback_uri is not None:
            self._fallback = type(self)(**self._fallback_kwargs())
        return self._fallback

    def _fallback_kwargs(self) -> Dict[str, Any]:
        return dict(uri=self._fallback_uri, rank=self.rank,
                    world_size=self.world_size, per_rank=self.per_rank,
                    keep=self.keep, fallback_uri="")

    def load_checkpoint(self) -> Tuple[int, Optional[Any]]:
        """(version, state) of the newest committed checkpoint, or (0,
        None). In ``per_rank`` mode a missing state file falls back
        version by version through the kept window; with a fallback
        directory the newer of the two wins."""
        fb = self._fallback_manager()
        if fb is not None:
            if (fb._read_latest() or 0) > (self._read_latest() or 0):
                version, state = fb.load_checkpoint()
                self._version = max(self._version, version)
                return version, state
        faultpoint("ckpt.read")
        latest = self._read_latest()
        if not latest:
            return 0, None
        rank = self.rank if self.per_rank else 0
        floor = max(1, latest - self.keep + 1) if self.per_rank else latest
        for version in range(latest, floor - 1, -1):
            stream = create_stream(self._state_uri(version, rank), "r",
                                   allow_null=True)
            if stream is None:
                continue
            with stream:
                state = load_obj(stream)
            self._version = version
            return version, state
        raise DMLCError(
            f"checkpoint LATEST points at v{latest} but no readable state "
            f"file exists in {self.uri} (rank {rank})")

    # ---- internals -----------------------------------------------------
    def _state_uri(self, version: int, rank: int) -> str:
        if self.per_rank:
            return f"{self.uri}/ckpt_v{version}.rank{rank}.bin"
        return f"{self.uri}/ckpt_v{version}.bin"

    def _write_latest(self, version: int) -> None:
        atomic_write(f"{self.uri}/LATEST", str(version).encode())

    def _read_latest(self) -> Optional[int]:
        raw = _read_all(f"{self.uri}/LATEST")
        text = (raw or b"").decode().strip()
        return int(text) if text else None

    def _prune(self, newest: int) -> None:
        """Remove checkpoints older than the ``keep`` window."""
        ranks = range(self.world_size) if self.per_rank else (0,)
        for version in range(max(1, newest - self.keep * 4),
                             newest - self.keep + 1):
            for rank in ranks:
                _prune_file(self._state_uri(version, rank))


# ---- coordinated job snapshots ----------------------------------------


class SnapshotSuperseded(DMLCError):
    """A rank moved past the awaited version without writing its part (its
    capture was superseded by a newer epoch in the newest-wins writer):
    rank 0 abandons that version's manifest instead of waiting out the
    barrier."""


#: Trailer magic of snapshot part files ("SNAP" little-endian).
PART_MAGIC = 0x534E4150
_PART_TRAILER = struct.Struct("<III")  # magic, crc32(payload), len(payload)


class JobSnapshot(CheckpointManager):
    """Two-phase-commit job snapshot: rank parts + a crc-guarded manifest.

    Phase 1: every rank serializes its state tree to ``snap_v{N}.rank{R}``
    with a (magic, crc32, length) trailer and bumps its frontier marker.
    Phase 2: rank 0 polls until all ``world_size`` parts of the version
    have landed and verify, passes the ``snap.commit`` faultpoint, then
    atomically writes ``snap_v{N}.manifest`` and LATEST. A crash before
    the manifest lands leaves the previous version the newest committed
    one. The barrier is on the filesystem, not a collective, so a writer
    thread never touches the process group.

    Versions must agree across ranks: a caller that can skip commits (the
    async writer) passes an epoch-derived ``version`` to :meth:`commit`,
    so a skipped epoch leaves a gap; rank 0's barrier reads the frontier
    markers of missing ranks and abandons a version a peer has moved past
    (:class:`SnapshotSuperseded`).
    """

    def __init__(self, uri: str, rank: int = 0, world_size: int = 1,
                 keep: int = 2, fallback_uri: Optional[str] = None,
                 part_timeout_s: float = 60.0):
        super().__init__(uri, rank=rank, world_size=world_size,
                         per_rank=True, keep=keep, fallback_uri=fallback_uri)
        self.part_timeout_s = part_timeout_s
        #: serialized payload size of this rank's last written part
        self.last_part_bytes = 0

    def _fallback_kwargs(self) -> Dict[str, Any]:
        return dict(uri=self._fallback_uri, rank=self.rank,
                    world_size=self.world_size, keep=self.keep,
                    fallback_uri="", part_timeout_s=self.part_timeout_s)

    # ---- commit --------------------------------------------------------
    def commit(self, state: Any, meta: Optional[Dict[str, Any]] = None,
               version: Optional[int] = None) -> int:
        """Commit this rank's ``state`` as ``version`` (default: the next
        one); rank 0 also runs the barrier and writes the manifest. An
        explicit version must exceed the newest this rank has written. A
        version found superseded on a peer returns without a manifest. A
        failed commit goes to the fallback directory when there is one."""
        if version is None:
            version = self._version + 1
        else:
            version = int(version)
            check(version > self._version,
                  f"job snapshot version {version} must exceed this "
                  f"rank's newest written version {self._version} "
                  "(versions advance monotonically)")
        try:
            self._commit_snapshot(version, state, meta)
        except SnapshotSuperseded as err:
            from dmlc_tpu_torch.obs import flight

            log_warning("%s", err)
            flight.record_event("snap.superseded", version=version)
        except (DMLCError, OSError) as err:
            fb = self._fallback_manager()
            if fb is None or _config_error(err):
                raise
            log_warning("job snapshot v%d commit to %s failed (%s); "
                        "degrading to fallback %s", version, self.uri, err,
                        fb.uri)
            from dmlc_tpu_torch.obs import flight

            flight.record_event("ckpt.fallback", version=version,
                                uri=self.uri, error=str(err))
            fb._version = version - 1
            fb._commit_snapshot(version, state, meta)
            self.last_part_bytes = fb.last_part_bytes
        self._version = version
        if self.rank == 0:
            self._prune(version)
        return version

    def _commit_snapshot(self, version: int, state: Any,
                         meta: Optional[Dict[str, Any]]) -> None:
        payload = self._write_part(version, state)
        if self.rank != 0:
            return
        parts = self._await_parts(version, own_payload=payload)
        faultpoint("snap.commit")
        body = json.dumps({
            "version": version,
            "world_size": self.world_size,
            "parts": parts,
            "meta": meta or {},
        }, sort_keys=True).encode()
        head = b"%08x\n" % (zlib.crc32(body) & 0xFFFFFFFF)
        atomic_write(self._manifest_uri(version), head + body)
        self._write_latest(version)
        from dmlc_tpu_torch.obs import flight

        flight.record_event(
            "snap.commit", version=version, parts=len(parts),
            bytes=sum(p["size"] for p in parts),
        )

    def _write_part(self, version: int, state: Any) -> bytes:
        buf = MemoryStream()
        save_obj(buf, _to_host(state))
        payload = buf.getvalue()
        self.last_part_bytes = len(payload)
        trailer = _PART_TRAILER.pack(
            PART_MAGIC, zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
        atomic_write(self._state_uri(version, self.rank), payload + trailer)
        atomic_write(self._frontier_uri(self.rank), b"%d" % version)
        return payload

    @staticmethod
    def _part_entry(name: str, payload: bytes) -> Dict[str, Any]:
        return {"name": name, "size": len(payload),
                "crc": zlib.crc32(payload) & 0xFFFFFFFF}

    def _await_parts(self, version: int, own_payload: bytes) -> list:
        """Rank 0's barrier: poll until every rank's part has landed and
        verifies. Once a preemption notice is pending the wait shrinks to
        the remaining grace window: a peer killed before writing its part
        must not hold the relaunch past the deadline."""
        deadline = time.monotonic() + self.part_timeout_s
        entries = {self.rank: self._part_entry(
            self._part_name(version, self.rank), own_payload)}
        pending = [r for r in range(self.world_size) if r != self.rank]
        while pending:
            still = []
            for rank in pending:
                payload = self._read_part_payload(version, rank)
                if payload is None:
                    still.append(rank)
                else:
                    entries[rank] = self._part_entry(
                        self._part_name(version, rank), payload)
            pending = still
            if not pending:
                break
            ahead = [r for r in pending if self._read_frontier(r) > version]
            if ahead:
                raise SnapshotSuperseded(
                    f"job snapshot v{version}: ranks {ahead} moved past "
                    f"this version without writing a part (their capture "
                    f"for it was superseded by a newer epoch); abandoning "
                    f"the v{version} manifest")
            now = time.monotonic()
            if preempt.requested():
                deadline = min(deadline, now + preempt.deadline_remaining())
            if now >= deadline:
                raise DMLCError(
                    f"job snapshot v{version}: ranks {pending} did not "
                    f"write their part within the barrier window "
                    f"({self.part_timeout_s:.0f}s, or the preemption grace "
                    f"remainder once a notice is pending)")
            time.sleep(0.02)
        return [entries[r] for r in range(self.world_size)]

    # ---- restore -------------------------------------------------------
    def restore(self) -> Tuple[int, Optional[Any], Dict[str, Any]]:
        """(version, state, meta) of the newest committed snapshot, or (0,
        None, {}). Walks the kept window newest first, skipping versions
        whose manifest is torn or whose part fails its crc; with a
        fallback directory the newest committed version of the two wins.
        A manifest of another world size raises DMLCError."""
        fb = self._fallback_manager()
        if fb is not None and \
                self._newest_committed() < fb._newest_committed():
            version, state, meta = fb.restore()
            self._version = max(self._version, version)
            return version, state, meta
        latest = self._read_latest()
        if not latest:
            return 0, None, {}
        # the committed sequence may have gaps (superseded versions): walk
        # the prune window, keep * 4 version numbers
        for version in range(latest, max(1, latest - self.keep * 4 + 1) - 1,
                             -1):
            loaded = self._restore_version(version)
            if loaded is not None:
                self._version = version
                return (version,) + loaded
        raise DMLCError(
            f"job snapshot LATEST points at v{latest} but no committed "
            f"version is readable in {self.uri} (rank {self.rank})")

    def _newest_committed(self) -> int:
        """Newest version with an intact manifest (0 when none)."""
        latest = self._read_latest()
        if not latest:
            return 0
        for version in range(latest, max(1, latest - self.keep * 4 + 1) - 1,
                             -1):
            if self._read_manifest(version) is not None:
                return version
        return 0

    def _restore_version(self, version: int):
        manifest = self._read_manifest(version)
        if manifest is None:
            return None
        if manifest["world_size"] != self.world_size:
            raise DMLCError(
                f"job snapshot v{version} in {self.uri} was written by "
                f"world_size={manifest['world_size']} but this job runs "
                f"world_size={self.world_size}; per-rank snapshots cannot "
                "be resharded — restart with the original world size or "
                "point at a fresh snapshot directory")
        entry = manifest["parts"][self.rank]
        payload = self._read_part_payload(version, self.rank)
        if payload is None or \
                self._part_entry(entry["name"], payload) != entry:
            log_warning("job snapshot v%d part %s missing or corrupt; "
                        "trying an older version", version, entry["name"])
            return None
        return load_obj(MemoryStream(payload)), manifest.get("meta") or {}

    def _read_manifest(self, version: int) -> Optional[Dict[str, Any]]:
        raw = _read_all(self._manifest_uri(version))
        if raw is None or b"\n" not in raw:
            return None
        head, body = raw.split(b"\n", 1)
        try:
            if zlib.crc32(body) & 0xFFFFFFFF != int(head, 16):
                return None
            return json.loads(body)
        except ValueError:
            return None

    def _read_part_payload(self, version: int,
                           rank: int) -> Optional[bytes]:
        raw = _read_all(self._state_uri(version, rank))
        if raw is None or len(raw) < _PART_TRAILER.size:
            return None
        magic, crc, size = _PART_TRAILER.unpack(raw[-_PART_TRAILER.size:])
        payload = raw[:-_PART_TRAILER.size]
        if magic != PART_MAGIC or size != len(payload) \
                or zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return None
        return payload

    # ---- layout --------------------------------------------------------
    def _frontier_uri(self, rank: int) -> str:
        return f"{self.uri}/snap.rank{rank}.frontier"

    def _read_frontier(self, rank: int) -> int:
        """Newest version ``rank`` wrote a part for (0 when unknown)."""
        raw = _read_all(self._frontier_uri(rank))
        try:
            return int((raw or b"0").decode().strip() or 0)
        except ValueError:
            return 0

    def _part_name(self, version: int, rank: int) -> str:
        return f"snap_v{version}.rank{rank}"

    def _state_uri(self, version: int, rank: int) -> str:
        return f"{self.uri}/{self._part_name(version, rank)}"

    def _manifest_uri(self, version: int) -> str:
        return f"{self.uri}/snap_v{version}.manifest"

    def _prune(self, newest: int) -> None:
        """Keep the newest ``keep`` committed versions: the window counts
        manifests, not version numbers, since the sequence may have
        gaps."""
        kept = 0
        for version in range(newest, max(1, newest - self.keep * 4) - 1, -1):
            if kept < self.keep:
                if self._read_manifest(version) is not None:
                    kept += 1
                continue
            _prune_file(self._manifest_uri(version))
            for rank in range(self.world_size):
                _prune_file(self._state_uri(version, rank))

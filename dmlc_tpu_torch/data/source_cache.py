"""Job-shared source cache: N jobs reading one dataset parse it once (the
port of ``dmlc_tpu/data/source_cache.py``).

A data worker that parses a chunk keeps its column arrays in a
process-wide LRU bounded in bytes and keyed by the digest of the *source
spec* (uri, part, nparts, format and the parser kwargs, the device among
them), so a second job leasing the same part of the same dataset is
served from memory and parses nothing. The dispatcher remembers which
workers parsed which parts and prefers them when it grants a lease, so the
hit is not left to chance.

- **Single-flight population.** Concurrent first readers of a key elect a
  leader; the others wait on its event. A leader that fails (a parse
  error, an injected ``cache.populate`` fault) wakes them to elect again:
  a failed population never wedges a waiter and never stores half an
  entry.
- **Bounded memory.** The budget is ``DMLC_TPU_DATA_CACHE_MB`` (0 turns
  the tier off); the least recently used entries go first, and an entry
  larger than the whole budget is served uncached.
- **Degradation, not failure.** The service parses directly when the
  population faults: the tier costs speed, never rows.

Entries are dicts of 1-D numpy arrays (the frame's fields before the
per-lease ``seq`` / ``job`` / ``flow`` tags), shared read-only by every
job. Counters: ``dmlc_source_cache_hits_total`` / ``_misses_total`` /
``_evictions_total`` and the ``dmlc_source_cache_bytes`` gauge, with
plain-int mirrors (``hits`` / ``misses`` / ``evictions``) that stay true
under ``DMLC_TPU_METRICS=0``.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np

from dmlc_tpu_torch import obs
from dmlc_tpu_torch.params.env import get_env


def data_cache_mb() -> int:
    """The source cache's budget in MiB (``DMLC_TPU_DATA_CACHE_MB``,
    default 256; 0 turns the tier off). Read at the cache's first use."""
    return max(0, get_env("DMLC_TPU_DATA_CACHE_MB", 256))


class SourceCache:
    """Process-wide LRU of parsed chunk frames, single-flight populated.

    One instance is shared by every :class:`~dmlc_tpu_torch.data.service.
    BlockService` in the process (see :func:`source_cache`); a dedicated
    instance with its own ``cap_bytes`` is constructible for tests."""

    def __init__(self, cap_bytes: Optional[int] = None):
        self._cap = (data_cache_mb() << 20) if cap_bytes is None \
            else max(0, int(cap_bytes))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict[str, np.ndarray]]" = \
            OrderedDict()
        self._bytes = 0
        # key -> population-in-progress event (single-flight election)
        self._inflight: Dict[str, threading.Event] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        reg = obs.registry()
        self._m_hits = reg.counter(
            "dmlc_source_cache_hits_total",
            "chunk parses skipped: the parsed frame was cache-resident")
        self._m_misses = reg.counter(
            "dmlc_source_cache_misses_total",
            "chunk frames parsed and admitted to the source cache")
        self._m_evictions = reg.counter(
            "dmlc_source_cache_evictions_total",
            "cached chunk frames evicted by the LRU byte budget")
        self._g_bytes = reg.gauge(
            "dmlc_source_cache_bytes",
            "bytes of parsed chunk frames resident in the source cache")

    @property
    def enabled(self) -> bool:
        """False when ``DMLC_TPU_DATA_CACHE_MB=0`` disabled the tier."""
        return self._cap > 0

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @staticmethod
    def chunk_key(uri: str, part: int, nparts: int,
                  data_format: str = "auto",
                  parser_kwargs: Optional[Dict] = None) -> str:
        """Digest of the full source spec. Two jobs share an entry ONLY
        when every input that could change the parsed bytes matches —
        same URI, same split geometry, same declared format, same parser
        kwargs — so a cache hit is bit-identical to a fresh parse by
        construction. Baked shards fold in a content token (format
        version + per-file footer crc32 + the armed shuffle seed/window,
        io/shard.py ``cache_token``): the URI of a re-baked or re-seeded
        shard no longer names the same parsed bytes, so it must not hit
        the old entry."""
        from dmlc_tpu_torch.io import shard

        spec = json.dumps(
            [str(uri), int(part), int(nparts), str(data_format),
             sorted((parser_kwargs or {}).items()),
             shard.cache_token(uri, str(data_format))],
            sort_keys=True, default=repr)
        return hashlib.sha256(spec.encode()).hexdigest()

    def get_or_populate(
        self,
        key: str,
        populate: Callable[[], Dict[str, np.ndarray]],
    ) -> Dict[str, np.ndarray]:
        """Return the cached frame for ``key``, parsing at most once.

        The first caller of a key becomes the population leader (the
        ``cache.populate`` chaos site fires on its path); concurrent
        callers block until the leader finishes and then read the entry.
        A leader failure propagates to the leader AND wakes the
        followers, which re-elect and retry — so an injected fault
        delays followers by one election, never deadlocks them. The
        returned dict is SHARED: treat it read-only."""
        from dmlc_tpu_torch.resilience import faultpoint

        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    self._m_hits.inc()
                    return entry
                event = self._inflight.get(key)
                if event is None:
                    event = threading.Event()
                    self._inflight[key] = event
                    leader = True
                else:
                    leader = False
            if not leader:
                event.wait()
                continue  # cache hit now — or re-elect if the leader died
            try:
                faultpoint("cache.populate")
                fields = populate()
            except BaseException:
                with self._lock:
                    self._inflight.pop(key, None)
                event.set()  # wake followers to re-elect
                raise
            with self._lock:
                self.misses += 1
                self._m_misses.inc()
                self._store_locked(key, fields)
                self._inflight.pop(key, None)
            event.set()
            return fields

    def _store_locked(self, key: str,
                      fields: Dict[str, np.ndarray]) -> None:
        nbytes = sum(int(a.nbytes) for a in fields.values())
        if nbytes > self._cap:
            # bigger than the whole budget: serving it uncached beats
            # flushing every other tenant's working set for one entry
            return
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= sum(int(a.nbytes) for a in old.values())
        self._entries[key] = fields
        self._bytes += nbytes
        while self._bytes > self._cap and len(self._entries) > 1:
            _, victim = self._entries.popitem(last=False)
            self._bytes -= sum(int(a.nbytes) for a in victim.values())
            self.evictions += 1
            self._m_evictions.inc()
        self._g_bytes.set(self._bytes)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._g_bytes.set(0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


_CACHE: Optional[SourceCache] = None
_CACHE_LOCK = threading.Lock()


def source_cache() -> SourceCache:
    """The process-wide shared cache (lazily built so the byte budget
    reads ``DMLC_TPU_DATA_CACHE_MB`` at first use, not import time)."""
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = SourceCache()
        return _CACHE


def reset_source_cache() -> None:
    """Drop the shared cache (tests re-knob the budget between cases)."""
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is not None:
            _CACHE.clear()
        _CACHE = None

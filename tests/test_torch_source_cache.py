"""The port's job-shared source cache (``dmlc_tpu_torch/data/
source_cache.py``) on the CPU: the cases of the JAX package's
``tests/test_source_cache.py`` run on the port (spec-digest keys, the LRU
byte budget, single-flight population and leader re-election, a second
job over one source parsed zero times), then a ``cache.populate`` fault
degrading to a direct parse, and the budget read from
``DMLC_TPU_DATA_CACHE_MB``.
"""

import threading

import numpy as np
import pytest

from dmlc_tpu_torch import resilience
from dmlc_tpu_torch.data import (BlockService, DataDispatcher, RemoteBlockParser,
                           SourceCache, reset_source_cache, source_cache)

ROWS = 24


@pytest.fixture(autouse=True)
def _clean_state():
    resilience.reset()
    reset_source_cache()
    yield
    resilience.reset()
    reset_source_cache()


def _frame(nbytes):
    return {"x": np.zeros(nbytes // 8, dtype=np.float64)}


class TestChunkKey:
    def test_digest_covers_full_source_spec(self):
        base = SourceCache.chunk_key("a.svm", 0, 4, "libsvm", {"k": 1})
        assert base == SourceCache.chunk_key("a.svm", 0, 4, "libsvm",
                                             {"k": 1})
        for other in (
            SourceCache.chunk_key("b.svm", 0, 4, "libsvm", {"k": 1}),
            SourceCache.chunk_key("a.svm", 1, 4, "libsvm", {"k": 1}),
            SourceCache.chunk_key("a.svm", 0, 8, "libsvm", {"k": 1}),
            SourceCache.chunk_key("a.svm", 0, 4, "csv", {"k": 1}),
            SourceCache.chunk_key("a.svm", 0, 4, "libsvm", {"k": 2}),
            SourceCache.chunk_key("a.svm", 0, 4, "libsvm"),
        ):
            assert other != base

    def test_shard_content_folds_into_key(self, tmp_path, monkeypatch):
        """A baked shard's key covers its *content* (footer crc) and the
        armed shuffle seed/window: a re-bake or a re-seed must never hit
        the stale entry (io/shard.py ``cache_token``)."""
        from dmlc_tpu_torch.data.row_block import RowBlockContainer
        from dmlc_tpu_torch.io.shard import ShardWriter

        dst = str(tmp_path / "keyed.dtsh")

        def bake(nrows):
            rows = RowBlockContainer()
            for i in range(nrows):
                rows.push_row(float(i), [i % 3], value=[1.0 + i])
            with ShardWriter(dst, rows_per_window=8) as w:
                w.write_block(rows.to_block())

        bake(32)
        base = SourceCache.chunk_key(dst, 0, 4, "shard")
        assert base == SourceCache.chunk_key(dst, 0, 4, "shard")  # stable
        monkeypatch.setenv("DMLC_TPU_SHUFFLE", "3")
        reseeded = SourceCache.chunk_key(dst, 0, 4, "shard")
        monkeypatch.setenv("DMLC_TPU_SHUFFLE_WINDOW", "4")
        rewindowed = SourceCache.chunk_key(dst, 0, 4, "shard")
        monkeypatch.delenv("DMLC_TPU_SHUFFLE")
        monkeypatch.delenv("DMLC_TPU_SHUFFLE_WINDOW")
        bake(33)  # same path, new bytes
        rebaked = SourceCache.chunk_key(dst, 0, 4, "shard")
        keys = {base, reseeded, rewindowed, rebaked}
        assert len(keys) == 4
        # text sources keep their pre-shard keys (token is None)
        assert SourceCache.chunk_key("a.svm", 0, 4, "libsvm", {"k": 1}) == \
            SourceCache.chunk_key("a.svm", 0, 4, "libsvm", {"k": 1})


class TestLRUBudget:
    def test_hit_miss_accounting_and_populate_once(self):
        cache = SourceCache(cap_bytes=1 << 20)
        calls = []

        def populate():
            calls.append(1)
            return _frame(1024)

        first = cache.get_or_populate("k", populate)
        second = cache.get_or_populate("k", populate)
        assert first is second and len(calls) == 1
        assert cache.stats() == {"entries": 1, "bytes": 1024, "hits": 1,
                                 "misses": 1, "evictions": 0}

    def test_lru_evicts_coldest_first(self):
        cache = SourceCache(cap_bytes=2048)
        cache.get_or_populate("a", lambda: _frame(1024))
        cache.get_or_populate("b", lambda: _frame(1024))
        cache.get_or_populate("a", lambda: _frame(1024))  # refresh a
        cache.get_or_populate("c", lambda: _frame(1024))  # evicts b
        assert cache.evictions == 1
        hits = cache.hits
        cache.get_or_populate("a", lambda: _frame(1024))
        assert cache.hits == hits + 1  # a survived: it was warmer than b
        refilled = []
        cache.get_or_populate("b", lambda: refilled.append(1) or
                              _frame(1024))
        assert refilled  # b really was evicted

    def test_oversized_entry_served_uncached(self):
        cache = SourceCache(cap_bytes=512)
        cache.get_or_populate("small", lambda: _frame(256))
        out = cache.get_or_populate("huge", lambda: _frame(4096))
        assert len(out["x"]) == 4096 // 8
        # the working set was NOT flushed for the one oversized entry
        assert cache.stats()["entries"] == 1
        assert cache.resident_bytes == 256

    def test_cap_zero_disables_tier(self):
        cache = SourceCache(cap_bytes=0)
        assert not cache.enabled
        assert SourceCache(cap_bytes=1).enabled


class TestSingleFlight:
    def test_concurrent_first_readers_parse_once(self):
        cache = SourceCache(cap_bytes=1 << 20)
        release = threading.Event()
        calls = []

        def populate():
            calls.append(1)
            release.wait(timeout=5)
            return _frame(512)

        results = []
        threads = [
            threading.Thread(
                target=lambda: results.append(
                    cache.get_or_populate("k", populate)))
            for _ in range(4)
        ]
        for t in threads:
            t.start()
        while not calls:  # a leader is elected and inside populate()
            pass
        release.set()
        for t in threads:
            t.join(timeout=10)
        assert len(calls) == 1 and len(results) == 4
        assert all(r is results[0] for r in results)
        assert cache.hits == 3 and cache.misses == 1

    def test_leader_failure_wakes_followers_to_reelect(self):
        cache = SourceCache(cap_bytes=1 << 20)
        entered = threading.Event()
        release = threading.Event()
        calls = []

        def doomed():
            calls.append("leader")
            entered.set()
            release.wait(timeout=5)
            raise RuntimeError("parse blew up")

        def fine():
            calls.append("follower")
            return _frame(512)

        errs = []

        def leader_thread():
            try:
                cache.get_or_populate("k", doomed)
            except RuntimeError as err:
                errs.append(err)

        follower_out = []
        leader = threading.Thread(target=leader_thread)
        leader.start()
        assert entered.wait(timeout=5)
        follower = threading.Thread(
            target=lambda: follower_out.append(
                cache.get_or_populate("k", fine)))
        follower.start()
        release.set()
        leader.join(timeout=10)
        follower.join(timeout=10)
        # the failure reached the leader, the follower re-elected and won
        assert len(errs) == 1 and calls == ["leader", "follower"]
        assert follower_out and cache.misses == 1


class TestCrossJobZeroParse:
    @pytest.fixture()
    def svm_file(self, tmp_path):
        path = tmp_path / "shared.svm"
        with open(path, "w") as fh:
            for i in range(ROWS):
                fh.write(f"{i % 3} 1:{i} 2:{2 * i}\n")
        return str(path)

    def test_second_job_parses_zero_chunks(self, svm_file):
        """The PR's acceptance bar: job B over the same source as job A
        is served entirely from the shared cache — the worker performs
        ZERO chunk parses for it, and the rows are bit-identical."""
        def drain(parser):
            sig = []
            for block in parser:
                sig.append((block.label.tobytes(), block.value.tobytes()))
            parser.close()
            return sorted(sig)

        with DataDispatcher() as disp:
            disp.add_job("a", svm_file, nchunks=4)
            disp.add_job("b", svm_file, nchunks=4)
            with BlockService(dispatcher=disp.address, nthread=1, device="cpu") as svc:
                sig_a = drain(RemoteBlockParser(
                    disp.address, dispatcher=True, job="a", device="cpu"))
                parsed_after_a = svc.chunks_parsed
                assert parsed_after_a == 4
                sig_b = drain(RemoteBlockParser(
                    disp.address, dispatcher=True, job="b", device="cpu"))
                assert svc.chunks_parsed == parsed_after_a  # zero parses
                assert sig_b == sig_a
                assert source_cache().hits >= 4


def test_populate_fault_degrades_to_a_direct_parse(tmp_path):
    """An injected ``cache.populate`` fault costs the cache entry, never
    rows: the worker parses the chunk directly and the job completes."""
    path = tmp_path / "f.svm"
    with open(path, "w") as fh:
        for i in range(ROWS):
            fh.write(f"{i % 3} 1:{i}\n")
    resilience.configure("cache.populate:nth=1")
    with DataDispatcher(str(path), nchunks=3) as disp:
        with BlockService(dispatcher=disp.address, nthread=1,
                          device="cpu") as svc:
            parser = RemoteBlockParser(disp.address, dispatcher=True,
                                       device="cpu")
            vals = sorted(v for b in parser
                          for v in np.asarray(b.value).tolist())
            parser.close()
            assert disp.join(timeout=10)
            assert svc.chunks_parsed == 3
    assert vals == [float(i) for i in range(ROWS)]
    assert len(source_cache()) == 2  # the faulted chunk went uncached


@pytest.mark.parametrize("mb,enabled", [("0", False), ("1", True)])
def test_budget_is_read_at_first_use(monkeypatch, mb, enabled):
    monkeypatch.setenv("DMLC_TPU_DATA_CACHE_MB", mb)
    reset_source_cache()
    cache = source_cache()
    assert cache.enabled is enabled
    assert cache._cap == int(mb) << 20

"""The port's FileSystem layer against the JAX package's: URI parsing, the
pattern expansion and file listing of local, ``mem://`` and ``s3://``
trees, the remote range-read loop (truncation, the end, 416, ``into=``),
the retry state's progress refill, hedged calls, and the registry's
refusals. Every comparison is exact.
"""

import os
import threading
import time
import urllib.error

import pytest

from dmlc_tpu.io import filesystem as ref_fs
from dmlc_tpu.io.object_store import S3FileSystem as RefS3FileSystem
from dmlc_tpu_torch.io import filesystem as fs
from dmlc_tpu_torch.io.object_store import S3FileSystem
from dmlc_tpu_torch.resilience import (RetryPolicy, faultpoint, hedged_call,
                                       retry)
from dmlc_tpu_torch.resilience import configure as configure_faults
from dmlc_tpu_torch.resilience import reset as reset_faults
from dmlc_tpu_torch.utils import DMLCError
from tests.fake_object_store import serve


@pytest.fixture()
def s3(monkeypatch):
    """One fake S3 server for both packages; each registry re-registers
    its backend so the instances read the endpoint again."""
    server, store, base = serve()
    monkeypatch.setenv("S3_ENDPOINT", base)
    monkeypatch.setenv("DMLC_S3_WRITE_BUFFER_MB", "1")
    for name in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
                 "S3_ACCESS_KEY", "S3_SECRET_KEY"):
        monkeypatch.delenv(name, raising=False)
    fs.register_filesystem("s3://", lambda uri: S3FileSystem())
    ref_fs.register_filesystem("s3://", lambda uri: RefS3FileSystem())
    yield store
    server.shutdown()
    server.server_close()
    # drop the instances bound to this server's endpoint
    fs.register_filesystem("s3://", lambda uri: S3FileSystem())
    ref_fs.register_filesystem("s3://", lambda uri: RefS3FileSystem())


def _uri_fields(uri):
    return (uri.protocol, uri.host, uri.name, uri.str_full())


URIS = ["/tmp/a/b.txt", "rel/x.svm", "file:///abs/p", "s3://bkt/k/ey",
        "s3://bkt", "gs://b/o?x=1", "hdfs://nn:9870/user/x",
        "azure://cont/blob/a", "mem://host/path/", "http://h:8/x.svm",
        "stdin", "viewfs://cluster/p"]


@pytest.mark.parametrize("uri", URIS)
def test_uri_parse_matches_reference(uri):
    assert _uri_fields(fs.URI.parse(uri)) == _uri_fields(
        ref_fs.URI.parse(uri))


# ---------------------------------------------------------------------------
# pattern expansion and file listing over three backends
# ---------------------------------------------------------------------------

TREE = {"d/a.txt": b"aa\n", "d/b.txt": b"bbb\n", "d/empty.txt": b"",
        "d/sub/c.txt": b"c\n", "d/sub/deep/e.txt": b"eeee\n",
        "d/part-1.svm": b"1 1:1\n", "d/part-2.svm": b"0 2:1\n",
        "other.txt": b"o\n"}

PATTERNS = [
    ("{root}/d", False), ("{root}/d", True), ("{root}/d/a.txt", False),
    (r"{root}/d/part-.*\.svm", False),
    ("{root}/d/a.txt;{root}/d/sub", False),
    ("{root}/d/missing.txt;{root}/d/b.txt", False),
]


def _tree(kind, tmp_path, store):
    """The TREE under a root uri of ``kind``."""
    if kind == "local":
        for key, data in TREE.items():
            path = tmp_path / key
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(data)
        return str(tmp_path)
    if kind == "mem":
        fs.MemoryFileSystem.reset()
        ref_fs.MemoryFileSystem.reset()
        for key, data in TREE.items():
            fs.MemoryFileSystem.put(f"tree/{key}", data)
            ref_fs.MemoryFileSystem.put(f"tree/{key}", data)
        return "mem://tree"
    for key, data in TREE.items():
        store.objects[("bkt", key)] = data
    return "s3://bkt"


def _names(infos):
    return [(i.path.str_full(), i.size, i.type) for i in infos]


@pytest.mark.parametrize("kind", ["local", "mem", "s3"])
def test_expand_and_list_match_reference(kind, tmp_path, s3):
    root = _tree(kind, tmp_path, s3)
    for pattern, recurse in PATTERNS:
        uri = pattern.format(root=root)
        assert [_uri_fields(u) for u in fs.expand_uri_patterns(uri)] == [
            _uri_fields(u) for u in ref_fs.expand_uri_patterns(uri)], uri
        if "missing" in uri:
            # the port skips a segment that names nothing (its listing
            # raises only when nothing at all matched)
            assert _names(fs.list_split_files(uri)) == [
                (f"{root}/d/b.txt", 4, fs.FILE_TYPE_FILE)]
            continue
        assert _names(fs.list_split_files(uri, recurse)) == _names(
            ref_fs.list_split_files(uri, recurse)), (uri, recurse)
    with pytest.raises(DMLCError, match="Cannot find"):
        fs.list_split_files(f"{root}/nothing-here")


@pytest.mark.parametrize("kind", ["local", "mem", "s3"])
def test_streams_and_directory_helpers(kind, tmp_path, s3):
    root = _tree(kind, tmp_path, s3)
    fs.makedirs(f"{root}/new")  # a local directory; a no-op elsewhere
    with fs.create_stream(f"{root}/new/x.bin", "w") as out:
        out.write(b"payload")
    assert fs.exists(f"{root}/new/x.bin")
    with fs.create_stream_for_read(f"{root}/new/x.bin") as stream:
        stream.seek(3)
        assert stream.read(100) == b"load"
    assert fs.list_dir(f"{root}/new") == ["x.bin"]
    assert "d" in fs.list_dir(root)
    assert fs.create_stream(f"{root}/none.bin", "r", allow_null=True) is None
    fs.atomic_write(f"{root}/new/y.bin", b"atomic")
    with fs.create_stream(f"{root}/new/y.bin", "r") as stream:
        assert stream.read_all() == b"atomic"
    if kind != "s3":  # the fake S3 server has no DELETE
        fs.delete(f"{root}/new/y.bin")
        assert not fs.exists(f"{root}/new/y.bin")
        fs.delete(f"{root}/new/y.bin")  # a missing file is no error


def test_memory_filesystem_is_shared_and_appends():
    fs.MemoryFileSystem.reset()
    with fs.create_stream("mem://h/a", "w") as out:
        out.write(b"one")
    with fs.create_stream("mem://h/a", "a") as out:
        out.write(b"two")
    other = fs.MemoryFileSystem()  # the store is class-level
    assert other.open_for_read(fs.URI.parse("mem://h/a")).read(10) \
        == b"onetwo"
    info = other.get_path_info(fs.URI.parse("mem://h"))
    assert info.type == fs.FILE_TYPE_DIR
    fs.MemoryFileSystem.reset()
    assert not fs.exists("mem://h/a")


def test_unknown_and_gated_schemes_raise():
    with pytest.raises(DMLCError, match="unknown filesystem protocol"):
        fs.create_stream("nosuch://x/y", "r")
    with pytest.raises(DMLCError, match="not enabled"):
        fs.create_stream("viewfs://cluster/p", "r")
    with pytest.raises(DMLCError, match="read-only"):
        fs.HTTPFileSystem().open(fs.URI.parse("http://h/x"), "w")


# ---------------------------------------------------------------------------
# the range-read loop
# ---------------------------------------------------------------------------


class _Resp:
    """A duck-typed response: ``body`` served, promising ``length``."""

    def __init__(self, body, length=None, readinto=True):
        self._body = memoryview(body)
        self.headers = {} if length is None else {
            "Content-Length": str(length)}
        if not readinto:
            self.readinto = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read(self, n):
        out, self._body = bytes(self._body[:n]), self._body[n:]
        return out

    def readinto(self, view):
        n = min(len(view), len(self._body))
        view[:n] = self._body[:n]
        self._body = self._body[n:]
        return n


DATA = bytes(range(256)) * 40


def _opener(cut=None, readinto=True, log=None):
    """open_ranged over DATA; each response stops after ``cut`` bytes while
    promising the whole range (a dropped connection)."""

    def open_ranged(start, end):
        if log is not None:
            log.append((start, end))
        body = DATA[start:min(end, len(DATA))]
        sent = body if cut is None else body[:cut]
        return _Resp(sent, len(body), readinto)

    return open_ranged


@pytest.mark.parametrize("readinto", [True, False])
def test_read_range_retries_truncation_from_where_it_stopped(readinto):
    log = []
    got = fs.read_range_with_retry(_opener(cut=700, readinto=readinto,
                                           log=log),
                                   100, 5000, "t", retry_sleep_s=0.0)
    assert bytes(got) == DATA[100:5100]
    assert log[:3] == [(100, 5100), (800, 5100), (1500, 5100)]
    ref = ref_fs.read_range_with_retry(_opener(cut=700, readinto=readinto),
                                       100, 5000, "t", retry_sleep_s=0.0)
    assert bytes(ref) == bytes(got)


def test_read_range_clean_short_response_is_the_end():
    got = fs.read_range_with_retry(_opener(), len(DATA) - 10, 100, "t")
    assert bytes(got) == DATA[-10:]
    assert bytes(got) == bytes(ref_fs.read_range_with_retry(
        _opener(), len(DATA) - 10, 100, "t"))


def test_read_range_416_is_an_empty_range():
    def open_ranged(start, end):
        raise urllib.error.HTTPError("u", 416, "range", {}, None)

    assert fs.read_range_with_retry(open_ranged, 10**6, 10, "t") == b""
    assert ref_fs.read_range_with_retry(open_ranged, 10**6, 10, "t") == b""


def test_read_range_into_a_callers_buffer():
    buf = bytearray(6000)
    n = fs.read_range_with_retry(_opener(cut=999), 7, 5000, "t",
                                 retry_sleep_s=0.0,
                                 into=memoryview(buf)[500:])
    assert n == 5000 and bytes(buf[500:5500]) == DATA[7:5007]
    assert buf[:500] == bytearray(500) and buf[5500:] == bytearray(500)


def test_read_range_exhausted_retries_raise():
    def open_ranged(start, end):
        raise ConnectionResetError("down")

    with pytest.raises(DMLCError, match="gave up after 3 attempt"):
        fs.read_range_with_retry(open_ranged, 0, 10, "t", max_retry=3,
                                 retry_sleep_s=0.0)


def test_read_range_counts_injected_faults_as_retries():
    before = retry.stats()["attempts"].get("io.read", 0)
    configure_faults("io.read:nth=1:times=2")
    try:
        got = fs.read_range_with_retry(_opener(), 0, 300, "t",
                                       retry_sleep_s=0.0)
    finally:
        reset_faults()
    assert bytes(got) == DATA[:300]
    assert retry.stats()["attempts"]["io.read"] == before + 2


def test_ranged_read_stream_reconnects_on_short_reads(s3):
    data = os.urandom(64 << 10)
    s3.objects[("bkt", "r")] = data
    s3.fail_after_bytes = 8 << 10
    stream = fs.create_stream_for_read("s3://bkt/r")
    assert stream.read(len(data)) == data
    stream.seek(1000)
    assert stream.read(10) == data[1000:1010]
    stream.close()


def test_object_store_read_range_is_one_request_a_call(s3):
    data = os.urandom(50_000)
    s3.objects[("bkt", "b")] = data
    path = fs.URI.parse("s3://bkt/b")
    backend = fs.get_filesystem(path)
    before = s3.request_count
    assert bytes(backend.read_range(path, 0, 20_000)) == data[:20_000]
    assert bytes(backend.read_range(path, 45_000, 20_000)) == data[45_000:]
    assert s3.request_count - before == 2


# ---------------------------------------------------------------------------
# retry progress and hedged calls
# ---------------------------------------------------------------------------


def _no_sleep_policy(**kw):
    return RetryPolicy(base_s=0.0, cap_s=0.0, sleep=lambda s: None, **kw)


def test_retry_state_progress_refills_attempts():
    state = _no_sleep_policy(max_attempts=2).start("t.progress")
    for _ in range(5):  # each failure after progress starts afresh
        state.failed(OSError("drop"), progressed=True)
    assert state.attempts_left == 1 and state.total_attempts == 5
    with pytest.raises(DMLCError, match="attempts exhausted"):
        state.failed(OSError("drop"))


def test_retry_state_progress_is_capped_by_the_ceiling():
    state = _no_sleep_policy(max_attempts=2).start("t.ceiling")
    with pytest.raises(DMLCError, match="absolute attempt ceiling"):
        for _ in range(100):
            state.failed(OSError("drip"), progressed=True)
    assert state.total_attempts == 20


def test_retry_state_cancel_and_global_budget(monkeypatch):
    state = _no_sleep_policy(max_attempts=5).start(
        "t.cancel", cancelled=lambda: True)
    with pytest.raises(DMLCError, match="cancelled"):
        state.failed(OSError("x"))
    monkeypatch.setenv("DMLC_TPU_RETRY_BUDGET", "1")
    retry.reset_global_budget()
    try:
        assert retry.global_budget().capacity == 1
        with pytest.raises(DMLCError, match="budget"):
            _no_sleep_policy(max_attempts=50).call(
                lambda: (_ for _ in ()).throw(OSError("down")), "t.budget")
    finally:
        monkeypatch.delenv("DMLC_TPU_RETRY_BUDGET")
        retry.reset_global_budget()
    assert retry.global_budget().capacity == 0  # unlimited again


def test_hedged_call_inline_when_off():
    threads = threading.active_count()
    assert hedged_call(lambda: 7, 0.0) == 7
    assert threading.active_count() == threads


def test_hedged_call_backup_wins_a_straggler():
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(1.0)  # the straggling primary
            return "slow"
        return "fast"

    assert hedged_call(fn, 0.05, site="t.hedge") == "fast"
    assert len(calls) == 2


def test_hedged_call_raises_only_when_both_fail():
    calls = []

    def flaky():
        calls.append(1)
        time.sleep(0.1)
        if len(calls) == 1:
            raise OSError("primary failed")
        return "backup"

    assert hedged_call(flaky, 0.02, site="t.hedge2") == "backup"

    def dead():
        time.sleep(0.05)
        raise OSError("down")

    with pytest.raises(OSError, match="down"):
        hedged_call(dead, 0.01, site="t.hedge3")


def test_faultpoint_sites_of_the_remote_layer_fire():
    for site in ("io.read", "io.write", "readahead.fetch",
                 "collective.send", "collective.recv"):
        configure_faults(f"{site}:nth=1")
        try:
            with pytest.raises(OSError, match=site):
                faultpoint(site)
        finally:
            reset_faults()

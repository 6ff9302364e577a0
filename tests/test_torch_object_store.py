"""The port's object stores (``s3://``, ``gs://``) against the JAX
package's, on one in-process fake server: SigV4 headers equal to the
reference's on seeded inputs, round trips, multipart and resumable
uploads, listing, ranged reads, reconnects, per-thread keep-alive
connections, and objects written by one package and read by the other.
"""

import datetime
import os
import random
import threading

import pytest

from dmlc_tpu.io import filesystem as ref_fs
from dmlc_tpu.io.object_store import GCSFileSystem as RefGCSFileSystem
from dmlc_tpu.io.object_store import S3FileSystem as RefS3FileSystem
from dmlc_tpu.io.object_store import _sigv4_headers as ref_sigv4
from dmlc_tpu_torch.io import filesystem as fs
from dmlc_tpu_torch.io import object_store
from dmlc_tpu_torch.io.object_store import (GCSFileSystem, S3FileSystem,
                                            _sigv4_headers)
from dmlc_tpu_torch.resilience import configure as configure_faults
from dmlc_tpu_torch.resilience import reset as reset_faults
from dmlc_tpu_torch.resilience import retry
from tests.fake_object_store import serve


@pytest.fixture()
def s3(monkeypatch):
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


@pytest.fixture()
def gcs(monkeypatch):
    server, store, base = serve()
    monkeypatch.setenv("GCS_ENDPOINT_URL", base)
    monkeypatch.setenv("DMLC_GCS_WRITE_BUFFER_MB", "1")
    fs.register_filesystem("gs://", lambda uri: GCSFileSystem())
    ref_fs.register_filesystem("gs://", lambda uri: RefGCSFileSystem())
    yield store
    server.shutdown()
    server.server_close()
    fs.register_filesystem("gs://", lambda uri: GCSFileSystem())
    ref_fs.register_filesystem("gs://", lambda uri: RefGCSFileSystem())


# ---------------------------------------------------------------------------
# signing
# ---------------------------------------------------------------------------


def _sig_case(seed):
    r = random.Random(seed)
    word = lambda n: "".join(r.choice("abcdefgh/_-.~ 0123") for _ in range(n))
    method = r.choice(["GET", "PUT", "POST", "HEAD", "DELETE"])
    query = "&".join(f"{word(3).strip() or 'k'}={word(5)}"
                     for _ in range(r.randint(0, 3)))
    url = (f"https://s3.example.com:{r.randint(1, 9999)}/bkt/"
           f"{word(8).strip('/') or 'x'}" + (f"?{query}" if query else ""))
    now = datetime.datetime(2020 + r.randint(0, 6), r.randint(1, 12),
                            r.randint(1, 28), r.randint(0, 23),
                            r.randint(0, 59), r.randint(0, 59),
                            tzinfo=datetime.timezone.utc)
    return dict(method=method, url=url, region=r.choice(["us-east-1",
                                                          "eu-west-3"]),
                access_key=word(12), secret_key=word(20),
                payload=r.randbytes(r.randint(0, 64)),
                session_token=r.choice([None, word(10)]), now=now)


@pytest.mark.parametrize("seed", range(8))
def test_sigv4_headers_equal_reference(seed):
    case = _sig_case(seed)
    assert _sigv4_headers(**case) == ref_sigv4(**case)


def test_sigv4_known_vector():
    """AWS's documented get-vanilla example, as the reference pins it."""
    now = datetime.datetime(2015, 8, 30, 12, 36, 0,
                            tzinfo=datetime.timezone.utc)
    hdrs = _sigv4_headers("GET", "https://example.amazonaws.com/",
                          "us-east-1", "AKIDEXAMPLE",
                          "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", b"",
                          None, now)
    assert hdrs["x-amz-date"] == "20150830T123600Z"
    assert hdrs["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/us-east-1/s3/"
        "aws4_request, SignedHeaders=host;x-amz-content-sha256;x-amz-date,")
    assert hdrs == ref_sigv4("GET", "https://example.amazonaws.com/",
                             "us-east-1", "AKIDEXAMPLE",
                             "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", b"",
                             None, now)


def test_credential_precedence_and_endpoint(monkeypatch):
    for name in ("S3_ENDPOINT", "AWS_ENDPOINT_URL", "S3_REGION"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "aws-ak")
    monkeypatch.setenv("S3_ACCESS_KEY", "s3-ak")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "aws-sk")
    monkeypatch.setenv("AWS_REGION", "ap-south-1")
    got, want = S3FileSystem(), RefS3FileSystem()
    for attr in ("access_key", "secret_key", "session_token", "region",
                 "endpoint", "verify_ssl", "part_bytes"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.access_key == "s3-ak"
    assert got.endpoint == "https://s3.ap-south-1.amazonaws.com"
    monkeypatch.setenv("DMLC_GCS_WRITE_BUFFER_MB", "3")
    assert GCSFileSystem().part_bytes == RefGCSFileSystem().part_bytes \
        == 3 << 20


# ---------------------------------------------------------------------------
# S3
# ---------------------------------------------------------------------------


def test_s3_roundtrip_small(s3):
    with fs.create_stream("s3://bkt/dir/a.bin", "w") as w:
        w.write(b"hello object world")
    assert s3.objects[("bkt", "dir/a.bin")] == b"hello object world"
    r = fs.create_stream_for_read("s3://bkt/dir/a.bin")
    assert r.read(5) == b"hello"
    r.seek(6)
    assert r.read(100) == b"object world"
    r.close()


def test_s3_multipart_upload(s3):
    payload = bytes(range(256)) * 4096 * 5  # 5 MB > the 1 MB part
    before = s3.request_count
    with fs.create_stream("s3://bkt/big.bin", "w") as w:
        w.write(payload)
    assert s3.objects[("bkt", "big.bin")] == payload
    assert not s3.uploads  # completed and cleaned up
    # init, 5 full parts, the empty last part (the reference sends it
    # too), complete
    assert s3.request_count - before == 1 + 6 + 1


def test_s3_list_directory_and_stat(s3):
    for k in ("d/x.txt", "d/y.txt", "d/sub/z.txt", "other.txt"):
        s3.objects[("bkt", k)] = b"123"
    path = fs.URI.parse("s3://bkt/d")
    got = fs.get_filesystem(path).list_directory(path)
    want = ref_fs.get_filesystem(ref_fs.URI.parse("s3://bkt/d")
                                 ).list_directory(ref_fs.URI.parse("s3://bkt/d"))
    assert [(i.path.str_full(), i.size, i.type) for i in got] == \
        [(i.path.str_full(), i.size, i.type) for i in want]
    assert ("/d/sub", fs.FILE_TYPE_DIR) in [(i.path.name, i.type)
                                             for i in got]
    backend = fs.get_filesystem(path)
    assert backend.get_path_info(fs.URI.parse("s3://bkt/d/x.txt")).size == 3
    assert backend.get_path_info(path).type == fs.FILE_TYPE_DIR
    with pytest.raises(FileNotFoundError):
        backend.get_path_info(fs.URI.parse("s3://bkt/nope"))
    assert fs.create_stream_for_read("s3://bkt/nope",
                                     allow_null=True) is None


def test_s3_ranged_reads_and_reconnects(s3):
    data = os.urandom(200_000)
    s3.objects[("bkt", "r")] = data
    backend = fs.get_filesystem(fs.URI.parse("s3://bkt/r"))
    path = fs.URI.parse("s3://bkt/r")
    assert bytes(backend.read_range(path, 1000, 50_000)) == data[1000:51_000]
    assert bytes(backend.read_range(path, 190_000, 50_000)) == data[190_000:]
    s3.fail_after_bytes = 40 << 10  # every response dropped after 40 KiB
    assert bytes(backend.read_range(path, 5, 100_000)) == data[5:100_005]
    ref = ref_fs.get_filesystem(ref_fs.URI.parse("s3://bkt/r"))
    assert bytes(ref.read_range(ref_fs.URI.parse("s3://bkt/r"), 5,
                                100_000)) == data[5:100_005]


def test_s3_keepalive_connection_per_thread(s3):
    data = os.urandom(300_000)
    s3.objects[("bkt", "k")] = data
    path = fs.URI.parse("s3://bkt/k")
    backend = fs.get_filesystem(path)
    out, conns = {}, {}

    def worker(i):
        for j in range(3):
            off = (i * 3 + j) * 20_000
            out[(i, j)] = bytes(backend.read_range(path, off, 20_000))
        conns[i] = dict(object_store._keepalive_local.conns)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (i, j), got in out.items():
        off = (i * 3 + j) * 20_000
        assert got == data[off:off + 20_000]
    # each thread kept its own connection, reused across its ranges
    assert len({id(c) for d in conns.values() for c in d.values()}) == 4


def test_s3_signed_requests_read(s3, monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "ak")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "sk")
    fs.register_filesystem("s3://", lambda uri: S3FileSystem())
    s3.objects[("bkt", "f")] = b"xyz"
    with fs.create_stream_for_read("s3://bkt/f") as r:
        assert r.read(3) == b"xyz"
    path = fs.URI.parse("s3://bkt/f")
    assert bytes(fs.get_filesystem(path).read_range(path, 1, 2)) == b"yz"


def test_s3_write_faults_retry_then_give_up(s3):
    before = retry.stats()["attempts"].get("io.s3.write", 0)
    configure_faults("io.write:nth=1")
    try:
        with fs.create_stream("s3://bkt/w", "w") as w:
            w.write(b"retried")
    finally:
        reset_faults()
    assert s3.objects[("bkt", "w")] == b"retried"
    assert retry.stats()["attempts"]["io.s3.write"] == before + 1
    configure_faults("io.write:nth=1:times=3")
    try:
        stream = fs.create_stream("s3://bkt/lost", "w")
        stream.write(b"x")
        with pytest.raises(Exception, match="gave up after 3"):
            stream.close()
    finally:
        reset_faults()
    assert ("bkt", "lost") not in s3.objects


def test_s3_stream_uploads_on_destruction(s3):
    stream = fs.create_stream("s3://bkt/gc", "w")
    stream.write(b"flushed by __del__")
    del stream
    assert s3.objects[("bkt", "gc")] == b"flushed by __del__"


# ---------------------------------------------------------------------------
# GCS
# ---------------------------------------------------------------------------


def test_gcs_roundtrip_and_ranged_read(gcs):
    with fs.create_stream("gs://bkt/obj.txt", "w") as w:
        w.write(b"gcs payload 0123456789")
    assert gcs.objects[("bkt", "obj.txt")] == b"gcs payload 0123456789"
    r = fs.create_stream_for_read("gs://bkt/obj.txt")
    assert r.read(3) == b"gcs"
    r.seek(12)
    assert r.read(4) == b"0123"
    r.close()
    path = fs.URI.parse("gcs://bkt/obj.txt")  # the gcs:// alias
    assert bytes(fs.get_filesystem(path).read_range(path, 4, 7)) \
        == b"payload"


def test_gcs_resumable_multi_chunk(gcs):
    payload = os.urandom(3 << 20)  # 3 MB > the 1 MB chunks
    with fs.create_stream("gs://bkt/big", "w") as w:
        w.write(payload[:100])
        w.write(payload[100:])
    assert gcs.objects[("bkt", "big")] == payload
    assert not gcs.sessions  # the session completed


def test_gcs_list_directory(gcs):
    for k in ("p/a", "p/b", "p/q/c", "x"):
        gcs.objects[("bkt", k)] = b"1"
    got = fs.list_split_files("gs://bkt/p", recurse=True)
    want = ref_fs.list_split_files("gs://bkt/p", recurse=True)
    assert [(i.path.str_full(), i.size) for i in got] == \
        [(i.path.str_full(), i.size) for i in want]
    assert [i.path.name for i in got] == ["/p/a", "/p/b", "/p/q/c"]


# ---------------------------------------------------------------------------
# one package writes, the other reads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["s3", "gs"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_objects_cross_packages(scheme, writer, s3, gcs):
    payload = os.urandom((2 << 20) + 12345)  # multipart / multi-chunk
    uri = f"{scheme}://bkt/cross/{writer}.bin"
    w_mod, r_mod = (fs, ref_fs) if writer == "port" else (ref_fs, fs)
    with w_mod.create_stream(uri, "w") as out:
        out.write(payload)
    store = s3 if scheme == "s3" else gcs
    assert store.objects[("bkt", f"cross/{writer}.bin")] == payload
    with r_mod.create_stream_for_read(uri) as stream:
        got = b""
        while True:
            piece = stream.read(1 << 20)
            if not piece:
                break
            got += piece
    assert got == payload

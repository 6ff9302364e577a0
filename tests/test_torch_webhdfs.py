"""The port's ``hdfs://`` backend (WebHDFS) against the in-process fake
namenode/datanode, with the cases of the JAX package's test_webhdfs.py and
files written by one package and read by the other."""

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.io import filesystem as ref_fs
from dmlc_tpu.io.webhdfs import _factory as ref_factory
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.io import filesystem as fs
from dmlc_tpu_torch.io.webhdfs import (DEFAULT_HTTP_PORT, WebHDFSFileSystem,
                                       _factory)
from tests.fake_webhdfs import FakeWebHDFS


@pytest.fixture
def hdfs(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")
    monkeypatch.delenv("DMLC_WEBHDFS_ENDPOINT", raising=False)
    monkeypatch.delenv("HADOOP_USER_NAME", raising=False)
    fs.register_filesystem("hdfs://", _factory)  # drop cached instances
    ref_fs.register_filesystem("hdfs://", ref_factory)
    fake = FakeWebHDFS()
    yield fake
    fake.close()


def _uri(fake, path):
    return f"hdfs://127.0.0.1:{fake.port}{path}"


def test_stat_and_list(hdfs):
    hdfs.files["/data/a.txt"] = b"aaa"
    hdfs.files["/data/b.txt"] = b"bbbb"
    hdfs.files["/data/sub/c.txt"] = b"c"
    backend = fs.get_filesystem(fs.URI.parse(_uri(hdfs, "/data")))
    info = backend.get_path_info(fs.URI.parse(_uri(hdfs, "/data/a.txt")))
    assert info.type == fs.FILE_TYPE_FILE and info.size == 3
    entries = backend.list_directory(fs.URI.parse(_uri(hdfs, "/data")))
    names = [(e.path.name.rsplit("/", 1)[-1], e.type) for e in entries]
    assert ("a.txt", fs.FILE_TYPE_FILE) in names
    assert ("sub", fs.FILE_TYPE_DIR) in names
    got = fs.list_split_files(_uri(hdfs, "/data"), recurse=True)
    want = ref_fs.list_split_files(_uri(hdfs, "/data"), recurse=True)
    assert [(i.path.str_full(), i.size) for i in got] == \
        [(i.path.str_full(), i.size) for i in want]


def test_ranged_read_and_seek(hdfs):
    payload = bytes(range(256)) * 40
    hdfs.files["/blob.bin"] = payload
    with fs.create_stream_for_read(_uri(hdfs, "/blob.bin")) as s:
        assert s.read(10) == payload[:10]
        s.seek(5000)
        assert s.read(16) == payload[5000:5016]
        s.seek(0)
        whole = b""
        while True:
            piece = s.read(4096)
            if not piece:
                break
            whole += piece
    assert whole == payload
    # the seek back reopened at the right offset
    assert ("/blob.bin", 5000) in hdfs.open_requests
    path = fs.URI.parse(_uri(hdfs, "/blob.bin"))
    got = fs.get_filesystem(path).read_range(path, 700, 3000)
    assert bytes(got) == payload[700:3700]


def test_write_create_and_append(hdfs, monkeypatch):
    monkeypatch.setenv("DMLC_HDFS_WRITE_BUFFER_MB", "1")
    fs.register_filesystem("hdfs://", _factory)  # read the buffer again
    payload = np.random.RandomState(0).bytes((1 << 20) * 2 + 12345)
    with fs.create_stream(_uri(hdfs, "/out/model.bin"), "w") as s:
        s.write(payload[:1 << 20])
        s.write(payload[1 << 20:])
    assert hdfs.files["/out/model.bin"] == payload


def test_directory_stat_and_missing_file(hdfs):
    hdfs.files["/data/sub/c.txt"] = b"c"
    backend = fs.get_filesystem(fs.URI.parse(_uri(hdfs, "/")))
    assert backend.get_path_info(
        fs.URI.parse(_uri(hdfs, "/data/sub"))).type == fs.FILE_TYPE_DIR
    with pytest.raises(FileNotFoundError):
        backend.get_path_info(fs.URI.parse(_uri(hdfs, "/nope.txt")))
    assert backend.open_for_read(fs.URI.parse(_uri(hdfs, "/nope.txt")),
                                 allow_null=True) is None
    assert not fs.exists(_uri(hdfs, "/nope.txt"))


def test_default_port_user_and_endpoint(monkeypatch):
    got = WebHDFSFileSystem(fs.URI.parse("hdfs://namenode/path"))
    assert f":{DEFAULT_HTTP_PORT}/webhdfs/v1" in got._base
    assert ":1234/webhdfs/v1" in WebHDFSFileSystem(
        fs.URI.parse("hdfs://namenode:1234/path"))._base
    monkeypatch.setenv("HADOOP_USER_NAME", "alice")
    monkeypatch.setenv("DMLC_WEBHDFS_ENDPOINT", "http://gw:8443/gateway/")
    got = WebHDFSFileSystem(fs.URI.parse("hdfs://ignored/x"))
    want = ref_factory(ref_fs.URI.parse("hdfs://ignored/x"))
    assert got._url("/a b/c", "OPEN", offset=3) == \
        want._url("/a b/c", "OPEN", offset=3)
    assert "user.name=alice" in got._url("/x", "OPEN")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_cross_packages(hdfs, writer):
    payload = np.random.RandomState(5).bytes(300_000)
    uri = _uri(hdfs, f"/cross/{writer}.bin")
    w_mod, r_mod = (fs, ref_fs) if writer == "port" else (ref_fs, fs)
    with w_mod.create_stream(uri, "w") as out:
        out.write(payload)
    with r_mod.create_stream(uri, "r") as stream:
        got = b""
        while True:
            piece = stream.read(65536)
            if not piece:
                break
            got += piece
    assert got == payload


def test_parser_over_hdfs_matches_reference(hdfs):
    rng = np.random.RandomState(1)
    lines = [f"{i % 2} " + " ".join(f"{j + 1}:{rng.rand():.4f}"
                                     for j in range(5)) for i in range(100)]
    hdfs.files["/ds/train.svm"] = ("\n".join(lines) + "\n").encode()
    for part in range(2):
        uri = _uri(hdfs, "/ds/train.svm")
        got = create_parser(uri, part, 2, device="cpu", threaded=False)
        want = ref_create_parser(uri, part, 2)
        try:
            gb, wb = list(got), list(want)
        finally:
            got.close()
            want.close()
        assert sum(len(b) for b in gb) == sum(len(b) for b in wb) > 0
        for g, w in zip(gb, wb):
            assert np.array_equal(g.offset, np.asarray(w.offset))
            assert np.array_equal(g.label, np.asarray(w.label))
            assert np.array_equal(g.index, np.asarray(w.index))
            assert np.array_equal(g.value, np.asarray(w.value))

"""The port's ``azure://`` backend (Blob REST) against the in-process fake
service, with the cases of the JAX package's test_azure.py, the SharedKey
string-to-sign equal to the reference's, the filesys CLI, and blobs
written by one package and read by the other."""

import base64
import os

import numpy as np
import pytest

from dmlc_tpu.io import filesystem as ref_fs
from dmlc_tpu.io.azure import AzureBlobFileSystem as RefAzure
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.io import filesystem as fs
from dmlc_tpu_torch.io.azure import AzureBlobFileSystem
from dmlc_tpu_torch.tools.filesys import main as filesys_main
from tests.fake_azure import serve

_AZURE_ENV = ("AZURE_STORAGE_ENDPOINT", "AZURE_STORAGE_ACCOUNT",
              "AZURE_STORAGE_ACCESS_KEY", "AZURE_STORAGE_KEY",
              "AZURE_STORAGE_SAS_TOKEN", "DMLC_AZURE_WRITE_BUFFER_MB")


@pytest.fixture
def azure(monkeypatch):
    server, store, base = serve()
    for name in _AZURE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AZURE_STORAGE_ENDPOINT", base)
    fs.register_filesystem("azure://", lambda uri: AzureBlobFileSystem())
    ref_fs.register_filesystem("azure://", lambda uri: RefAzure())
    yield store
    server.shutdown()
    server.server_close()
    # drop the instances bound to this server's endpoint
    fs.register_filesystem("azure://", lambda uri: AzureBlobFileSystem())
    ref_fs.register_filesystem("azure://", lambda uri: RefAzure())


def test_stat_and_ranged_read(azure):
    data = bytes(range(256)) * 100
    azure.blobs[("cont", "a/b.bin")] = data
    path = fs.URI.parse("azure://cont/a/b.bin")
    backend = fs.get_filesystem(path)
    assert backend.get_path_info(path).size == len(data)
    assert bytes(backend.read_range(path, 100, 5000)) == data[100:5100]
    assert bytes(backend.read_range(path, len(data) + 5, 10)) == b""  # 416


def test_stream_read_and_seek(azure):
    data = b"0123456789" * 1000
    azure.blobs[("cont", "s.bin")] = data
    with fs.create_stream("azure://cont/s.bin", "r") as stream:
        assert stream.read(10) == data[:10]
        stream.seek(9990)
        assert stream.read(100) == data[9990:]


def test_missing_blob(azure):
    path = fs.URI.parse("azure://cont/nope")
    backend = fs.get_filesystem(path)
    with pytest.raises(FileNotFoundError):
        backend.get_path_info(path)
    assert not backend.exists(path)


def test_list_directory_with_prefixes(azure):
    azure.blobs[("cont", "d/x.txt")] = b"x"
    azure.blobs[("cont", "d/y.txt")] = b"yy"
    azure.blobs[("cont", "d/sub/z.txt")] = b"zzz"
    path = fs.URI.parse("azure://cont/d")
    by_name = {i.path.name: i
               for i in fs.get_filesystem(path).list_directory(path)}
    assert by_name["/d/x.txt"].type == fs.FILE_TYPE_FILE
    assert by_name["/d/y.txt"].size == 2
    assert by_name["/d/sub"].type == fs.FILE_TYPE_DIR
    got = fs.list_split_files("azure://cont/d", recurse=True)
    want = ref_fs.list_split_files("azure://cont/d", recurse=True)
    assert [(i.path.str_full(), i.size) for i in got] == \
        [(i.path.str_full(), i.size) for i in want]


def test_list_paging(azure):
    azure.max_list_results = 3
    for i in range(10):
        azure.blobs[("cont", f"p/f{i:02d}")] = b"q"
    path = fs.URI.parse("azure://cont/p")
    assert len(fs.get_filesystem(path).list_directory(path)) == 10


def test_small_write_put_blob(azure):
    with fs.create_stream("azure://cont/out/small.bin", "w") as out:
        out.write(b"hello ")
        out.write(b"azure")
    assert azure.blobs[("cont", "out/small.bin")] == b"hello azure"
    assert not azure.blocks


def test_multiblock_write(azure, monkeypatch):
    monkeypatch.setenv("DMLC_AZURE_WRITE_BUFFER_MB", "1")
    fs.register_filesystem("azure://", lambda uri: AzureBlobFileSystem())
    data = bytes(range(256)) * (12 << 10)  # 3 MiB: three blocks
    with fs.create_stream("azure://cont/out/big.bin", "w") as out:
        out.write(data)
    assert azure.blobs[("cont", "out/big.bin")] == data
    assert len(azure.blocks) == 3


def test_delete(azure):
    azure.blobs[("cont", "dead")] = b"x"
    fs.delete("azure://cont/dead")
    assert ("cont", "dead") not in azure.blobs


def test_filesys_cli_ls_cat_cp(azure, tmp_path, capsys):
    azure.blobs[("cont", "t/a.txt")] = b"alpha\n"
    assert filesys_main(["ls", "azure://cont/t"]) == 0
    assert "azure://cont/t/a.txt" in capsys.readouterr().out
    assert filesys_main(["cat", "azure://cont/t/a.txt"]) == 0
    assert "alpha" in capsys.readouterr().out
    local = tmp_path / "copy.txt"
    assert filesys_main(["cp", "azure://cont/t/a.txt", str(local)]) == 0
    assert local.read_bytes() == b"alpha\n"
    up = tmp_path / "up.txt"
    up.write_bytes(b"uploaded")
    assert filesys_main(["cp", str(up), "azure://cont/t/up.txt"]) == 0
    assert azure.blobs[("cont", "t/up.txt")] == b"uploaded"
    assert filesys_main(["mv", "a", "b"]) == 2


def test_parser_over_azure_counts_rows(azure):
    rng = np.random.RandomState(3)
    lines = [f"{i % 2} " + " ".join(f"{j + 1}:{rng.rand():.4f}"
                                     for j in range(5)) for i in range(2000)]
    azure.blobs[("cont", "ds/train.svm")] = ("\n".join(lines) + "\n").encode()
    total = 0
    for part in range(3):
        parser = create_parser("azure://cont/ds/train.svm", part, 3,
                               device="cpu")
        total += sum(len(b) for b in parser)
        parser.close()
    assert total == 2000


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_blobs_cross_packages(azure, writer, monkeypatch):
    monkeypatch.setenv("DMLC_AZURE_WRITE_BUFFER_MB", "1")
    fs.register_filesystem("azure://", lambda uri: AzureBlobFileSystem())
    ref_fs.register_filesystem("azure://", lambda uri: RefAzure())
    payload = os.urandom((2 << 20) + 77)
    uri = f"azure://cont/cross/{writer}.bin"
    w_mod, r_mod = (fs, ref_fs) if writer == "port" else (ref_fs, fs)
    with w_mod.create_stream(uri, "w") as out:
        out.write(payload)
    path = r_mod.URI.parse(uri)
    got = r_mod.get_filesystem(path).read_range(path, 0, len(payload))
    assert bytes(got) == payload


# ---------------------------------------------------------------------------
# SharedKey and SAS
# ---------------------------------------------------------------------------

SIGN_CASES = [
    ("GET", "a/b.bin", "comp=list&restype=container",
     {"Range": "bytes=0-99"}, 0),
    ("PUT", "out/x y.bin", "", {"x-ms-blob-type": "BlockBlob",
                                "Content-Type": "application/octet-stream"},
     1234),
    ("PUT", "k", "blockid=MDAwMDAwMDAwMQ%3D%3D&comp=block",
     {"Content-Type": "application/octet-stream"}, 65536),
    ("HEAD", "deep/k/v", "", {}, 0),
    ("DELETE", "k", "", {"x-ms-meta-Z": " spaced "}, 0),
]


@pytest.mark.parametrize("method,key,query,headers,length", SIGN_CASES)
def test_shared_key_signature_equals_reference(monkeypatch, method, key,
                                               query, headers, length):
    for name in _AZURE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", "acct")
    monkeypatch.setenv("AZURE_STORAGE_ACCESS_KEY",
                       base64.b64encode(b"0123456789abcdef").decode())
    got_fs, want_fs = AzureBlobFileSystem(), RefAzure()
    assert got_fs.endpoint == "https://acct.blob.core.windows.net"
    url = got_fs._url("cont", key, query)
    assert url == want_fs._url("cont", key, query)
    hdrs = dict(headers, **{"x-ms-date": "Thu, 01 Jan 2026 00:00:00 GMT"})
    got = got_fs._auth_headers(method, url, hdrs, content_length=length)
    want = want_fs._auth_headers(method, url, hdrs, content_length=length)
    assert got == want
    assert got["Authorization"].startswith("SharedKey acct:")


def test_sas_skips_authorization(monkeypatch):
    for name in _AZURE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", "acct")
    monkeypatch.setenv("AZURE_STORAGE_SAS_TOKEN", "?sv=2021&sig=abc")
    backend = AzureBlobFileSystem()
    url = backend._url("cont", "k")
    assert url.endswith("/cont/k?sv=2021&sig=abc")
    assert "Authorization" not in backend._auth_headers("GET", url, {})
    monkeypatch.delenv("AZURE_STORAGE_ACCOUNT")
    with pytest.raises(Exception, match="AZURE_STORAGE_ACCOUNT"):
        AzureBlobFileSystem()

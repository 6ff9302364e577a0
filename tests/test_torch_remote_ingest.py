"""Remote ingest and remote checkpoints of the port against the JAX
package, on the in-process fake servers: the ordered fetch window, the
remote partition reader's plan and bytes, parsers over ``s3://``,
``hdfs://`` and ``azure://`` (libsvm, libfm, csv, recordio), the csr fit
from ``s3://`` (bit for bit against the same fit of a local file, and of
the other package), job snapshots committed by one package to ``s3://``
and restored by the other, and ``CheckpointManager`` over ``mem://``.
"""

import threading

import numpy as np
import pytest
import torch

from dmlc_tpu.collective import JobSnapshot as RefJobSnapshot
from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.io import filesystem as ref_fs
from dmlc_tpu.io.azure import AzureBlobFileSystem as RefAzure
from dmlc_tpu.io.object_store import S3FileSystem as RefS3FileSystem
from dmlc_tpu.io.readahead import RemotePartitionReader as RefReader
from dmlc_tpu.io.webhdfs import _factory as ref_hdfs_factory
from dmlc_tpu.models import LinearLearner as RefLinearLearner
from dmlc_tpu_torch.collective import CheckpointManager, JobSnapshot
from dmlc_tpu_torch.data import convert_to_recordio, create_parser
from dmlc_tpu_torch.io import filesystem as fs
from dmlc_tpu_torch.io.azure import AzureBlobFileSystem
from dmlc_tpu_torch.io.object_store import S3FileSystem
from dmlc_tpu_torch.io.readahead import RemotePartitionReader, fetch_ordered
from dmlc_tpu_torch.io.webhdfs import _factory as hdfs_factory
from dmlc_tpu_torch.models import LinearLearner, params_to_numpy
from dmlc_tpu_torch.resilience import configure as configure_faults
from dmlc_tpu_torch.resilience import preempt
from dmlc_tpu_torch.resilience import reset as reset_faults
from dmlc_tpu_torch.resilience import retry
from dmlc_tpu_torch.utils import DMLCError
from tests.fake_azure import serve as serve_azure
from tests.fake_object_store import serve as serve_s3
from tests.fake_webhdfs import FakeWebHDFS


@pytest.fixture(autouse=True)
def vector_backend(monkeypatch):
    """The JAX package's numpy parse and Python InputSplit stack, never
    its native core: the port follows that stack."""
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")


@pytest.fixture(scope="module")
def servers():
    """The three fakes, started once for the module."""
    s3_server, s3_store, s3_base = serve_s3()
    az_server, az_store, az_base = serve_azure()
    hdfs = FakeWebHDFS()
    yield (s3_store, s3_base), (az_store, az_base), hdfs
    for server in (s3_server, az_server):
        server.shutdown()
        server.server_close()
    hdfs.close()
    # drop the instances bound to these servers' endpoints
    fs.register_filesystem("s3://", lambda uri: S3FileSystem())
    fs.register_filesystem("azure://", lambda uri: AzureBlobFileSystem())
    ref_fs.register_filesystem("s3://", lambda uri: RefS3FileSystem())
    ref_fs.register_filesystem("azure://", lambda uri: RefAzure())


@pytest.fixture()
def remote(monkeypatch, servers):
    """Empty fake stores with both packages' backends pointed at them;
    {scheme: (root uri, put(key, bytes), store)}."""
    (s3_store, s3_base), (az_store, az_base), hdfs = servers
    s3_store.objects.clear()
    s3_store.fail_after_bytes = None
    az_store.blobs.clear()
    hdfs.files.clear()
    monkeypatch.setenv("S3_ENDPOINT", s3_base)
    monkeypatch.setenv("AZURE_STORAGE_ENDPOINT", az_base)
    for name in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
                 "S3_ACCESS_KEY", "S3_SECRET_KEY", "AZURE_STORAGE_ACCOUNT",
                 "AZURE_STORAGE_ACCESS_KEY", "AZURE_STORAGE_SAS_TOKEN",
                 "DMLC_WEBHDFS_ENDPOINT", "HADOOP_USER_NAME"):
        monkeypatch.delenv(name, raising=False)
    fs.register_filesystem("s3://", lambda uri: S3FileSystem())
    fs.register_filesystem("azure://", lambda uri: AzureBlobFileSystem())
    fs.register_filesystem("hdfs://", hdfs_factory)
    ref_fs.register_filesystem("s3://", lambda uri: RefS3FileSystem())
    ref_fs.register_filesystem("azure://", lambda uri: RefAzure())
    ref_fs.register_filesystem("hdfs://", ref_hdfs_factory)

    def put_s3(key, data):
        s3_store.objects[("bkt", key)] = data

    def put_azure(key, data):
        az_store.blobs[("cont", key)] = data

    def put_hdfs(key, data):
        hdfs.files["/" + key] = data

    return {"s3": ("s3://bkt", put_s3, s3_store),
            "azure": ("azure://cont", put_azure, az_store),
            "hdfs": (f"hdfs://127.0.0.1:{hdfs.port}", put_hdfs, hdfs)}


def _libsvm_lines(n, start=0):
    return b"".join(b"%d %d:%d 7:1.5\n" % ((start + i) % 2, 1 + (start + i) % 5,
                                           start + i) for i in range(n))


# ---------------------------------------------------------------------------
# the ordered fetch window
# ---------------------------------------------------------------------------


def test_fetch_ordered_preserves_order():
    assert list(fetch_ordered(lambda i: i * i, range(50), workers=8)) == [
        i * i for i in range(50)]


def test_fetch_ordered_error_propagates_in_order():
    def fetch(i):
        if i == 5:
            raise ValueError("boom")
        return i

    got = []
    with pytest.raises(ValueError):
        for x in fetch_ordered(fetch, range(10), workers=4):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


def test_fetch_ordered_bounded_window():
    started = []
    gen = fetch_ordered(lambda i: started.append(i) or i, range(100),
                        workers=2, window=4)
    assert next(gen) == 0
    threading.Event().wait(0.05)
    assert len(started) <= 6  # one consumed, at most a window ahead
    gen.close()


# ---------------------------------------------------------------------------
# the remote partition reader
# ---------------------------------------------------------------------------


def _recordio_blob(tmp_path, rows):
    src = tmp_path / "rio.svm"
    src.write_bytes(_libsvm_lines(rows))
    rec = tmp_path / "rio.rec"
    convert_to_recordio(str(src), str(rec), rows_per_group=7, device="cpu")
    return rec.read_bytes()


@pytest.mark.parametrize("record_format,nparts", [
    ("text", 1), ("text", 2), ("text", 3), ("text", 7),
    ("recordio", 1), ("recordio", 3), ("recordio", 5)])
def test_partition_reader_matches_reference(remote, tmp_path, record_format,
                                            nparts):
    root, put, _ = remote["s3"]
    if record_format == "text":
        blobs = [_libsvm_lines(n, s) for n, s in ((3000, 0), (5, 3000),
                                                  (4000, 3005))]
    else:
        whole = _recordio_blob(tmp_path, 20_000)
        cut = (len(whole) // 3) & ~3  # files stay 4-byte aligned
        blobs = [whole[:cut], whole[cut:]]
    for i, blob in enumerate(blobs):
        put(f"parts/p{i}", blob)
    files = [(fs.URI.parse(f"{root}/parts/p{i}"), len(b))
             for i, b in enumerate(blobs)]
    ref_files = [(ref_fs.URI.parse(f"{root}/parts/p{i}"), len(b))
                 for i, b in enumerate(blobs)]
    backend = fs.get_filesystem(files[0][0])
    ref_backend = ref_fs.get_filesystem(ref_files[0][0])
    got_all = b""
    for part in range(nparts):
        got = RemotePartitionReader(backend, files, part, nparts,
                                    range_bytes=64 << 10, connections=3,
                                    record_format=record_format)
        want = RefReader(ref_backend, ref_files, part, nparts,
                         range_bytes=64 << 10, connections=3,
                         record_format=record_format)
        assert (got.begin, got.end, got.nbytes) == \
            (want.begin, want.end, want.nbytes)
        assert got.ranges() == want.ranges()
        data = b"".join(bytes(b) for b in got)
        assert data == b"".join(bytes(b) for b in want)
        got_all += data
    assert got_all == b"".join(blobs)  # every byte exactly once


def test_partition_reader_faults_and_cancel(remote):
    root, put, store = remote["s3"]
    put("f.svm", _libsvm_lines(5000))
    path = fs.URI.parse(f"{root}/f.svm")
    files = [(path, len(store.objects[("bkt", "f.svm")]))]
    backend = fs.get_filesystem(path)
    reader = RemotePartitionReader(backend, files, 0, 1)
    configure_faults("readahead.fetch:nth=1")
    try:
        with pytest.raises(OSError, match="readahead.fetch"):
            list(reader)
    finally:
        reset_faults()
    reader.cancel()
    with pytest.raises(DMLCError, match="cancelled"):
        list(reader)


def test_partition_reader_hedges_under_the_env_threshold(remote, monkeypatch):
    root, put, store = remote["s3"]
    put("h.svm", _libsvm_lines(2000))
    path = fs.URI.parse(f"{root}/h.svm")
    files = [(path, len(store.objects[("bkt", "h.svm")]))]
    monkeypatch.setenv("DMLC_TPU_HEDGE_S", "5")
    reader = RemotePartitionReader(fs.get_filesystem(path), files, 0, 1)
    assert b"".join(bytes(b) for b in reader) == _libsvm_lines(2000)


# ---------------------------------------------------------------------------
# parsers over three remote schemes
# ---------------------------------------------------------------------------

FORMATS = {
    "libsvm": ("", lambda i: b"%d %d:%d.25 %d:-1.5\n" % (
        i % 2, 1 + i % 7, i % 13, 9 + i % 4)),
    "libfm": ("?format=libfm", lambda i: b"%d %d:%d:%d.5 %d:%d:1\n" % (
        i % 2, i % 3, 1 + i % 7, i % 11, 3 + i % 2, 9 + i % 4)),
    "csv": ("?format=csv&label_column=0", lambda i: b"%d,%d.5,%d,-%d\n" % (
        i % 2, i % 9, i % 4, i % 3)),
}


def _blocks(parser):
    try:
        return [{k: np.asarray(getattr(b, k)).copy()
                 for k in ("offset", "label", "index", "value", "weight",
                           "field") if getattr(b, k) is not None}
                for b in parser]
    finally:
        parser.close()


def _same_blocks(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("scheme", ["s3", "hdfs", "azure"])
@pytest.mark.parametrize("fmt", ["libsvm", "libfm", "csv", "recordio"])
def test_parser_over_remote_matches_reference(remote, tmp_path, scheme, fmt):
    root, put, _ = remote[scheme]
    if fmt == "recordio":
        whole = _recordio_blob(tmp_path, 3000)
        cut = (len(whole) // 2) & ~3
        suffix = "?format=recordio"
    else:
        suffix, line = FORMATS[fmt]
        whole = b"".join(line(i) for i in range(3000))
        cut = whole.index(b"\n", len(whole) // 2) + 1
    put("ds/part-0", whole[:cut])
    put("ds/part-1", whole[cut:])
    uri = f"{root}/ds{suffix}"
    for part, nparts in ((0, 1), (0, 2), (1, 2)):
        # a directory of two part objects: listing and a multi-file split
        got = _blocks(create_parser(uri, part, nparts, device="cpu",
                                    threaded=False))
        want = _blocks(ref_create_parser(uri, part, nparts, threaded=False))
        _same_blocks(got, want)
    local = tmp_path / "whole"
    local.write_bytes(whole)
    _same_blocks(_blocks(create_parser(str(local) + suffix, device="cpu")),
                 _blocks(create_parser(uri, device="cpu")))


def test_remote_shard_uri_raises_the_references_error(remote):
    root, put, _ = remote["s3"]
    put("x.dtsh", b"not read")
    with pytest.raises(DMLCError, match="shard reader requires local files"):
        create_parser(f"{root}/x.dtsh", device="cpu")


def test_exhausted_remote_read_raises_no_fallback(remote, monkeypatch):
    root, put, store = remote["s3"]
    put("gone.svm", _libsvm_lines(100))
    monkeypatch.setenv("DMLC_TPU_RETRY_DEADLINE_S", "0.5")
    parser = create_parser(f"{root}/gone.svm", device="cpu", threaded=False)
    configure_faults("io.read:p=1.0")
    try:
        with pytest.raises(DMLCError, match="gave up"):
            list(parser)
    finally:
        reset_faults()
        parser.close()


# ---------------------------------------------------------------------------
# the csr fit from s3://
# ---------------------------------------------------------------------------


def _criteo_like(rows, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(rows):
        ids = np.sort(rng.choice(np.arange(1, 4096), 6, replace=False))
        out.append("%d %s" % (rng.randint(0, 2), " ".join(
            "%d:%.4f" % (j, v) for j, v in zip(ids, rng.rand(6)))))
    return ("\n".join(out) + "\n").encode()


def test_csr_fit_from_s3_bit_identical_to_local(remote, tmp_path):
    root, put, _ = remote["s3"]
    data = _criteo_like(700, 3)
    cut = data.index(b"\n", len(data) // 2) + 1
    put("fit/part-0", data[:cut])
    put("fit/part-1", data[cut:])
    local = tmp_path / "fit.svm"
    local.write_bytes(data)
    fit = dict(batch_size=128, epochs=2, layout="csr", num_features=4096)
    before = retry.stats()["attempts"].get("io.read", 0)
    remote_learner = LinearLearner(device="cpu", objective="logistic")
    history = remote_learner.fit_uri(f"{root}/fit", **fit)
    local_learner = LinearLearner(device="cpu", objective="logistic")
    assert local_learner.fit_uri(str(local), **fit) == history
    got, want = (params_to_numpy(x.params)
                 for x in (remote_learner, local_learner))
    for k in ("w", "b"):
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
    # the same fit with every response cut short and one injected read
    # fault in five: retried, and the same bits
    remote["s3"][2].fail_after_bytes = 9000
    configure_faults("io.read:p=0.2:seed=3")
    try:
        faulted = LinearLearner(device="cpu", objective="logistic")
        assert faulted.fit_uri(f"{root}/fit", **fit) == history
    finally:
        reset_faults()
    for k in ("w", "b"):
        assert np.asarray(params_to_numpy(faulted.params)[k]).tobytes() == \
            np.asarray(got[k]).tobytes()
    assert retry.stats()["attempts"]["io.read"] > before


def test_integer_fit_from_s3_bit_identical_to_reference(remote):
    """Squared loss on integer data from zero params, one batch of 64
    rows and a power-of-two learning rate: every value the step computes
    is exact in f32, so the two packages agree bit for bit."""
    root, put, _ = remote["s3"]
    rng = np.random.RandomState(7)
    lines = []
    for _ in range(64):
        ids = np.sort(rng.choice(np.arange(1, 64), 4, replace=False))
        lines.append("%d %s" % (rng.randint(0, 2), " ".join(
            "%d:%d" % (j, v) for j, v in zip(ids, rng.randint(-2, 3, 4)))))
    put("int.svm", ("\n".join(lines) + "\n").encode())
    hyper = dict(objective="squared", learning_rate=0.125)
    fit = dict(batch_size=64, epochs=1, layout="csr", num_features=64)
    port = LinearLearner(device="cpu", **hyper)
    history = port.fit_uri(f"{root}/int.svm", **fit)
    ref = RefLinearLearner(None, **hyper)
    ref_history = ref.fit_uri(f"{root}/int.svm", **fit)
    assert history == [float(h) for h in ref_history]
    got = params_to_numpy(port.params)
    for k in ("w", "b"):
        assert np.asarray(got[k]).tobytes() == \
            np.asarray(ref.params[k]).tobytes(), k


def test_csr_fit_from_s3_matches_the_references_fit(remote):
    """The logistic csr fit of two part objects from ``s3://`` against
    the JAX package's ``fit_uri`` over the same objects, at the port's
    fit tolerance (another summation order on the card's kernels and
    XLA's)."""
    root, put, _ = remote["s3"]
    data = _criteo_like(700, 5)
    cut = data.index(b"\n", len(data) // 2) + 1
    put("ref/part-0", data[:cut])
    put("ref/part-1", data[cut:])
    fit = dict(batch_size=128, epochs=2, layout="csr", num_features=4096)
    port = LinearLearner(device="cpu", objective="logistic")
    history = port.fit_uri(f"{root}/ref", **fit)
    ref = RefLinearLearner(None, objective="logistic")
    ref_history = ref.fit_uri(f"{root}/ref", **fit)
    np.testing.assert_allclose(history, [float(h) for h in ref_history],
                               rtol=1e-5, atol=1e-6)
    got = params_to_numpy(port.params)
    for k in ("w", "b"):
        np.testing.assert_allclose(np.asarray(got[k]),
                                   np.asarray(ref.params[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# a remote #cachefile
# ---------------------------------------------------------------------------


class _Failing:
    """A base split whose ``next_chunk`` raises after ``n`` chunks."""

    def __init__(self, base, n):
        self._base, self._left = base, n

    def next_chunk(self):
        if self._left == 0:
            raise OSError("the source went away mid-epoch")
        self._left -= 1
        return self._base.next_chunk()

    def __getattr__(self, name):
        return getattr(self._base, name)


def _chunks(split):
    out = []
    while True:
        chunk = split.next_chunk()
        if chunk is None:
            return out
        out.append(bytes(chunk))


@pytest.mark.parametrize("scheme", ["mem", "s3"])
@pytest.mark.parametrize("cut", ["closed", "raised"])
def test_remote_cache_counts_only_after_a_whole_pass(remote, tmp_path,
                                                     scheme, cut):
    """A first epoch cut short (the split closed, or its source raising)
    leaves no cache that a later split replays: the next split reads
    every chunk from the source again, and only then is the cache
    replayed."""
    from dmlc_tpu_torch.io.input_split import CachedInputSplit, LineSplitter

    fs.MemoryFileSystem.reset()
    src = tmp_path / "src.svm"
    src.write_bytes(_libsvm_lines(3000))
    cache = ("mem://cache/c.bin" if scheme == "mem"
             else f"{remote['s3'][0]}/cache/c.bin")

    def source():
        base = LineSplitter(str(src))
        base.reset_partition(0, 1)
        base.hint_chunk_size(512)  # ~90 chunks, beyond the prefetch
        return base

    def split(base=None):
        return CachedInputSplit(base or source(), cache)

    want = _chunks(source())
    assert len(want) > 3 * CachedInputSplit.PREFETCH
    first = split(_Failing(source(), 3) if cut == "raised" else None)
    if cut == "raised":
        with pytest.raises(OSError, match="mid-epoch"):
            _chunks(first)
    else:
        assert first.next_chunk() is not None
        assert first.next_chunk() is not None
    first.close()
    assert not fs.exists(cache + ".complete")
    again = split()
    assert _chunks(again) == want
    again.close()
    assert fs.exists(cache + ".complete")
    # replayed from the cache: the base's own chunks are never read
    replay = split(_Failing(source(), 0))
    assert _chunks(replay) == want
    replay.close()
    fs.MemoryFileSystem.reset()


# ---------------------------------------------------------------------------
# snapshots and checkpoints
# ---------------------------------------------------------------------------


def _state(seed):
    rng = np.random.RandomState(seed)
    return {"model": {"w": rng.randn(33).astype(np.float32),
                      "b": np.float32(rng.randn())},
            "epoch": seed, "history": [0.5, 0.25]}


def _same_state(got, want):
    assert got["epoch"] == want["epoch"] and \
        list(got["history"]) == list(want["history"])
    for k in ("w", "b"):
        assert np.asarray(got["model"][k]).tobytes() == \
            np.asarray(want["model"][k]).tobytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_job_snapshot_on_s3_restores_in_the_other_package(remote, tmp_path,
                                                          writer):
    root, _, store = remote["s3"]
    uri = f"{root}/snap-{writer}"
    make_w, make_r = ((JobSnapshot, RefJobSnapshot) if writer == "port"
                      else (RefJobSnapshot, JobSnapshot))
    snap = make_w(uri)
    for seed in (1, 2):
        assert snap.commit(_state(seed), meta={"epoch": seed}) == seed
    version, state, meta = make_r(uri).restore()
    assert version == 2 and meta == {"epoch": 2}
    _same_state(state, _state(2))
    # the same commits to a local directory give the same bytes
    local = JobSnapshot(str(tmp_path / "local"))
    for seed in (1, 2):
        local.commit(_state(seed), meta={"epoch": seed})
    prefix = f"snap-{writer}/"
    for name in ("snap_v2.manifest", "snap_v2.rank0", "LATEST"):
        assert store.objects[("bkt", prefix + name)] == \
            (tmp_path / "local" / name).read_bytes(), name


def test_linear_fit_snapshot_on_s3_resumes_bit_identical(remote):
    root, put, _ = remote["s3"]
    data = _criteo_like(600, 5)
    put("snapfit.svm", data)
    fit = dict(batch_size=128, layout="csr", num_features=4096)
    whole = LinearLearner(device="cpu", objective="logistic")
    history = whole.fit_uri(f"{root}/snapfit.svm", epochs=3, **fit)
    first = LinearLearner(device="cpu", objective="logistic")
    first.fit_uri(f"{root}/snapfit.svm", epochs=1,
                  snapshot_uri=f"{root}/linsnap", **fit)
    resumed = LinearLearner(device="cpu", objective="logistic")
    try:
        got = resumed.fit_uri(f"{root}/snapfit.svm", epochs=3,
                              snapshot_uri=f"{root}/linsnap", resume=True,
                              **fit)
    finally:
        preempt.uninstall()
    assert got == history
    for k in ("w", "b"):
        assert np.asarray(params_to_numpy(resumed.params)[k]).tobytes() == \
            np.asarray(params_to_numpy(whole.params)[k]).tobytes()


def test_learner_save_to_s3_equals_local_save(remote, tmp_path):
    root, _, store = remote["s3"]
    learner = LinearLearner(device="cpu", objective="logistic",
                            num_features=9)
    learner.params = {"w": torch.arange(9.0) / 8, "b": torch.tensor(0.5)}
    learner.save(f"{root}/model.bin")
    learner.save(str(tmp_path / "model.bin"))
    assert store.objects[("bkt", "model.bin")] == \
        (tmp_path / "model.bin").read_bytes()
    back = LinearLearner(device="cpu")
    back.load(f"{root}/model.bin")
    assert np.array_equal(params_to_numpy(back.params)["w"],
                          np.arange(9.0, dtype=np.float32) / 8)
    ref = RefLinearLearner(None)
    ref.load(f"{root}/model.bin")
    assert np.asarray(ref.params["w"]).tobytes() == \
        params_to_numpy(back.params)["w"].tobytes()


def test_checkpoint_manager_over_mem():
    fs.MemoryFileSystem.reset()
    mgr = CheckpointManager("mem://ckpt/run", keep=2)
    for v in range(1, 5):
        assert mgr.checkpoint({"step": v, "w": np.full(3, v, np.float32)}) \
            == v
    version, state = CheckpointManager("mem://ckpt/run").load_checkpoint()
    assert version == 4 and state["step"] == 4
    assert np.array_equal(state["w"], np.full(3, 4, np.float32))
    # the prune kept the newest two
    assert fs.list_dir("mem://ckpt/run") == ["LATEST", "ckpt_v3.bin",
                                             "ckpt_v4.bin"]
    fs.MemoryFileSystem.reset()

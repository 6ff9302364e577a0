"""The native route of ``create_parser`` (``NativePipelineParser``, the
native ``#cachefile`` cache, the remote push route) and its batch staging,
against the JAX package's on its own native route (its library loaded,
``DMLC_TPU_NATIVE`` unset): the same C++ on the same bytes, so blocks and
batches are equal bit for bit (``tobytes``) — four formats, parts of 3 and
their union, shuffled epochs, ``before_first``, ``#cachefile`` cold, warm
and rebuilt, ``mem://`` with one and with several connections,
``read_batch_dense`` / ``coo`` / ``coo_sharded``, a native batch feed and a
close in mid-stream. The route rules are pinned too: what takes the native
route and what keeps the Python stack."""

import os
import threading
import time

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.data.parsers import NativePipelineParser as RefNative
from dmlc_tpu.data.rowrec import write_recordio_rows as ref_write_rows
from dmlc_tpu.io import filesystem as ref_fs
from dmlc_tpu_torch import native
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.data.parsers import (LibSVMParser, NativePipelineParser,
                                         _mix_epoch_seed)
from dmlc_tpu_torch.data.pipeline import PipelinedParser
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.io import filesystem as fs
from dmlc_tpu_torch.obs import audit
from dmlc_tpu_torch.utils.logging import DMLCError

FIELDS = ("offset", "label", "index", "value", "weight", "qid", "field")


@pytest.fixture(autouse=True)
def _native_routes(monkeypatch):
    """Both packages on their native routes, no audit armed."""
    for name in ("DMLC_TPU_NATIVE", "DMLC_TPU_PARSE_BACKEND",
                 "DMLC_TPU_PARSE_PROCS", "DMLC_TPU_AUDIT",
                 "DMLC_TPU_READAHEAD_CONNS", "DMLC_TPU_READAHEAD_MB"):
        # the last two are the JAX package's; the port has none
        monkeypatch.delenv(name, raising=False)
    audit.reset_auditor()
    yield
    audit.reset_auditor()


def _write_libsvm(path, rows, seed, nf=5000, weights=False):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        ids = np.sort(rng.choice(np.arange(1, nf), rng.randint(1, 12),
                                 replace=False))
        head = "%d" % (i % 2)
        if weights:
            head += ":%.3f" % (0.5 + rng.rand())
        lines.append(head + " " + " ".join(
            "%d:%s" % (j, rng.choice(["1", "%.6f" % rng.randn(),
                                      "%.4e" % rng.rand()])) for j in ids))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _write_libfm(path, rows, seed):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        n = rng.randint(1, 8)
        lines.append("%d %s" % (i % 2, " ".join(
            "%d:%d:%.5f" % (rng.randint(0, 9), rng.randint(0, 3000),
                            rng.rand()) for _ in range(n))))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _write_csv(path, rows, seed):
    rng = np.random.RandomState(seed)
    lines = [",".join("%.5f" % v for v in rng.randn(6)) for _ in range(rows)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _write_recordio(tmp_path, rows, seed):
    """Row groups written by the JAX package from its own parse."""
    src = _write_libsvm(tmp_path / "rec_src.svm", rows, seed, weights=True)
    out = str(tmp_path / "rows.rec")
    parser = ref_create_parser(src, threaded=False)
    try:
        ref_write_rows(out, list(parser), rows_per_group=97)
    finally:
        parser.close()
    return out


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native")
    return {
        "libsvm": _write_libsvm(tmp / "a.svm", 3000, 1, weights=True),
        "libfm": _write_libfm(tmp / "a.libfm", 2000, 2) + "?format=libfm",
        "csv": _write_csv(tmp / "a.csv", 1500, 3) + "?format=csv"
        "&label_column=0",
        "recordio": _write_recordio(tmp, 2500, 4) + "?format=recordio",
    }


def _path(uri):
    return uri.split("?")[0]


def _blocks(parser):
    out = []
    for block in parser:
        out.append({k: getattr(block, k) for k in FIELDS})
    return out


def _same_blocks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in FIELDS:
            a, b = g[key], w[key]
            assert (a is None) == (b is None), key
            if a is not None:
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
                assert a.tobytes() == b.tobytes(), key


def _both(uri, part=0, nparts=1, nthread=2):
    port = create_parser(uri, part, nparts, nthread=nthread, device="cpu")
    ref = ref_create_parser(uri, part, nparts, nthread=nthread)
    assert isinstance(port, NativePipelineParser), type(port)
    assert isinstance(ref, RefNative), type(ref)
    return port, ref


def _rows(blocks, key="label"):
    return np.concatenate([np.asarray(b[key]) for b in blocks]) \
        if blocks else np.empty(0)


@pytest.mark.parametrize("fmt", ["libsvm", "libfm", "csv", "recordio"])
def test_blocks_parts_and_union_equal_the_reference(datasets, fmt):
    uri = datasets[fmt]
    port, ref = _both(uri)
    try:
        whole = _blocks(port)
        _same_blocks(whole, _blocks(ref))
        # before_first repeats the epoch
        port.before_first()
        ref.before_first()
        _same_blocks(_blocks(port), whole)
        _same_blocks(_blocks(ref), whole)
        assert port.bytes_read == ref.bytes_read > 0
        stats = port.stats()
        assert set(stats) == set(native.STATS_KEYS)
        assert stats["chunks"] > 0
    finally:
        port.close()
        ref.close()
    parts = []
    for part in range(3):
        port, ref = _both(uri, part, 3)
        try:
            got = _blocks(port)
            _same_blocks(got, _blocks(ref))
            parts.extend(got)
        finally:
            port.close()
            ref.close()
    # every row exactly once, in order
    for key in ("label", "value"):
        if whole[0][key] is not None:
            assert _rows(parts, key).tobytes() == _rows(whole, key).tobytes()


def test_shuffled_epochs_equal_the_reference(tmp_path):
    """1 MB chunks visited in a seeded order, a new order each epoch; a
    fresh parser over the same uri repeats epoch 0."""
    path = _write_libsvm(tmp_path / "big.svm", 45000, 9)
    assert os.path.getsize(path) > (3 << 20)
    uri = path + "?shuffle_chunks=7"
    port, ref = _both(uri)
    plain = create_parser(path, device="cpu")
    try:
        epochs = []
        for epoch in range(3):
            if epoch:
                port.before_first()
                ref.before_first()
            got = _blocks(port)
            _same_blocks(got, _blocks(ref))
            epochs.append(_rows(got).tobytes())
        ordered = _rows(_blocks(plain))
        assert epochs[0] != epochs[1]
        # a permutation of whole chunks: the same rows
        assert np.sort(np.frombuffer(epochs[0], np.float32)).tobytes() \
            == np.sort(ordered).tobytes()
        again = create_parser(uri, device="cpu")
        try:
            assert _rows(_blocks(again)).tobytes() == epochs[0]
        finally:
            again.close()
    finally:
        port.close()
        ref.close()
        plain.close()
    assert _mix_epoch_seed(7, 1) != _mix_epoch_seed(7, 0)


def test_cachefile_cold_warm_and_rebuilt(tmp_path):
    path = _write_libsvm(tmp_path / "c.svm", 2000, 5)
    port_uri = path + "#" + str(tmp_path / "port.cache")
    ref_uri = path + "#" + str(tmp_path / "ref.cache")
    whole = create_parser(path, device="cpu")
    want = _blocks(whole)
    whole.close()
    for attempt in ("cold", "warm"):
        port = create_parser(port_uri, device="cpu")
        ref = ref_create_parser(ref_uri)
        try:
            assert isinstance(port, NativePipelineParser)
            got = _blocks(port)
            _same_blocks(got, _blocks(ref))
            # the cached epoch holds the source's rows
            for key in ("label", "value", "index"):
                assert _rows(got, key).tobytes() == _rows(want, key).tobytes()
        finally:
            port.close()
            ref.close()
        cache = str(tmp_path / "port.cache.rowrec")
        assert os.path.exists(cache) and os.path.exists(cache + ".meta")
        with open(cache, "rb") as a, \
                open(str(tmp_path / "ref.cache.rowrec"), "rb") as b:
            assert a.read() == b.read(), attempt
    stamp = os.stat(cache).st_mtime_ns
    # a changed source rebuilds the cache
    with open(path, "a") as fh:
        fh.write("1 3:1.5 9:2\n")
    port = create_parser(port_uri, device="cpu")
    try:
        got = _blocks(port)
    finally:
        port.close()
    assert os.stat(cache).st_mtime_ns != stamp
    assert sum(len(b["label"]) for b in got) == 2001
    assert np.asarray(got[-1]["label"])[-1] == 1.0


def test_remote_push_route_over_mem(datasets, monkeypatch):
    """A ``mem://`` dataset: the readahead reader pushes the partition's
    bytes into the native pipeline, fetched over one connection and over
    several."""
    from dmlc_tpu_torch.io import readahead

    fs.MemoryFileSystem.reset()
    ref_fs.MemoryFileSystem.reset()
    for fmt in ("libsvm", "libfm"):
        data = open(_path(datasets[fmt]), "rb").read()
        fs.MemoryFileSystem.put("data/a." + fmt, data)
        ref_fs.MemoryFileSystem.put("data/a." + fmt, data)
    # several 64 KB ranges a part on the port's side; the JAX package
    # reads its range size (at least 1 MB) from the environment. Both
    # files are smaller than a push chunk, so the blocks do not depend on
    # the range size
    monkeypatch.setattr(readahead, "DEFAULT_RANGE_BYTES", 64 << 10)
    monkeypatch.setenv("DMLC_TPU_READAHEAD_MB", "1")
    try:
        for conns in (1, 3):
            monkeypatch.setattr(readahead, "DEFAULT_CONNECTIONS", conns)
            monkeypatch.setenv("DMLC_TPU_READAHEAD_CONNS", str(conns))
            for fmt in ("libsvm", "libfm"):
                uri = "mem://data/a.%s?format=%s" % (fmt, fmt)
                for part, nparts in ((0, 1), (1, 3)):
                    port, ref = _both(uri, part, nparts)
                    try:
                        assert port._remote_fs is not None
                        assert port._reader._connections == conns
                        if nparts == 1:
                            assert len(port._reader.ranges()) > 1
                        _same_blocks(_blocks(port), _blocks(ref))
                    finally:
                        port.close()
                        ref.close()
                # the pushed stream parses to the local file's rows
                local = create_parser(datasets[fmt], device="cpu")
                remote = create_parser(uri, device="cpu")
                try:
                    a, b = _blocks(remote), _blocks(local)
                    for key in ("label", "index", "value"):
                        assert _rows(a, key).tobytes() == \
                            _rows(b, key).tobytes()
                finally:
                    local.close()
                    remote.close()
    finally:
        fs.MemoryFileSystem.reset()
        ref_fs.MemoryFileSystem.reset()


def test_remote_push_route_over_s3_reads_into_the_pipeline(datasets,
                                                           monkeypatch):
    """An ``s3://`` dataset (the repo's fake server): the ranges, fetched
    over one connection and over two, are pushed into the pipeline and
    give the JAX package's native blocks over the same server (which, at
    one connection, reads each range into its pipeline's buffer)."""
    from dmlc_tpu.io.object_store import S3FileSystem as RefS3
    from dmlc_tpu_torch.io import readahead
    from dmlc_tpu_torch.io.object_store import S3FileSystem
    from fake_object_store import serve

    server, store, base = serve()
    try:
        monkeypatch.setenv("S3_ENDPOINT", base)
        monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
        monkeypatch.setattr(readahead, "DEFAULT_RANGE_BYTES", 64 << 10)
        monkeypatch.setenv("DMLC_TPU_READAHEAD_MB", "1")
        for name in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
                     "S3_ACCESS_KEY", "S3_SECRET_KEY"):
            monkeypatch.delenv(name, raising=False)
        fs.register_filesystem("s3://", lambda uri: S3FileSystem())
        ref_fs.register_filesystem("s3://", lambda uri: RefS3())
        store.objects[("bkt", "a.svm")] = open(datasets["libsvm"],
                                               "rb").read()
        for conns in (1, 2):
            monkeypatch.setattr(readahead, "DEFAULT_CONNECTIONS", conns)
            monkeypatch.setenv("DMLC_TPU_READAHEAD_CONNS", str(conns))
            port, ref = _both("s3://bkt/a.svm", 1, 2)
            try:
                assert port._reader._connections == conns
                assert len(port._reader.ranges()) > 1
                _same_blocks(_blocks(port), _blocks(ref))
            finally:
                port.close()
                ref.close()
    finally:
        server.shutdown()
        server.server_close()
        fs.register_filesystem("s3://", lambda uri: S3FileSystem())
        ref_fs.register_filesystem("s3://", lambda uri: RefS3())


def test_feed_into_tells_a_refused_push_from_a_failed_fetch(datasets):
    """``feed_into`` raises ``PushRejected`` when the pipeline already
    failed, and a fetch's own error as it is."""
    from dmlc_tpu_torch.io.readahead import PushRejected, RemotePartitionReader
    from dmlc_tpu_torch.resilience import InjectedFault
    from dmlc_tpu_torch.resilience.faults import configure, reset

    fs.MemoryFileSystem.reset()
    data = open(_path(datasets["libsvm"]), "rb").read()
    fs.MemoryFileSystem.put("data/f.svm", data)
    uri = fs.URI.parse("mem://data/f.svm")
    files = [(uri, len(data))]
    backend = fs.get_filesystem(uri)
    try:
        pipe = native.IngestPipeline(None, None, native.INGEST_LIBSVM, 0, 1,
                                     push=True)
        try:
            pipe.push_abort()
            with pytest.raises(PushRejected):
                RemotePartitionReader(backend, files, 0, 1,
                                      range_bytes=64 << 10,
                                      connections=2).feed_into(pipe)
        finally:
            pipe.close()
        pipe = native.IngestPipeline(None, None, native.INGEST_LIBSVM, 0, 1,
                                     push=True)
        configure("readahead.fetch:nth=1")
        try:
            with pytest.raises(InjectedFault, match="readahead.fetch"):
                RemotePartitionReader(backend, files, 0, 1,
                                      range_bytes=64 << 10,
                                      connections=2).feed_into(pipe)
        finally:
            reset()
            pipe.close()
    finally:
        fs.MemoryFileSystem.reset()


def test_drive_push_equals_the_local_reader(datasets):
    data = open(datasets["libsvm"], "rb").read()
    pipe = native.IngestPipeline(None, None, native.INGEST_LIBSVM, 0, 1,
                                 push=True)
    out = []

    def fetch(offset, view):
        take = min(len(view), len(data) - offset)
        view[:take] = data[offset:offset + take]
        return take

    try:
        worker = threading.Thread(
            target=lambda: pipe.drive_push(fetch, total=len(data),
                                           fetch_bytes=1 << 16))
        worker.start()
        while True:
            block = pipe.next_block()
            if block is None:
                break
            out.append(block["labels"].copy())
        worker.join()
    finally:
        pipe.close()
    local = create_parser(datasets["libsvm"], device="cpu")
    try:
        assert np.concatenate(out).tobytes() == _rows(_blocks(local)).tobytes()
    finally:
        local.close()


def test_drive_push_raises_the_fetch_error():
    pipe = native.IngestPipeline(None, None, native.INGEST_LIBSVM, 0, 1,
                                 push=True)
    try:
        def fetch(offset, view):
            raise OSError("fetch failed")

        with pytest.raises(OSError, match="fetch failed"):
            pipe.drive_push(fetch)
        with pytest.raises(DMLCError):
            pipe.next_block()
    finally:
        pipe.close()


@pytest.mark.parametrize("fmt", ["libsvm", "libfm", "recordio"])
def test_batch_staging_equals_the_reference(datasets, fmt):
    uri = datasets[fmt]
    nf = 5000 if fmt != "libfm" else 3000
    for kind in ("dense", "coo", "coo_sharded"):
        port, ref = _both(uri)
        try:
            assert port.supports_batch_fetch and ref.supports_batch_fetch
            nbatch = 0
            while True:
                if kind == "dense":
                    got = port.read_batch_dense(256, nf)
                    want = ref.read_batch_dense(256, nf)
                    pairs = list(zip(got[:3], want[:3])) if got else []
                    if got:
                        assert got[3] == want[3]
                elif kind == "coo":
                    got = port.read_batch_coo(256)
                    want = ref.read_batch_coo(256)
                    pairs = [(getattr(got, k), getattr(want, k)) for k in
                             ("labels", "weights", "indices", "values",
                              "offsets")] if got else []
                    if got:
                        assert (got.num_rows, got.num_nonzero) == (
                            want.num_rows, want.num_nonzero)
                else:
                    got = port.read_batch_coo_sharded(256, 4)
                    want = ref.read_batch_coo_sharded(256, 4)
                    pairs = [(getattr(got, k), getattr(want, k)) for k in
                             ("labels", "weights", "indices", "values",
                              "row_ids", "offsets")] if got else []
                    if got:
                        assert got.nnz_bucket == want.nnz_bucket
                assert (got is None) == (want is None)
                if got is None:
                    break
                for a, b in pairs:
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
                nbatch += 1
            assert nbatch >= 7
        finally:
            port.close()
            ref.close()


def test_fetch_writes_into_the_callers_arrays(datasets):
    port = create_parser(datasets["libsvm"], device="cpu")
    try:
        x = np.full((64, 5000), 7.0, dtype=np.float32)
        labels = np.full(64, 7.0, dtype=np.float32)
        weights = np.empty(64, dtype=np.float32)
        assert port.stage_batch(64) is not None
        out = port.fetch_batch_dense(64, 5000, x=x, labels=labels,
                                     weights=weights)
        assert out[0] is x and out[1] is labels and out[2] is weights
        assert out[3] == 64 and x.max() < 7.0
        with pytest.raises(DMLCError, match="C-contiguous"):
            port.stage_batch(64)
            port.fetch_batch_dense(64, 5000, x=x[:, :10], labels=labels,
                                   weights=weights)
    finally:
        port.close()


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_native_feed_equals_the_python_stack_feed(datasets, layout):
    """The feed's native staging against the Python stack's re-batch on
    the same file: the same batches (the values within the reference's
    float-scan limits, as tests/test_native.py holds them; here exactly,
    since these decimals scan the same on both routes)."""
    spec = BatchSpec(batch_size=200, layout=layout, num_features=5000,
                     drop_remainder=(layout == "dense"))
    got, want = [], []
    for parser, out in ((create_parser(datasets["libsvm"], device="cpu"),
                         got),
                        (create_parser(datasets["libsvm"], threaded=False,
                                       device="cpu"), want)):
        feed = DeviceFeed(parser, spec, device="cpu", host_prefetch=2)
        try:
            for batch in feed:
                out.append({k: (v.numpy().copy() if hasattr(v, "numpy")
                                else v) for k, v in batch.items()})
        finally:
            feed.close()
    assert len(got) == len(want) == (15 if layout == "dense" else 15)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            if key in ("values", "x", "weight"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           atol=1e-7)
            else:
                assert np.array_equal(g[key], w[key]), key


def test_native_feed_refuses_an_out_of_range_feature(tmp_path):
    """As on the Python route: a csr batch naming a feature id at or past
    num_features raises instead of indexing past w on the device."""
    path = tmp_path / "big_id.svm"
    path.write_text("1 3:1 7:2\n0 12:1\n")
    feed = DeviceFeed(create_parser(str(path), device="cpu"),
                      BatchSpec(batch_size=2, layout="csr",
                                num_features=10), device="cpu")
    try:
        assert feed._use_native_batches()
        with pytest.raises(DMLCError, match="feature id 12 out of range"):
            list(feed)
    finally:
        feed.close()


def test_close_mid_stream_returns_promptly(tmp_path):
    path = _write_libsvm(tmp_path / "m.svm", 60000, 12)
    parser = create_parser(path, nthread=2, device="cpu")
    assert parser.next_block() is not None
    t0 = time.monotonic()
    parser.close()
    assert time.monotonic() - t0 < 5.0
    parser.close()  # idempotent


def test_a_malformed_file_raises_from_the_pipeline(tmp_path):
    bad = tmp_path / "bad.svm"
    bad.write_text("1 1:2\nnot_a_label 3:4\n")
    parser = create_parser(str(bad), device="cpu")
    try:
        with pytest.raises(DMLCError, match="pipeline failed"):
            list(parser)
    finally:
        parser.close()


def test_route_rules(tmp_path, datasets, monkeypatch):
    """The call picks the route; no environment variable and no device
    does."""
    svm = datasets["libsvm"]
    cases = [
        (dict(), NativePipelineParser),
        (dict(threaded=False), LibSVMParser),
    ]
    for kwargs, kind in cases:
        parser = create_parser(svm, device="cpu", **kwargs)
        try:
            assert type(parser) is kind, (kwargs, type(parser))
        finally:
            parser.close()
    # the JAX package's knobs choose nothing here
    for name, value in (("DMLC_TPU_NATIVE", "0"),
                        ("DMLC_TPU_PARSE_BACKEND", "vector"),
                        ("DMLC_TPU_PARSE_PROCS", "2")):
        monkeypatch.setenv(name, value)
        parser = create_parser(svm, device="cpu")
        try:
            assert isinstance(parser, NativePipelineParser), name
        finally:
            parser.close()
        monkeypatch.delenv(name)
    # an armed audit keeps the Python stack
    monkeypatch.setenv("DMLC_TPU_AUDIT", "full")
    audit.reset_auditor()
    parser = create_parser(svm, device="cpu")
    try:
        assert isinstance(parser, PipelinedParser)
    finally:
        parser.close()
    monkeypatch.delenv("DMLC_TPU_AUDIT")
    audit.reset_auditor()
    # a #cachefile on another format, a remote shuffle, a shuffle over
    # several local files: the Python stack
    libfm_cache = datasets["libfm"] + "#" + str(tmp_path / "fm.cache")
    other = tmp_path / "b.svm"
    other.write_text(open(svm).read())
    fs.MemoryFileSystem.put("data/r.svm", open(svm, "rb").read())
    try:
        for uri in (libfm_cache, "mem://data/r.svm?shuffle_chunks=3",
                    svm + ";" + str(other) + "?shuffle_chunks=3"):
            parser = create_parser(uri, device="cpu")
            try:
                assert isinstance(parser, PipelinedParser), uri
            finally:
                parser.close()
    finally:
        fs.MemoryFileSystem.reset()
    # an unknown format raises as before
    with pytest.raises(DMLCError, match="unknown data format"):
        create_parser(svm + "?format=nope", device="cpu")

"""The feed's producer thread and transfer window against the JAX
package's ``DeviceFeed``: the same batches, bit for bit, at every
``host_prefetch`` / ``spec.prefetch``, the one-copy dense staging, the
fixed nnz bucket, the env names, the lifecycle (errors in order, close
joins the thread) and the exactly-once acks over a dispatcher at depth 2.

The JAX side runs its Python stack (``DMLC_TPU_PARSE_BACKEND=vector``,
``DMLC_TPU_NATIVE=0``) over an unthreaded parser."""

import threading
import time

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.data.row_block import RowBlockContainer as RefContainer
from dmlc_tpu.device import BatchSpec as RefBatchSpec
from dmlc_tpu.device import DeviceFeed as RefDeviceFeed
from dmlc_tpu.device import csr as ref_csr
from dmlc_tpu_torch import resilience
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed, csr
from dmlc_tpu_torch.device import feed as feed_mod
from dmlc_tpu_torch.models import LinearLearner, params_to_numpy

NUM_FEATURES = {"dense": 17, "csr": 4097}
MODES = [(0, 1), (0, 2), (2, 1), (2, 2)]  # (host_prefetch, prefetch)


@pytest.fixture(autouse=True)
def _python_stack(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")
    monkeypatch.delenv("DMLC_TPU_PREFETCH", raising=False)
    monkeypatch.delenv("DMLC_TPU_HOST_PREFETCH", raising=False)


def _write(path, rows, num_features, seed):
    """Integer values; some rows repeat an id and some name ids at or
    past ``num_features`` (the dense staging drops those)."""
    rng = np.random.RandomState(seed)
    lines = []
    for r in range(rows):
        n = rng.randint(1, 9)
        ids = list(np.sort(rng.choice(np.arange(1, num_features), n,
                                      replace=False)))
        feats = ["%d:%d" % (j, rng.randint(-3, 4)) for j in ids]
        if r % 7 == 3:
            feats.append("%d:%d" % (ids[-1], rng.randint(-3, 4)))
        lines.append("%d %s" % (rng.randint(0, 2), " ".join(feats)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _dense_file(tmp_path, rows=333):
    """A dense file with ids past num_features in some rows."""
    rng = np.random.RandomState(9)
    nf = NUM_FEATURES["dense"]
    lines = []
    for r in range(rows):
        ids = np.sort(rng.choice(np.arange(0, nf + 4), 6, replace=False))
        lines.append("%d %s" % (rng.randint(0, 2), " ".join(
            "%d:%d" % (j, rng.randint(-3, 4)) for j in ids)))
    path = tmp_path / "dense.svm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _file(tmp_path, layout):
    if layout == "dense":
        return _dense_file(tmp_path)
    return _write(tmp_path / "csr.svm", 333, NUM_FEATURES["csr"], 3)


def _spec(layout, **kw):
    return dict(batch_size=32, layout=layout,
                num_features=NUM_FEATURES[layout], **kw)


def _numpy_batch(batch):
    return {k: (np.array(v) if not isinstance(v, int) else v)
            for k, v in batch.items()}


def _port_batches(path, layout, host_prefetch, prefetch, epochs=2):
    feed = DeviceFeed(create_parser(path, device="cpu"),
                      BatchSpec(**_spec(layout, prefetch=prefetch)),
                      device="cpu", host_prefetch=host_prefetch)
    out = []
    try:
        for e in range(epochs):
            if e:
                feed.before_first()
            out.append([{k: (v.numpy().copy() if torch.is_tensor(v) else v)
                         for k, v in b.items()} for b in feed])
    finally:
        feed.close()
    return out


def _ref_batches(path, layout, host_prefetch, epochs=2):
    feed = RefDeviceFeed(ref_create_parser(path, threaded=False),
                         RefBatchSpec(**_spec(layout)),
                         host_prefetch=host_prefetch)
    out = []
    try:
        for e in range(epochs):
            if e:
                feed.before_first()
            # copied at once: the reference may reuse its host staging
            out.append([_numpy_batch(b) for b in feed])
    finally:
        feed.close()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for gb, wb in zip(ge, we):
            assert set(gb) == set(wb)
            for k in wb:
                if isinstance(wb[k], int):
                    assert gb[k] == wb[k], k
                else:
                    assert gb[k].dtype == wb[k].dtype, k
                    assert np.array_equal(gb[k], wb[k]), k


@pytest.mark.parametrize("host_prefetch,prefetch", MODES)
@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_batches_equal_the_references_at_every_depth(
        tmp_path, layout, host_prefetch, prefetch):
    """Two epochs of batches, bit for bit, against the reference's feed
    at its defaults (its producer thread) and at ``host_prefetch=0``;
    the last batch is short and padded."""
    path = _file(tmp_path, layout)
    got = _port_batches(path, layout, host_prefetch, prefetch)
    assert got[0][-1]["num_rows"] == 333 % 32
    _same(got, _ref_batches(path, layout, None))
    _same(got, _ref_batches(path, layout, 0))


class _RefFeedOnTorch:
    """The reference's feed under the port's learner: its batches as
    CPU tensors, so one learner steps both packages' batches."""

    def __init__(self, feed, spec):
        self._feed, self.spec = feed, spec
        self.device = torch.device("cpu")

    def __iter__(self):
        for b in self._feed:
            yield {k: (v if isinstance(v, int)
                       else torch.from_numpy(np.array(v)))
                   for k, v in _numpy_batch(b).items()}

    def before_first(self):
        self._feed.before_first()

    def stats(self):
        return {}


def _fit(feed, layout):
    learner = LinearLearner(device="cpu", objective="logistic",
                            learning_rate=0.5, l2=0.01, momentum=0.5)
    history = learner.fit_feed(feed, epochs=2)
    return history, params_to_numpy(learner.params)


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_fits_over_every_depth_are_bit_identical(tmp_path, layout):
    """The port's learner over the port's feed at each depth and window,
    and over the reference's feed at its defaults and at
    ``host_prefetch=0``: the same history and params, bit for bit."""
    path = _file(tmp_path, layout)
    results = []
    for host_prefetch, prefetch in MODES:
        feed = DeviceFeed(create_parser(path, device="cpu"),
                          BatchSpec(**_spec(layout, prefetch=prefetch)),
                          device="cpu", host_prefetch=host_prefetch)
        try:
            results.append(_fit(feed, layout))
        finally:
            feed.close()
    for host_prefetch in (None, 0):
        ref = RefDeviceFeed(ref_create_parser(path, threaded=False),
                            RefBatchSpec(**_spec(layout)),
                            host_prefetch=host_prefetch)
        try:
            results.append(_fit(_RefFeedOnTorch(ref, ref.spec), layout))
        finally:
            ref.close()
    history, params = results[0]
    assert len(history) == 2 and np.isfinite(history).all()
    for h, p in results[1:]:
        assert h == history
        for k in ("w", "b"):
            assert np.array_equal(p[k], params[k]), k


def test_fit_uri_at_the_default_depth_is_the_inline_fit(tmp_path,
                                                        monkeypatch):
    """``fit_uri`` passes no depth: the default (2 on this host) and
    ``DMLC_TPU_HOST_PREFETCH=0`` give the same bits."""
    path = _file(tmp_path, "csr")
    fits = []
    for env in ("-1", "0"):
        monkeypatch.setenv("DMLC_TPU_HOST_PREFETCH", env)
        learner = LinearLearner(device="cpu", learning_rate=0.5)
        h = learner.fit_uri(path, batch_size=32, epochs=2, layout="csr",
                            num_features=NUM_FEATURES["csr"])
        fits.append((h, params_to_numpy(learner.params)))
    assert fits[0][0] == fits[1][0]
    assert np.array_equal(fits[0][1]["w"], fits[1][1]["w"])


def _container(parts, index_dtype=None):
    """A port and a reference container over the same parts."""
    port, ref = RowBlockContainer(), RefContainer()
    for label, counts, index, value, weight in parts:
        for c in (port, ref):
            c.push_arrays(label, counts, index, value=value, weight=weight)
    return port, ref


def _parts(seed, num_features):
    rng = np.random.RandomState(seed)
    out = []
    for k in range(4):
        n = rng.randint(0, 6)
        counts = rng.randint(0, 5, n).astype(np.int64)
        index = rng.randint(0, num_features + 3, int(counts.sum()))
        index = index.astype(np.uint32)
        if k == 1 and len(index) > 1 and counts[0] > 1:
            index[1] = index[0]  # a repeated id in one row
        value = (None if k == 2 else
                 rng.randint(-4, 5, len(index)).astype(np.float32))
        weight = (None if k % 2 else
                  rng.randint(1, 4, n).astype(np.float32))
        out.append((rng.randint(0, 2, n).astype(np.float32), counts, index,
                    value, weight))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_emit_dense_into_is_to_block_then_block_to_dense(seed):
    """Repeated ids (the last value wins), ids past ``num_features``
    (dropped), parts without values or weights: the one-copy staging
    gives ``to_block`` + ``block_to_dense``'s bits, and the reference's
    ``emit_dense_into``'s."""
    nf, bs = 6, 32
    port, ref = _container(_parts(seed, nf))
    x = np.zeros((bs, nf), np.float32)
    labels = np.full(bs, 7.0, np.float32)
    weights = np.full(bs, 7.0, np.float32)
    n = port.emit_dense_into(x, labels, weights)
    assert n == len(port)
    labels[n:] = 0.0
    weights[n:] = 0.0
    want = csr.block_to_dense(port.to_block(), bs, nf)
    for got, w in zip((x, labels, weights), want):
        assert np.array_equal(got, w)
    rx = np.zeros((bs, nf), np.float32)
    rl, rw = np.zeros(bs, np.float32), np.zeros(bs, np.float32)
    assert ref.emit_dense_into(rx, rl, rw) == n
    assert np.array_equal(x, rx)
    assert np.array_equal(labels, rl) and np.array_equal(weights, rw)


def _block(nnz_rows):
    offset = np.concatenate([[0], np.cumsum(nnz_rows)]).astype(np.int64)
    nnz = int(offset[-1])
    return RowBlock(offset=offset, label=np.ones(len(nnz_rows), np.float32),
                    index=np.arange(nnz, dtype=np.uint32) % 50,
                    value=np.arange(nnz, dtype=np.float32))


def test_a_fixed_nnz_bucket_pads_to_its_size():
    block = _block([3, 5, 2])
    for fn in ("pad", "emit"):
        if fn == "pad":
            got = csr.pad_to_bucket(block, 8, nnz_bucket=1000)
        else:
            cont = RowBlockContainer()
            cont.push_block(block)
            got = csr.emit_to_bucket(cont, 8, nnz_bucket=1000)
        want = ref_csr.pad_to_bucket(block, 8, nnz_bucket=1000)
        assert got.nnz_bucket == want.nnz_bucket == 1000
        assert got.batch_size == want.batch_size == 8
        for k in ("labels", "weights", "indices", "values", "offsets"):
            assert np.array_equal(getattr(got, k), getattr(want, k)), k
    with pytest.raises(Exception, match="nnz exceeds bucket"):
        csr.pad_to_bucket(block, 8, nnz_bucket=9)
    cont = RowBlockContainer()
    cont.push_block(block)
    with pytest.raises(Exception, match="nnz exceeds bucket"):
        csr.emit_to_bucket(cont, 8, nnz_bucket=9)


def test_the_feed_pads_to_spec_nnz_bucket(tmp_path):
    path = _file(tmp_path, "csr")
    feed = DeviceFeed(create_parser(path, device="cpu"),
                      BatchSpec(**_spec("csr", nnz_bucket=512)),
                      device="cpu")
    try:
        sizes = {int(b["indices"].shape[0]) for b in feed}
    finally:
        feed.close()
    assert sizes == {512}
    feed = DeviceFeed(create_parser(path, device="cpu"),
                      BatchSpec(**_spec("csr", nnz_bucket=8)),
                      device="cpu", host_prefetch=2)
    try:
        with pytest.raises(Exception, match="nnz exceeds bucket"):
            list(feed)
    finally:
        feed.close()


def test_env_names_and_the_auto_depth(tmp_path, monkeypatch):
    """As the reference's knobs: an explicit value wins, else
    ``DMLC_TPU_PREFETCH`` / ``DMLC_TPU_HOST_PREFETCH``; -1 or unset is
    auto (0 on one usable core, else 2)."""
    path = _file(tmp_path, "csr")
    monkeypatch.setenv("DMLC_TPU_PREFETCH", "4")
    monkeypatch.setenv("DMLC_TPU_HOST_PREFETCH", "0")
    assert feed_mod.default_prefetch() == 4
    assert feed_mod.default_prefetch(2) == 2
    assert feed_mod.default_prefetch(0) == 1
    assert feed_mod.default_host_prefetch() == 0
    feed = DeviceFeed(create_parser(path, device="cpu"),
                      BatchSpec(**_spec("csr")), device="cpu")
    assert feed._prefetch == 4 and feed._sync_host
    assert sum(1 for _ in feed) > 0
    feed.close()
    monkeypatch.setenv("DMLC_TPU_HOST_PREFETCH", "-1")
    assert feed_mod.default_host_prefetch() is None
    assert feed_mod.default_host_prefetch(3) == 3
    monkeypatch.delenv("DMLC_TPU_HOST_PREFETCH")
    assert feed_mod.default_host_prefetch() is None
    for cpus, depth in ((1, 0), (8, 2)):
        monkeypatch.setattr(feed_mod, "_available_cpus", lambda c=cpus: c)
        feed = DeviceFeed(create_parser(path, device="cpu"),
                          BatchSpec(**_spec("csr", prefetch=3)),
                          device="cpu")
        assert feed.host_prefetch == depth and feed._prefetch == 3
        assert feed._sync_host == (depth == 0)
        feed.close()


def _feed_threads():
    return [t for t in threading.enumerate() if t.name == "device-feed"]


class _FailingParser:
    """Blocks of 10 rows, then a parse error."""

    bytes_read = 0

    def __init__(self, blocks):
        self._blocks = blocks

    def __iter__(self):
        for k in range(self._blocks):
            yield _block([1] * 10)
        raise ValueError("bad line in chunk %d" % self._blocks)

    def before_first(self):
        pass

    def close(self):
        self.closed = True


@pytest.mark.parametrize("host_prefetch,prefetch", MODES)
def test_a_producer_error_arrives_in_order(host_prefetch, prefetch):
    parser = _FailingParser(5)
    feed = DeviceFeed(parser, BatchSpec(batch_size=20, layout="csr"),
                      device="cpu", host_prefetch=host_prefetch)
    feed._prefetch = prefetch
    got = []
    with pytest.raises(ValueError, match="bad line in chunk 5"):
        for b in feed:
            got.append(b["num_rows"])
    assert got == [20, 20]  # the 10 rows of block 4 wait for more
    feed.close()
    assert parser.closed and _feed_threads() == []


def test_the_feed_faultpoint_arrives_after_the_batches_before_it(tmp_path):
    path = _file(tmp_path, "csr")
    resilience.configure("device.feed:nth=3")
    try:
        feed = DeviceFeed(create_parser(path, device="cpu"),
                          BatchSpec(**_spec("csr", prefetch=2)),
                          device="cpu", host_prefetch=2)
        got = []
        with pytest.raises(resilience.InjectedFault):
            for b in feed:
                got.append(b["num_rows"])
        assert got == [32, 32]
        feed.close()
    finally:
        resilience.configure(None)
    assert _feed_threads() == []


def test_close_mid_epoch_joins_the_producer(tmp_path):
    path = _file(tmp_path, "csr")
    feed = DeviceFeed(create_parser(path, device="cpu"),
                      BatchSpec(**_spec("csr")), device="cpu",
                      host_prefetch=2)
    assert _feed_threads() == []  # the producer starts at iteration
    for nbatch, _ in enumerate(feed):
        if nbatch == 1:
            break
    assert len(_feed_threads()) == 1
    feed.close()
    assert _feed_threads() == []


def test_restoring_the_read_plan_before_the_first_batch(tmp_path):
    """The producer starts at the first iteration: a parser rewound
    after the feed was built (a resume restores its read plan there)
    feeds the new plan, with no stale producer thread."""
    path = _file(tmp_path, "csr")
    parser = create_parser(path, device="cpu")
    feed = DeviceFeed(parser, BatchSpec(**_spec("csr")), device="cpu",
                      host_prefetch=2)
    parser.before_first()
    try:
        first = [b["num_rows"] for b in feed]
        feed.before_first()
        second = [b["num_rows"] for b in feed]
    finally:
        feed.close()
    assert first == second and sum(first) == 333
    assert _feed_threads() == []


def _ids_file(tmp_path, rows=400):
    path = tmp_path / "ids.svm"
    with open(path, "w") as fh:
        for i in range(rows):
            fh.write(f"{i % 2} 1:{i:04d}\n")
    return str(path)


def test_a_dispatcher_epoch_at_depth_two_acks_each_chunk_once(tmp_path):
    """Every chunk acked exactly once and no requeue at depth 2, window
    2; the rows are the file's, once each."""
    from dmlc_tpu_torch.data import DataDispatcher
    from dmlc_tpu_torch.data.service import BlockService, RemoteBlockParser

    path = _ids_file(tmp_path)
    acks = []
    with DataDispatcher(path, nchunks=6) as d:
        with BlockService(dispatcher=d.address, nthread=1, device="cpu"):
            parser = RemoteBlockParser(d.address, dispatcher=True,
                                       device="cpu")
            real_ack = parser.ack
            parser.ack = lambda seq: (acks.append(seq), real_ack(seq))
            feed = DeviceFeed(parser, BatchSpec(
                batch_size=50, layout="csr", num_features=2, prefetch=2),
                device="cpu", host_prefetch=2)
            vals = []
            for b in feed:
                vals.extend(b["values"].numpy()[:b["num_nonzero"]].tolist())
            feed.close()
            assert d.join(timeout=10), d.snapshot()
            snap = d.snapshot()
    assert sorted(acks) == list(range(6))
    assert snap["chunks"]["acked"] == 6
    assert snap["requeued"] == 0 and snap["rejects"] == 0
    assert sorted(vals) == [float(i) for i in range(400)]


def test_prefetched_chunks_never_consumed_are_not_acked(tmp_path):
    """Closed after its first batch, the feed's producer has prefetched
    chunks behind it: none of them is acked, each requeues, and a second
    consumer reads them, so every row is read once."""
    from dmlc_tpu_torch.data import DataDispatcher
    from dmlc_tpu_torch.data.service import BlockService, RemoteBlockParser

    path = _ids_file(tmp_path)
    with DataDispatcher(path, nchunks=8, lease_s=0.2) as d:
        with BlockService(dispatcher=d.address, nthread=1, device="cpu"):
            parser = RemoteBlockParser(d.address, dispatcher=True,
                                       device="cpu")
            feed = DeviceFeed(parser, BatchSpec(
                batch_size=50, layout="csr", num_features=2, prefetch=2),
                device="cpu", host_prefetch=2)
            seen = []
            for nbatch, b in enumerate(feed):
                seen.extend(b["values"].numpy()[:b["num_nonzero"]].tolist())
                if nbatch == 0:
                    # let the producer run ahead of the consumer
                    deadline = time.monotonic() + 5
                    while (d.snapshot()["chunks"]["delivered"] < 3
                           and time.monotonic() < deadline):
                        time.sleep(0.02)
                    break
            feed.close()
            snap = d.snapshot()
            assert snap["chunks"]["acked"] == 0  # batch 0 never returned
            held = snap["chunks"]["delivered"]
            assert held >= 3
            deadline = time.monotonic() + 10
            while d.snapshot()["requeued"] < held:
                assert time.monotonic() < deadline, d.snapshot()
                time.sleep(0.05)
            survivor = RemoteBlockParser(d.address, dispatcher=True,
                                         device="cpu")
            rest = [float(v) for b in survivor for v in np.asarray(b.value)]
            survivor.close()
            assert d.join(timeout=10), d.snapshot()
    assert sorted(rest) == [float(i) for i in range(400)]
    assert len(seen) == 50


@pytest.mark.parametrize("host_prefetch,prefetch", [(0, 1), (0, 2), (2, 1),
                                                    (2, 2)])
def test_a_stalled_consumer_holds_depth_and_window_chunks(
        tmp_path, host_prefetch, prefetch):
    """Rows of one width split into chunks of exactly one batch: a
    consumer that stalls in its first batch holds that chunk, the
    ``prefetch`` chunks copied ahead of it and, with a producer thread,
    the ``host_prefetch`` chunks in its queue plus the one it is putting:
    exactly that many are delivered and none acked, whatever the wait."""
    from dmlc_tpu_torch.data import DataDispatcher
    from dmlc_tpu_torch.data.service import BlockService, RemoteBlockParser

    path = _ids_file(tmp_path)  # 400 rows of 9 bytes: 8 chunks of 50
    held = 1 + prefetch + (host_prefetch + 1 if host_prefetch else 0)
    with DataDispatcher(path, nchunks=8, lease_s=0.2) as d:
        with BlockService(dispatcher=d.address, nthread=1, device="cpu"):
            parser = RemoteBlockParser(d.address, dispatcher=True,
                                       device="cpu")
            feed = DeviceFeed(parser, BatchSpec(
                batch_size=50, layout="csr", num_features=2,
                prefetch=prefetch), device="cpu",
                host_prefetch=host_prefetch)
            for b in feed:
                assert b["num_rows"] == 50
                deadline = time.monotonic() + 5
                while (d.snapshot()["chunks"]["delivered"] < held
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
                time.sleep(0.3)  # a producer past its bound would show
                break
            snap = d.snapshot()
            feed.close()
    assert snap["chunks"]["acked"] == 0
    assert snap["chunks"]["delivered"] == held, snap

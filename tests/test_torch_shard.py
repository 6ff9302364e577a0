"""The port's ``.dtsh`` shards (``dmlc_tpu_torch/io/shard.py``) and bake
(``tools/bake.py``) against the JAX package's, and the slice as a whole.

- Shards baked by each package from one text file are byte-equal (libsvm,
  with weights and qids, libfm, csv; one part and two), each package
  reads the other's, the mmap and read modes agree, the torn and skewed
  files of the JAX package's ``TestCorruption`` raise, and the
  ``shard.read`` faultpoint fires.
- The shuffle's order equals the JAX package's for the same (seed, epoch,
  window), and the world-2 parts together read the world-1 order; the
  audit chains of an epoch equal the JAX package's; ``cache_token``
  equals the reference's.
- The slice: the csr ``LinearLearner.fit_uri`` over two epochs from the
  ``.rec`` and the ``.dtsh`` of one seeded file equals the port's fit
  from the text bit for bit, and the JAX package's fit from the same file
  within the tolerance of ``tests/test_torch_linear.py``; a shuffled
  shard fit snapshotted, stopped after epoch 1 and resumed equals the
  unbroken fit bit for bit.

The JAX package runs its Python stack (``DMLC_TPU_NATIVE=0``,
``DMLC_TPU_PARSE_BACKEND=vector``). Host code over bytes: equality
everywhere but the cross-package fit."""

import jax.numpy as jnp
import numpy as np
import pytest

from dmlc_tpu import resilience as ref_resilience
from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.device import BatchSpec as RefBatchSpec
from dmlc_tpu.device import DeviceFeed as RefDeviceFeed
from dmlc_tpu.io import shard as ref_shard
from dmlc_tpu.models import LinearLearner as RefLinearLearner
from dmlc_tpu.obs.audit import Auditor as RefAuditor
from dmlc_tpu.tools.bake import bake_dataset as ref_bake
from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
from dmlc_tpu_torch import resilience
from dmlc_tpu_torch.data import (RowBlockContainer, ThreadedShardParser,
                                 convert_to_recordio, create_parser)
from dmlc_tpu_torch.io import shard
from dmlc_tpu_torch.models import LinearLearner, params_to_numpy
from dmlc_tpu_torch.obs.audit import Auditor
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.resilience import InjectedFault
from dmlc_tpu_torch.tools.bake import bake_dataset, part_path
from dmlc_tpu_torch.utils import DMLCError

FIELDS = ("offset", "label", "index", "value", "weight", "qid", "field")


@pytest.fixture(autouse=True)
def python_stack(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    for name in ("DMLC_TPU_SHUFFLE", "DMLC_TPU_SHUFFLE_WINDOW",
                 "DMLC_TPU_SHARD_MMAP"):
        monkeypatch.delenv(name, raising=False)
    resilience.reset()
    ref_resilience.reset()
    yield
    resilience.reset()
    ref_resilience.reset()


def _libsvm(path, rows=600, seed=7, weights=False, qid=False, nf=60):
    """Unique labels (order-sensitive comparisons), rows of 0-8 ids,
    empty rows among them."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(rows):
            head = "%d" % i
            if weights:
                head += ":%.2f" % rng.random()
            if qid:
                head += " qid:%d" % (i // 7)
            n = int(rng.integers(0, 9))
            feats = sorted(rng.choice(nf, size=n, replace=False))
            cols = " ".join("%d:%.5f" % (j, rng.random()) for j in feats)
            fh.write(("%s %s" % (head, cols)).rstrip() + "\n")
    return str(path)


def _libfm(path, rows=400, seed=8):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(rows):
            fh.write(" ".join(["%d" % i] + [
                "%d:%d:%.3f" % (f, rng.integers(0, 90), rng.random())
                for f in range(int(rng.integers(0, 6)))]) + "\n")
    return str(path)


def _csv(path, rows=500, seed=11):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(rows):
            fh.write("%d,%s\n" % (i, ",".join("%.4f" % v
                                              for v in rng.random(6))))
    return str(path)


SOURCES = {
    "libsvm": (_libsvm, "libsvm"),
    "libsvm_weight_qid": (lambda p: _libsvm(p, weights=True, qid=True),
                          "libsvm"),
    "libfm": (_libfm, "libfm"),
    # the JAX package's bake digests the uri's files with its ?args as
    # part of the name: a plain path
    "csv": (_csv, "csv"),
}


def drain(parser):
    out = RowBlockContainer()
    try:
        for block in parser:
            out.push_block(block)
    finally:
        parser.close()
    return out.to_block()


def assert_blocks_equal(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert np.array_equal(np.asarray(g, np.float64),
                                  np.asarray(w, np.float64)), name


# ---------------------------------------------------------------------------
# bake: byte-equal files, each package reads the other's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nparts", [1, 2])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_bakes_are_byte_equal_and_cross_read(tmp_path, name, nparts):
    make, fmt = SOURCES[name]
    src = make(tmp_path / "src.txt")
    port_dst, ref_dst = str(tmp_path / "port.dtsh"), str(tmp_path / "ref.dtsh")
    kernels.reset_launch_counts()
    summary = bake_dataset(src, port_dst, data_format=fmt, nparts=nparts,
                           rows_per_window=64, device="cpu")
    ref_summary = ref_bake(src, ref_dst, data_format=fmt, nparts=nparts,
                           rows_per_window=64)
    assert kernels.tokenize_boundaries.launches == 0  # the CPU route
    assert summary["rows"] == ref_summary["rows"] > 300
    assert summary["sig"] == ref_summary["sig"]
    for k in range(nparts):
        got = open(part_path(port_dst, k, nparts), "rb").read()
        want = open(part_path(ref_dst, k, nparts), "rb").read()
        assert got == want
    text = drain(create_parser(src, data_format=fmt, device="cpu"))
    # each part's files, by regex
    port_glob = tmp_path / r"port.*\.dtsh"
    ref_glob = tmp_path / r"ref.*\.dtsh"
    # the port reads the JAX package's shards and the other way round
    got = drain(create_parser(str(ref_glob), data_format="shard",
                              device="cpu"))
    want = drain(ref_create_parser(str(port_glob), data_format="shard",
                                   threaded=False))
    assert_blocks_equal(got, text)
    assert_blocks_equal(want, text)


def test_mmap_and_read_modes_agree(tmp_path, monkeypatch):
    src = _libsvm(tmp_path / "src.svm", weights=True)
    dst = str(tmp_path / "d.dtsh")
    bake_dataset(src, dst, rows_per_window=50, device="cpu")
    modes = {}
    for use_mmap in (True, False):
        reader = shard.ShardReader(dst, use_mmap=use_mmap)
        assert (reader._mm is not None) == use_mmap
        blocks = [reader.read_window(i) for i in range(reader.num_windows)]
        modes[use_mmap] = (blocks, [bytes(reader.window_bytes(i))
                                    for i in range(reader.num_windows)])
        ref = ref_shard.ShardReader(dst, use_mmap=use_mmap)
        assert reader.num_rows == ref.num_rows == 600
        assert reader.footer_crc == ref.footer_crc
        assert reader.rows_per_window == 50 and reader.num_windows == 12
        ref.close()
        reader.close()  # the blocks' views keep the map alive
    assert modes[True][1] == modes[False][1]
    for a, b in zip(modes[True][0], modes[False][0]):
        assert_blocks_equal(a, b)
    # the env knob picks the mode
    monkeypatch.setenv("DMLC_TPU_SHARD_MMAP", "0")
    reader = shard.ShardReader(dst)
    assert reader._mm is None
    reader.close()


def test_format_resolution(tmp_path):
    src = _libsvm(tmp_path / "src.svm")
    dst = str(tmp_path / "d.dtsh")
    bake_dataset(src, dst, device="cpu")
    assert shard.is_shard_uri(dst) and shard.is_shard_uri("file://" + dst)
    assert not shard.is_shard_uri(src)
    text = drain(create_parser(src, device="cpu"))
    for uri, fmt in ((dst, "auto"), (dst + "?x=1", "auto"),
                     ("file://" + dst, "auto"), (dst, "shard"),
                     (str(tmp_path / r"d\.dtsh"), "shard")):
        parser = create_parser(uri, data_format=fmt, device="cpu")
        assert isinstance(parser, ThreadedShardParser)
        assert_blocks_equal(drain(parser), text)
    assert isinstance(create_parser(dst, threaded=False, device="cpu"),
                      shard.ShardParser)
    with pytest.raises(ValueError, match="already baked"):
        bake_dataset(dst, str(tmp_path / "e.dtsh"), data_format="shard",
                     device="cpu")


# ---------------------------------------------------------------------------
# corruption (tests/test_shard.py::TestCorruption) and the faultpoint
# ---------------------------------------------------------------------------


@pytest.fixture()
def baked(tmp_path):
    dst = str(tmp_path / "corpus.dtsh")
    bake_dataset(_libsvm(tmp_path / "corpus.svm"), dst, data_format="libsvm",
                 rows_per_window=64, device="cpu")
    return dst


def _mutate(path, tmp_path, fn):
    bad = str(tmp_path / "bad.dtsh")
    with open(path, "rb") as fh:
        buf = fh.read()
    with open(bad, "wb") as fh:
        fh.write(fn(buf))
    return bad


@pytest.mark.parametrize("name,mutate", [
    ("truncated", lambda b: b[: len(b) // 2]),
    ("torn_tail", lambda b: b[:-5]),
    ("crc_flip", lambda b: b[:-40] + bytes([b[-40] ^ 1]) + b[-39:]),
    ("bad_magic", lambda b: b"NOTSHARD" + b[8:]),
    ("empty", lambda b: b""),
    ("magic_only", lambda b: shard.MAGIC),
    ("bad_version", lambda b: b[:8] + b"\x02" + b[9:]),
])
def test_corrupt_files_are_refused_as_the_reference_refuses_them(
        baked, tmp_path, name, mutate):
    bad = _mutate(baked, tmp_path, mutate)
    with pytest.raises(DMLCError, match="bad shard"):
        shard.ShardReader(bad)
    with pytest.raises(RefDMLCError, match="bad shard"):
        ref_shard.ShardReader(bad)


def test_window_skew_is_refused(baked, tmp_path):
    # the first window's tag flipped: the footer stays valid, the window
    # cross-check catches it
    bad = _mutate(baked, tmp_path,
                  lambda b: b[:16] + bytes([b[16] ^ 0xFF]) + b[17:])
    reader = shard.ShardReader(bad)
    with pytest.raises(DMLCError, match="tag"):
        reader.read_window(0)
    reader.close()
    # a window header that disagrees with the footer index
    bad = _mutate(baked, tmp_path,
                  lambda b: b[:20] + bytes([b[20] ^ 1]) + b[21:])
    reader = shard.ShardReader(bad, use_mmap=False)
    with pytest.raises(DMLCError, match="disagrees"):
        reader.read_window(0)
    reader.close()


def test_shard_read_faultpoint_fires(baked):
    resilience.configure("shard.read:nth=1")
    with pytest.raises(InjectedFault) as exc:
        shard.ShardReader(baked)
    assert isinstance(exc.value, OSError)  # transient by classification
    resilience.reset()
    parser = shard.ShardParser(baked)
    resilience.configure("shard.read:nth=3")
    with pytest.raises(InjectedFault):
        for _ in parser:
            pass
    resilience.reset()
    parser.close()
    shard.ShardReader(baked).close()  # an unfaulted open works


# ---------------------------------------------------------------------------
# the windowed global shuffle
# ---------------------------------------------------------------------------


def _labels_in_order(mod, dst, nparts, seed, epochs=1, unit=1):
    """Labels a world of ``nparts`` parsers (each advanced ``epochs - 1``
    times) reads, part after part."""
    out = []
    for k in range(nparts):
        p = mod.ShardParser(dst, k, nparts, seed=seed, shuffle_window=unit)
        for _ in range(epochs - 1):
            p.before_first()
        out.extend(v for b in p for v in b.label.tolist())
        p.close()
    return out


@pytest.fixture()
def small_windows(tmp_path):
    dst = str(tmp_path / "corpus.dtsh")
    bake_dataset(_libsvm(tmp_path / "corpus.svm"), dst, rows_per_window=32,
                 device="cpu")
    return dst


@pytest.mark.parametrize("seed,epochs,unit", [
    (-1, 1, 1), (13, 1, 1), (13, 2, 1), (13, 3, 1), (14, 1, 1), (13, 1, 2),
    (5, 2, 3)])
def test_shuffle_order_matches_reference(small_windows, seed, epochs, unit):
    got = _labels_in_order(shard, small_windows, 1, seed, epochs, unit)
    assert got == _labels_in_order(ref_shard, small_windows, 1, seed,
                                   epochs, unit)
    for world in (2, 3):
        assert _labels_in_order(shard, small_windows, world, seed, epochs,
                                unit) == got
    assert sorted(got) == list(range(600))
    if seed >= 0:
        assert got != list(range(600))


def test_mix_epoch_seed_matches_reference():
    from dmlc_tpu.data.parsers import _mix_epoch_seed as ref_mix
    from dmlc_tpu_torch.data.parsers import _mix_epoch_seed

    for seed in (0, 1, 13, 2 ** 40 + 7):
        for epoch in range(4):
            assert _mix_epoch_seed(seed, epoch) == ref_mix(seed, epoch)


def test_shuffle_seed_from_env_and_uri(small_windows, monkeypatch):
    want = _labels_in_order(ref_shard, small_windows, 1, 13)
    monkeypatch.setenv("DMLC_TPU_SHUFFLE", "13")
    assert [v for b in drain_blocks(shard.ShardParser(small_windows))
            for v in b.label.tolist()] == want
    monkeypatch.setenv("DMLC_TPU_SHUFFLE", "99")
    parser = create_parser(small_windows + "?shuffle_chunks=13",
                           device="cpu")
    assert drain(parser).label.tolist() == want
    monkeypatch.setenv("DMLC_TPU_SHUFFLE_WINDOW", "2")
    assert [v for b in drain_blocks(shard.ShardParser(small_windows))
            for v in b.label.tolist()] == _labels_in_order(
        ref_shard, small_windows, 1, 99, unit=2)


def drain_blocks(parser):
    try:
        return list(parser)
    finally:
        parser.close()


def test_reset_partition_and_snapshot_state_match_reference(small_windows):
    port = shard.ShardParser(small_windows, 0, 1, seed=21)
    ref = ref_shard.ShardParser(small_windows, 0, 1, seed=21)
    port.before_first()
    ref.before_first()
    for part in range(2):
        port.reset_partition(part, 2)
        ref.reset_partition(part, 2)
        assert [b.label.tolist() for b in port] \
            == [b.label.tolist() for b in ref]
    assert port.snapshot_state() == ref.snapshot_state()
    assert port.stats() == ref.stats()
    resumed = shard.ShardParser(small_windows, 0, 1, seed=21)
    resumed.restore_state(dict(port.snapshot_state(), epoch=0))
    fresh = ref_shard.ShardParser(small_windows, 0, 1, seed=21)
    fresh.before_first()
    assert [b.label.tolist() for b in resumed] \
        == [b.label.tolist() for b in fresh]
    with pytest.raises(DMLCError, match="read-plan"):
        resumed.restore_state(dict(port.snapshot_state(), uri="x.dtsh"))
    with pytest.raises(DMLCError, match="window"):
        resumed.restore_state(dict(port.snapshot_state(), window=9))
    for p in (port, ref, resumed, fresh):
        p.close()


# ---------------------------------------------------------------------------
# audit chains and the source-cache token
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [-1, 17])
def test_audit_chains_of_an_epoch_match_reference(baked, seed):
    chains = []
    for mod, auditor in ((shard, Auditor(rank=0, mode="full")),
                         (ref_shard, RefAuditor(rank=0, mode="full"))):
        p = mod.ShardParser(baked, 0, 1, seed=seed)
        p._audit = auditor
        p._stamp_audit()
        for _ in p:
            pass
        p.close()
        out = auditor.export()
        assert out["chains"]["io_read"]["n"] == out["chains"]["parse"]["n"] \
            == 10
        chains.append((out["shard"], out["chains"]))
        assert auditor.roll_epoch(0) == [] and not auditor.divergences
    assert chains[0] == chains[1]


def test_cache_token_matches_reference(baked, tmp_path, monkeypatch):
    for uri, fmt in ((baked, "auto"), (baked, "shard"),
                     (str(tmp_path / r"corpus\.dtsh"), "shard"),
                     (str(tmp_path / "corpus.svm"), "libsvm"),
                     (str(tmp_path / "missing.dtsh"), "shard")):
        assert shard.cache_token(uri, fmt) == ref_shard.cache_token(uri, fmt)
    monkeypatch.setenv("DMLC_TPU_SHUFFLE", "4")
    monkeypatch.setenv("DMLC_TPU_SHUFFLE_WINDOW", "3")
    token = shard.cache_token(baked, "shard")
    assert token == ref_shard.cache_token(baked, "shard")
    assert token[:3] == [1, 4, 3]


# ---------------------------------------------------------------------------
# the slice as a whole: the csr fit read from .rec and .dtsh
# ---------------------------------------------------------------------------

NF = 4097
HYPER = dict(objective="logistic", learning_rate=0.5, l2=0.01, momentum=0.5)
FIT = dict(batch_size=64, epochs=2, layout="csr", num_features=NF)


def _fit_file(tmp_path):
    """900 rows of float values over ids in [1, NF), text chunks of
    several blocks; its .rec (1024-row groups, 100 here) and .dtsh."""
    rng = np.random.RandomState(5)
    lines = []
    for _ in range(900):
        ids = np.sort(rng.choice(np.arange(1, NF), rng.randint(1, 9),
                                 replace=False))
        lines.append("%d %s" % (rng.randint(0, 2), " ".join(
            "%d:%.6f" % (j, v) for j, v in zip(ids, rng.randn(len(ids))))))
    text = tmp_path / "fit.svm"
    text.write_text("\n".join(lines) + "\n")
    rec = str(tmp_path / "fit.rec")
    convert_to_recordio(str(text), rec, rows_per_group=100, device="cpu")
    dtsh = str(tmp_path / "fit.dtsh")
    bake_dataset(str(text), dtsh, rows_per_window=128, device="cpu")
    return {"text": str(text), "rec": rec + "?format=recordio", "dtsh": dtsh}


def _init_params(seed=6):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(NF) * 0.01).astype(np.float32),
            "b": np.float32(0.02)}


def _port_fit(uri, **fit):
    learner = LinearLearner(device="cpu", params=_init_params(), **HYPER)
    history = learner.fit_uri(uri, **dict(FIT, **fit))
    return history, params_to_numpy(learner.params)


@pytest.mark.parametrize("fmt", ["rec", "dtsh"])
def test_csr_fit_from_binary_formats_equals_text_fit(tmp_path, fmt):
    files = _fit_file(tmp_path)
    kernels.reset_launch_counts()
    history, params = _port_fit(files[fmt])
    text_history, text_params = _port_fit(files["text"])
    assert history == text_history and history[1] < history[0]
    for k in ("w", "b"):
        assert np.array_equal(params[k], text_params[k]), k
    assert kernels.tokenize_boundaries.launches == 0  # the CPU route


@pytest.mark.parametrize("fmt", ["rec", "dtsh"])
def test_csr_fit_from_binary_formats_matches_reference(tmp_path, fmt):
    """Tolerance rtol 1e-5 / atol 1e-6, that of
    tests/test_torch_linear.py::test_fit_uri_matches_reference_learner:
    the sums run in another f32 order (torch's index_add_ against XLA's
    scatter) and exp / log1p come from two math libraries."""
    files = _fit_file(tmp_path)
    history, params = _port_fit(files[fmt])
    ref = RefLinearLearner(None, **HYPER)
    ref.params = {k: jnp.asarray(a) for k, a in _init_params().items()}
    ref.velocity = {k: jnp.zeros_like(a) for k, a in ref.params.items()}
    ref_feed = RefDeviceFeed(
        ref_create_parser(files[fmt], threaded=False),
        RefBatchSpec(batch_size=64, layout="csr", num_features=NF),
        host_prefetch=0)
    try:
        ref_history = ref.fit_feed(ref_feed, epochs=2)
    finally:
        ref_feed.close()
    np.testing.assert_allclose(history, ref_history, rtol=1e-5, atol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(params[k], np.asarray(ref.params[k]),
                                   rtol=1e-5, atol=1e-6)


def test_shuffled_shard_fit_resumes_bit_identical(tmp_path):
    """Snapshotted, stopped after epoch 1 and resumed with resume=True:
    the resumed run must read epoch 2's permutation, not epoch 0's."""
    files = _fit_file(tmp_path)
    uri = files["dtsh"] + "?shuffle_chunks=5"
    try:
        whole = _port_fit(uri, epochs=3)
        plain = _port_fit(files["dtsh"], epochs=3)
        assert whole[0] != plain[0]  # the shuffle changed the batches
        snap = str(tmp_path / "snap")
        first = _port_fit(uri, epochs=2, snapshot_uri=snap)
        assert first[0] == whole[0][:2]
        resumed = _port_fit(uri, epochs=3, snapshot_uri=snap, resume=True)
    finally:
        resilience.preempt.uninstall()
    assert resumed[0] == whole[0]
    for k in ("w", "b"):
        assert np.array_equal(resumed[1][k], whole[1][k]), k

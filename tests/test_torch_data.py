"""The port's host data path against the JAX package's on the same files:
InputSplit partitions, libsvm parsing, static-shape padding and the
DeviceFeed's batches."""

import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.device import BatchSpec as RefBatchSpec
from dmlc_tpu.device import DeviceFeed as RefDeviceFeed
from dmlc_tpu.device import csr as ref_csr
from dmlc_tpu.io.input_split import create_input_split as ref_create_split
from dmlc_tpu_torch.data import RowBlock, RowBlockContainer, create_parser
from dmlc_tpu_torch.data import vparse
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed, csr
from dmlc_tpu_torch.io import CachedInputSplit, create_input_split
from dmlc_tpu_torch.utils import DMLCError


def _libsvm_lines(seed, rows, max_id=40, weights=False):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        n = rng.randint(0, 7)
        ids = np.sort(rng.choice(np.arange(1, max_id), n, replace=False))
        head = str(rng.randint(0, 2))
        if weights:
            head += ":%g" % rng.choice([0.5, 1.0, 2.0])
        feats = []
        for j in ids:
            if rng.rand() < 0.2:
                feats.append("%d" % j)  # index only: value 1
            else:
                feats.append("%d:%.5g" % (j, rng.randn() * 10 ** rng.randint(
                    -3, 4)))
        lines.append(" ".join([head] + feats))
    return lines


@pytest.fixture
def svm_file(tmp_path):
    path = tmp_path / "data.svm"
    lines = _libsvm_lines(0, 300)
    # blank lines and \r\n endings collapse: they produce no records
    text = "\n".join(lines[:100]) + "\n\n" + "\r\n".join(lines[100:]) + "\n"
    path.write_bytes(text.encode())
    return str(path)


def _records(split):
    out = []
    while True:
        rec = split.next_record()
        if rec is None:
            split.close()
            return out
        out.append(bytes(rec))


@pytest.mark.parametrize("nparts", [1, 3, 7])
def test_input_split_parts_match_reference(svm_file, tmp_path, nparts):
    # a second, short file makes the dataset a ;-separated list
    extra = tmp_path / "extra.svm"
    extra.write_text("\n".join(_libsvm_lines(1, 9)) + "\n")
    uri = svm_file + ";" + str(extra)
    every = []
    for part in range(nparts):
        got = _records(create_input_split(uri, part, nparts, "text"))
        want = _records(ref_create_split(uri, part, nparts, "text",
                                         threaded=False))
        assert got == want
        every.extend(got)
    lines = [ln.strip().encode() for ln in open(svm_file, "rb").read()
             .decode().splitlines() if ln.strip()]
    lines += [ln.encode() for ln in extra.read_text().splitlines()]
    assert every == lines  # every line exactly once, in order


def test_input_split_small_chunks_and_directory(tmp_path):
    data = tmp_path / "dir"
    data.mkdir()
    for k in range(3):
        (data / f"part-{k}").write_text(
            "\n".join(_libsvm_lines(10 + k, 40)) + "\n")
    for part in range(2):
        split = create_input_split(str(data), part, 2)
        split.hint_chunk_size(64)
        ref = ref_create_split(str(data), part, 2, threaded=False)
        ref.hint_chunk_size(64)
        assert _records(split) == _records(ref)


def test_input_split_rejects_cache_file_and_remote(svm_file):
    # a #cachefile selects CachedInputSplit (tests/test_torch_input_split.py
    # holds its frames against the JAX package's); it refuses a new
    # partition and the chunk shuffle
    split = create_input_split(svm_file + "#" + svm_file + ".cache", 0, 1)
    assert isinstance(split, CachedInputSplit)
    with pytest.raises(DMLCError, match="repartition after caching"):
        split.reset_partition(0, 2)
    split.close()
    with pytest.raises(DMLCError, match="cache"):
        create_input_split(svm_file + "#" + svm_file + ".cache", 0, 1,
                           num_shuffle_parts=2)
    # remote schemes go through the filesystem registry (the fake servers
    # of tests/test_torch_remote_ingest.py); a scheme it lacks is refused
    # there, and viewfs:// refuses as the reference's gated backends do
    with pytest.raises(DMLCError, match="unknown filesystem protocol"):
        create_input_split("nosuch://bucket/data.svm", 0, 1)
    with pytest.raises(DMLCError, match="not enabled"):
        create_input_split("viewfs://cluster/data.svm", 0, 1)


def _concat(blocks):
    cont = RowBlockContainer()
    for b in blocks:
        cont.push_block(RowBlock(b.offset, b.label, b.index, b.value,
                                 b.weight, b.qid, b.field))
    return cont.to_block()


def _assert_blocks_equal(got, want):
    assert np.array_equal(got.offset, want.offset)
    for name in ("label", "index", "value", "weight", "qid"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype, name
            assert np.array_equal(g, w), name


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("nparts", [1, 3])
def test_parser_rowblocks_match_reference(tmp_path, monkeypatch, weights,
                                          nparts):
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    path = tmp_path / "w.svm"
    path.write_text("\n".join(_libsvm_lines(2, 250, weights=weights)) + "\n")
    for part in range(nparts):
        parser = create_parser(str(path), part, nparts, threaded=False,
                               device="cpu")
        ref = ref_create_parser(str(path), part, nparts, threaded=False)
        parser._source.hint_chunk_size(512)
        ref._source.hint_chunk_size(512)
        got, want = _concat(list(parser)), _concat(list(ref))
        assert len(got) > 0
        _assert_blocks_equal(got, want)
        assert parser.bytes_read == ref.bytes_read
        parser.close()
        ref.close()


def test_vector_parse_matches_scalar_oracle():
    text = ("1 1:0.5 3:2e-3 7\n"
            "0:2.5 qid:4 2:-1.25e+2 9:0\n"
            "\n"
            "1 4:1 5:.5\r\n"
            "0\n").encode()
    got, want = RowBlockContainer(), RowBlockContainer()
    vparse.parse_libsvm_vector(text, got)
    vparse.parse_libsvm_scalar(text, want)
    _assert_blocks_equal(got.to_block(), want.to_block())
    assert len(got) == 4


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4097, 319_488, 1 << 20])
def test_round_up_bucket_matches_reference(n):
    assert csr.round_up_bucket(n) == ref_csr.round_up_bucket(n,
                                                             csr.NNZ_FLOOR)
    assert csr.round_up_bucket(n) == ref_csr.round_up_bucket(n)


def _block(seed, rows):
    lines = _libsvm_lines(seed, rows, weights=seed % 2 == 1)
    cont = RowBlockContainer()
    vparse.parse_libsvm_vector(("\n".join(lines) + "\n").encode(), cont)
    return cont.to_block()


@pytest.mark.parametrize("rows,batch", [(10, 16), (16, 16), (1, 4)])
def test_pad_to_bucket_and_block_to_dense_match_reference(rows, batch):
    block = _block(rows, rows)
    got = csr.pad_to_bucket(block, batch)
    want = ref_csr.pad_to_bucket(block, batch)
    # the feed ships offsets, not per-entry row ids (expand_row_ids builds
    # those on the device, and test_torch_ops holds it to the reference)
    for name in ("labels", "weights", "indices", "values", "offsets"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
    assert (got.num_rows, got.num_nonzero) == (want.num_rows,
                                               want.num_nonzero)
    # the padding invariants: padded rows weigh 0, padded entries are value
    # 0 at feature 0, padded rows repeat the valid nnz
    assert not got.weights[rows:].any()
    assert not got.values[got.num_nonzero:].any()
    assert not got.indices[got.num_nonzero:].any()
    assert (got.offsets[rows:] == got.num_nonzero).all()
    got = csr.block_to_dense(block, batch, 20)  # ids >= 20 are dropped
    want = ref_csr.block_to_dense(block, batch, 20)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _batches(feed):
    return [{k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)) for k, v in b.items()} for b in feed]


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_device_feed_matches_reference(svm_file, monkeypatch, layout,
                                       drop_remainder):
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    kw = dict(batch_size=32, layout=layout, num_features=40,
              drop_remainder=drop_remainder)
    parser = create_parser(svm_file, threaded=False, device="cpu")
    ref = ref_create_parser(svm_file, threaded=False)
    # chunks of ~20 lines: batches straddle chunk boundaries
    parser._source.hint_chunk_size(1024)
    ref._source.hint_chunk_size(1024)
    feed = DeviceFeed(parser, BatchSpec(**kw), device="cpu")
    ref_feed = RefDeviceFeed(ref, RefBatchSpec(**kw), host_prefetch=0)
    for epoch in range(2):
        got, want = _batches(feed), _batches(ref_feed)
        assert len(got) == len(want) == (9 if drop_remainder else 10)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in g:
                assert g[key].dtype == w[key].dtype, key
                assert np.array_equal(g[key], w[key]), key
        feed.before_first()
        ref_feed.before_first()
    feed.close()
    ref_feed.close()


def test_device_feed_rejects_out_of_range_feature(tmp_path):
    path = tmp_path / "big.svm"
    path.write_text("1 3:1\n0 50:2\n")
    feed = DeviceFeed(str(path), BatchSpec(batch_size=4, layout="csr",
                                           num_features=10), device="cpu")
    with pytest.raises(DMLCError, match="out of range"):
        list(feed)

"""The port's row-group records (``dmlc_tpu_torch/data/rowrec.py``) and
its ``recordio`` parser against the JAX package's: row-group payloads are
byte-equal with and without weights, qids and values; a text file
converted on the CPU route is byte-equal to the JAX package's conversion
(its Python stack: ``DMLC_TPU_NATIVE=0``, ``DMLC_TPU_PARSE_BACKEND=
vector``); ``create_parser(uri?format=recordio)`` gives the JAX package's
blocks, part by part. Host code: every comparison is equality."""

import itertools

import numpy as np
import pytest

from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.data import rowrec as ref_rowrec
from dmlc_tpu.data.row_block import RowBlock as RefRowBlock
from dmlc_tpu.utils.logging import DMLCError as RefDMLCError
from dmlc_tpu_torch.data import (RecordIORowParser, RowBlock,
                                 RowBlockContainer, ThreadedParser,
                                 create_parser, rowrec)
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.utils import DMLCError

FIELDS = ("offset", "label", "index", "value", "weight", "qid", "field")


@pytest.fixture(autouse=True)
def python_stack(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")


def _block(seed, weight, qid, value, rows=50):
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 7, rows)
    offset = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    nnz = int(offset[-1])
    return dict(
        offset=offset, label=rng.randint(0, 2, rows).astype(np.float32),
        index=rng.randint(0, 1 << 20, nnz).astype(np.uint32),
        value=rng.randn(nnz).astype(np.float32) if value else None,
        weight=rng.rand(rows).astype(np.float32) if weight else None,
        qid=rng.randint(0, 9, rows).astype(np.int64) if qid else None)


def assert_blocks_equal(got, want):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("weight,qid,value",
                         list(itertools.product([False, True], repeat=3)))
def test_row_group_payload_is_byte_equal(weight, qid, value):
    arrays = _block(3, weight, qid, value)
    payload = rowrec.encode_row_group(RowBlock(**arrays))
    assert payload == ref_rowrec.encode_row_group(RefRowBlock(**arrays))
    back = rowrec.decode_row_group(payload)
    assert_blocks_equal(back, ref_rowrec.decode_row_group(payload))
    assert_blocks_equal(back, RowBlock(**arrays))


def test_bad_payloads_raise():
    payload = rowrec.encode_row_group(RowBlock(**_block(1, 1, 1, 1)))
    for bad, why in ((payload[:5], "too short"),
                     (b"Q" + payload[1:], "bad tag"),
                     (payload[:-4], "truncated"),
                     (payload + b"\0", "trailing")):
        with pytest.raises(DMLCError, match=why):
            rowrec.decode_row_group(bad)
    libfm = RowBlock(**_block(2, 0, 0, 1))
    libfm.field = np.zeros(libfm.num_nonzero, np.uint32)
    with pytest.raises(DMLCError, match="libfm"):
        rowrec.encode_row_group(libfm)


def _libsvm(path, rows, seed, weights=False, qid=False):
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for i in range(rows):
            head = "%d" % rng.randint(0, 2)
            if weights:
                head += ":%.2f" % rng.rand()
            if qid:
                head += " qid:%d" % (i // 10)
            ids = np.sort(rng.choice(5000, rng.randint(0, 12), False))
            fh.write(" ".join([head] + ["%d:%.4f" % (j, rng.randn())
                                        for j in ids]) + "\n")
    return str(path)


def _csv(path, rows, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for i in range(rows):
            fh.write(",".join(["%d" % (i % 2)] + ["%.3f" % v for v in
                                                   rng.rand(5)]) + "\n")
    return str(path) + "?format=csv&label_column=0"


SOURCES = {
    "libsvm": lambda p: _libsvm(p, 2500, 1),
    "libsvm_weight_qid": lambda p: _libsvm(p, 1500, 2, True, True),
    "csv": lambda p: _csv(p, 1200, 3),
}


@pytest.mark.parametrize("rows_per_group", [7, 1024])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_convert_on_the_cpu_route_is_byte_equal(tmp_path, name,
                                                rows_per_group):
    src = SOURCES[name](tmp_path / "src.txt")
    kernels.reset_launch_counts()
    rows = rowrec.convert_to_recordio(src, str(tmp_path / "port.rec"),
                                      rows_per_group=rows_per_group,
                                      device="cpu")
    ref_rows = ref_rowrec.convert_to_recordio(
        src, str(tmp_path / "ref.rec"), rows_per_group=rows_per_group)
    assert rows == ref_rows > 1000
    assert (tmp_path / "port.rec").read_bytes() \
        == (tmp_path / "ref.rec").read_bytes()
    assert kernels.tokenize_boundaries.launches == 0  # the CPU route


def _concat(parser):
    cont = RowBlockContainer()
    try:
        for block in parser:
            cont.push_block(RowBlock(block.offset, block.label, block.index,
                                     block.value, block.weight, block.qid,
                                     block.field))
        return cont.to_block()
    finally:
        parser.close()


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("nparts", [1, 2, 3])
def test_recordio_parser_blocks_match_reference(tmp_path, nparts, threaded):
    src = _libsvm(tmp_path / "src.svm", 3000, 4, weights=True)
    rec = str(tmp_path / "d.rec")
    rowrec.convert_to_recordio(src, rec, rows_per_group=100, device="cpu")
    text = _concat(create_parser(src, device="cpu"))
    parts = []
    for part in range(nparts):
        parser = create_parser(rec + "?format=recordio", part, nparts,
                               threaded=threaded, device="cpu")
        assert isinstance(parser, ThreadedParser if threaded
                          else RecordIORowParser)
        got = _concat(parser)
        want = _concat(ref_create_parser(rec + "?format=recordio", part,
                                         nparts, threaded=False))
        assert_blocks_equal(got, want)
        parts.append(got)
    whole = RowBlockContainer()
    for got in parts:
        whole.push_block(got)
    assert_blocks_equal(whole.to_block(), text)


def test_recordio_parser_epochs_and_bytes(tmp_path):
    src = _libsvm(tmp_path / "src.svm", 900, 5)
    rec = str(tmp_path / "d.rec")
    rowrec.convert_to_recordio(src, rec, rows_per_group=64, device="cpu")
    parser = create_parser(rec, data_format="recordio", threaded=False,
                           device="cpu")
    ref = ref_create_parser(rec, data_format="recordio", threaded=False)
    try:
        for epoch in range(2):
            got = RowBlockContainer()
            for block in parser:
                got.push_block(block)
            want = RowBlockContainer()
            for block in ref:
                want.push_block(block)
            assert_blocks_equal(got.to_block(), want.to_block())
            assert parser.bytes_read == ref.bytes_read > 0
            if epoch == 0:
                parser.before_first()
                ref.before_first()
    finally:
        parser.close()
        ref.close()


def test_converting_libfm_raises(tmp_path):
    src = tmp_path / "f.libfm"
    src.write_text("1 0:3:0.5 1:7:1\n0 2:1:2\n")
    with pytest.raises(DMLCError, match="libfm"):
        rowrec.convert_to_recordio(str(src), str(tmp_path / "f.rec"),
                                   data_format="libfm", device="cpu")
    with pytest.raises(RefDMLCError, match="libfm"):
        ref_rowrec.convert_to_recordio(str(src), str(tmp_path / "g.rec"),
                                       data_format="libfm")

"""The port's text-ingest layer against the JAX package's on the same bytes:
the tokenizer's plain version, the LibSVM / LibFM / CSV parsers, the
threaded parser, the registry, the row iterators with their cache pages,
and the serializer's bytes. Token masks and parses are exact, so every
comparison is equality (same dtype, same values): no tolerance anywhere.
"""

import random
import struct

import numpy as np
import pytest
import torch

from dmlc_tpu.data import DiskRowIter as RefDiskRowIter
from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.data import create_row_block_iter as ref_create_row_block_iter
from dmlc_tpu.data import vparse as ref_vparse
from dmlc_tpu.data.row_block import RowBlockContainer as RefContainer
from dmlc_tpu.io import serializer as ref_serializer
from dmlc_tpu.io.stream import MemoryStream as RefMemoryStream
from dmlc_tpu.ops import pallas_kernels as jax_kernels
from dmlc_tpu_torch.data import (PARSER_REGISTRY, DiskRowIter, LibSVMParser,
                                 Parser, PipelinedParser, RowBlock,
                                 RowBlockContainer, ThreadedParser,
                                 create_parser, create_row_block_iter,
                                 register_parser, vparse)
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.io import (CachedInputSplit, MemoryStream,
                               create_input_split,
                               create_stream, load_obj, save_obj)
from dmlc_tpu_torch.models import LinearLearner, params_to_numpy
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.utils import DMLCError

# tests/test_parse_parity.py's tokenizer sizes and alphabet, plus a chunk of
# separators only and one with none
ALPHABET = b"0123456789.:-+e \t\r\nqid"
MASK_CASES = [(ALPHABET, n) for n in (0, 1, 127, 128, 129, 4096, 33000)] + [
    (b" \t:\r\n", 999), (b"0123456789.-+eqid", 999)]


@pytest.fixture(autouse=True)
def vector_backend(monkeypatch):
    """The JAX package's numpy parse, never its native core (whose LibFM
    parse gives u64 fields): the port has no native core."""
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")


def _chunk(alphabet, size, seed=77):
    r = random.Random(seed + size)
    return np.frombuffer(bytes(r.choice(alphabet) for _ in range(size)),
                         dtype=np.uint8)


# ---------------------------------------------------------------------------
# token masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alphabet,size", MASK_CASES)
def test_tokenize_plain_matches_pallas_and_numpy(alphabet, size):
    a = _chunk(alphabet, size)
    starts, ends = kernels.tokenize_boundaries(torch.from_numpy(a.copy()))
    assert starts.dtype == ends.dtype == torch.bool
    assert starts.shape == ends.shape == (size,)
    pallas = jax_kernels.tokenize_boundaries(a, interpret=True)
    for want in (pallas, ref_vparse.token_boundary_masks(a),
                 vparse.token_boundary_masks(a)):
        assert np.array_equal(starts.numpy(), want[0])
        assert np.array_equal(ends.numpy(), want[1])


@pytest.mark.parametrize("alphabet,size", MASK_CASES[1:])
def test_kernel_token_spans_match_pallas_spans(monkeypatch, alphabet, size):
    monkeypatch.setenv("DMLC_TPU_PALLAS", "parse")
    a = _chunk(alphabet, size)
    got = vparse.kernel_token_spans(a, device="cpu")
    want = ref_vparse.pallas_token_spans(a)
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and np.array_equal(g, w)


def test_cpu_route_counts_no_launch_and_default_device_needs_a_card(
        monkeypatch):
    kernels.reset_launch_counts()
    vparse.kernel_token_masks(_chunk(ALPHABET, 100), device="cpu")
    assert kernels.tokenize_boundaries.launches == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        vparse.kernel_token_spans(_chunk(ALPHABET, 100))


# ---------------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------------


def _libsvm_text(seed, rows, weights=False, qid=False):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(rows):
        head = str(rng.randint(0, 2))
        if weights and rng.rand() < 0.7:
            head += ":%g" % rng.choice([0.5, 1.0, 2.0])
        toks = [head]
        if qid:
            toks.append("qid:%d" % (i // 7))
        ids = np.sort(rng.choice(np.arange(1, 300), rng.randint(0, 9),
                                 replace=False))
        for j in ids:
            toks.append("%d" % j if rng.rand() < 0.2 else
                        "%d:%.5g" % (j, rng.randn() * 10 ** rng.randint(-3,
                                                                        4)))
        lines.append(" ".join(toks))
    return "\n".join(lines) + "\n"


def _libfm_text(seed, rows):
    rng = np.random.RandomState(seed)
    return "".join("%d %s\n" % (rng.randint(0, 2), " ".join(
        "%d:%d:%.4f" % (rng.randint(0, 5), rng.randint(0, 200), rng.rand())
        for _ in range(rng.randint(0, 6)))) for _ in range(rows))


def _csv_text(seed, rows, ragged=False):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        width = rng.randint(3, 7) if ragged else 5
        cells = ["%.4f" % v for v in rng.randn(width)]
        cells[0] = str(rng.randint(0, 2))
        if ragged and rng.rand() < 0.2:
            cells[-1] = ""  # a trailing comma reads 0
        lines.append(",".join(cells))
    return "\n".join(lines) + "\n"


FILES = {
    "libsvm": lambda: _libsvm_text(1, 400),
    "libsvm_weights": lambda: _libsvm_text(2, 400, weights=True),
    "libsvm_qid": lambda: _libsvm_text(3, 300, qid=True),
    "libfm": lambda: _libfm_text(4, 800),
    "csv": lambda: _csv_text(5, 800),
    "csv_ragged": lambda: _csv_text(6, 800, ragged=True),
}
FORMATS = {"libsvm": "libsvm", "libsvm_weights": "libsvm",
           "libsvm_qid": "libsvm", "libfm": "libfm", "csv": "csv",
           "csv_ragged": "csv"}
CSV_ARGS = ["", "?label_column=0", "?label_column=0&weight_column=2"]


def _write(tmp_path, name):
    path = tmp_path / (name + ".txt")
    path.write_text(FILES[name]())
    return str(path)


def _concat(blocks):
    cont = RowBlockContainer()
    for b in blocks:
        cont.push_block(RowBlock(b.offset, b.label, b.index, b.value,
                                 b.weight, b.qid, b.field))
    return cont.to_block()


def assert_blocks_equal(got, want):
    for name in ("offset", "label", "index", "value", "weight", "qid",
                 "field"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), name


def _drain(parser):
    try:
        return list(parser)
    finally:
        parser.close()


def _parse_both(uri, part, nparts, fmt, nthread, threaded, chunk=None):
    port = create_parser(uri, part, nparts, fmt, nthread, threaded,
                         device="cpu")
    ref = ref_create_parser(uri, part, nparts, fmt, nthread, threaded=False)
    if chunk is not None:
        port._source.hint_chunk_size(chunk)
        ref._source.hint_chunk_size(chunk)
    got, want = _drain(port), _drain(ref)
    assert port.bytes_read == ref.bytes_read
    return got, want


@pytest.mark.parametrize("nthread,threaded", [(1, False), (2, False),
                                              (4, False), (2, True)])
@pytest.mark.parametrize("name", sorted(FILES))
def test_parser_matches_reference(tmp_path, name, nthread, threaded):
    """One part, the JAX package's default 8 MiB chunk: nthread splits
    the chunk at line breaks into parts parsed in a pool; the blocks, one
    a chunk, must equal the JAX package's one by one."""
    uri = _write(tmp_path, name)
    suffixes = CSV_ARGS if FORMATS[name] == "csv" else [""]
    for suffix in suffixes:
        got, want = _parse_both(uri + suffix, 0, 1, FORMATS[name], nthread,
                                threaded)
        assert len(got) == len(want) == 1
        assert len(got[0]) > 0
        assert_blocks_equal(got[0], want[0])


@pytest.mark.parametrize("name", sorted(FILES))
def test_parser_parts_with_small_chunks_match_reference(tmp_path, name):
    """Parts 0..2 of 3 with 5000-byte chunks (each split in two by
    nthread=2): each part's rows equal the JAX package's, and together the
    parts hold every row of the file exactly once."""
    uri = _write(tmp_path, name)
    fmt = FORMATS[name]
    everything = []
    for part in range(3):
        got, want = _parse_both(uri, part, 3, fmt, 2, False, chunk=5000)
        assert len(got) > 1
        assert_blocks_equal(_concat(got), _concat(want))
        everything.extend(got)
    whole, _ = _parse_both(uri, 0, 1, fmt, 1, False)
    assert_blocks_equal(_concat(everything), whole[0])


@pytest.mark.parametrize("name", ["csv", "csv_ragged"])
def test_csv_vector_table_matches_scalar_oracle_and_reference(name):
    """The vectorized csv table equals its scalar oracle and the JAX
    package's, bit for bit, on whole text, text whose last line has no
    break, and blank text."""
    text = FILES[name]().encode()
    for chunk in (text, text[:text.rindex(b"\n", 0, 777)], b"", b"\n\n"):
        got = vparse.parse_csv_vector_table(chunk)
        for want in (vparse.parse_csv_scalar_table(chunk),
                     ref_vparse.parse_csv_vector_table(chunk)):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want)


def test_threaded_parser_repeats_epochs(tmp_path):
    """A directly built ThreadedParser, and the PipelinedParser that
    create_parser returns for a Parser when threaded: a second epoch after
    before_first gives the first's rows again."""
    uri = _write(tmp_path, "libsvm_weights")
    threaded = ThreadedParser(LibSVMParser(create_input_split(uri, 0, 1),
                                           device="cpu"))
    pipelined = create_parser(uri, device="cpu")
    assert isinstance(pipelined, PipelinedParser)
    for parser in (threaded, pipelined):
        assert parser.device == torch.device("cpu")
        first = _concat(list(parser))
        parser.before_first()
        second = _concat(list(parser))
        parser.close()
        assert_blocks_equal(first, second)
        assert parser.bytes_read == 2 * len(open(uri, "rb").read())


def test_unknown_format_and_cache_file_raise(tmp_path):
    uri = _write(tmp_path, "libsvm")
    with pytest.raises(DMLCError, match="unknown data format 'svmlight'"):
        create_parser(uri, data_format="svmlight", device="cpu")
    with pytest.raises(DMLCError, match="unknown data format"):
        create_parser(uri + "?format=svmlight", device="cpu")
    # a #cachefile uri reads through CachedInputSplit, as the JAX
    # package's Python stack does: the first epoch writes the chunks as
    # [u64 size][bytes] frames, the second replays them; the cache bytes
    # and both epochs' blocks equal the JAX package's
    caches = {"port": tmp_path / "port.cache", "ref": tmp_path / "ref.cache"}
    port = create_parser(uri + "#" + str(caches["port"]), threaded=False,
                         device="cpu")
    ref = ref_create_parser(uri + "#" + str(caches["ref"]), threaded=False)
    try:
        assert isinstance(port._source, CachedInputSplit)
        text = open(uri, "rb").read()
        for epoch in range(2):
            assert_blocks_equal(_concat(list(port)), _concat(list(ref)))
            frames = caches["port"].read_bytes()
            assert frames == caches["ref"].read_bytes()
            assert frames == struct.pack("<Q", len(text)) + text
            port.before_first()
            ref.before_first()
        assert port.bytes_read == ref.bytes_read == 2 * len(text)
    finally:
        port.close()
        ref.close()
    # a cache file does not combine with the chunk shuffle
    with pytest.raises(DMLCError, match="cache"):
        create_parser(uri + "?shuffle_chunks=3#" + str(tmp_path / "c.bin"),
                      device="cpu")


class _SemicolonParser(Parser):
    """A plugin format: ``label;index,index,...`` with implicit ones."""

    def parse_chunk(self, chunk):
        out = RowBlockContainer()
        for line in chunk.splitlines():
            if line.strip():
                label, ids = line.split(b";")
                out.push_row(float(label),
                             [int(i) for i in ids.split(b",") if i])
        return out


def test_register_parser_plugin(tmp_path):
    name = "semicolon_rows"
    if PARSER_REGISTRY.find(name) is None:
        register_parser(name, lambda source, args, nthread, device:
                        _SemicolonParser(source, nthread, device))
    path = tmp_path / "p.txt"
    path.write_text("1;3,5\n0;\n1;2\n")
    for uri, fmt in ((str(path), name), (str(path) + "?format=" + name,
                                         "auto")):
        block = _concat(_drain(create_parser(uri, data_format=fmt,
                                             device="cpu")))
        assert np.array_equal(block.offset, [0, 2, 2, 3])
        assert np.array_equal(block.index, np.array([3, 5, 2], np.uint32))
        assert np.array_equal(block.label, np.array([1, 0, 1], np.float32))
    assert name in PARSER_REGISTRY.list_all_names()
    with pytest.raises(Exception, match="already registered"):
        register_parser(name, lambda *a: None)


def test_libsvm_parser_tokenizes_each_part_through_the_wrapper(
        tmp_path, monkeypatch):
    """LibSVMParser gets its masks from kernels.tokenize_boundaries, once
    for each non-empty part of each chunk, on the parser's device."""
    uri = _write(tmp_path, "libsvm_weights")
    want = _concat(_drain(create_parser(uri, device="cpu")))
    calls = []
    real = kernels.tokenize_boundaries

    def spy(a):
        calls.append((a.device.type, a.shape[0]))
        return real(a)

    monkeypatch.setattr(kernels, "tokenize_boundaries", spy)
    parser = create_parser(uri, nthread=2, threaded=False, device="cpu")
    parser._source.hint_chunk_size(5000)
    got = _concat(_drain(parser))
    assert_blocks_equal(got, want)
    assert all(dev == "cpu" and n > 0 for dev, n in calls)
    assert sum(n for _, n in calls) == len(open(uri, "rb").read())
    assert len(calls) > 2  # several chunks, each split in two


# ---------------------------------------------------------------------------
# row iterators and their cache pages
# ---------------------------------------------------------------------------


def _read_iter(it):
    try:
        return _concat(list(it)), it.num_col()
    finally:
        if hasattr(it, "close"):  # the JAX package's BasicRowIter has none
            it.close()


@pytest.mark.parametrize("name", ["libsvm_weights", "libsvm_qid", "libfm",
                                  "csv_ragged"])
def test_basic_row_iter_matches_reference(tmp_path, name):
    uri = _write(tmp_path, name)
    fmt = FORMATS[name]
    got, ncol = _read_iter(create_row_block_iter(uri, data_format=fmt,
                                                 device="cpu"))
    want, ref_ncol = _read_iter(ref_create_row_block_iter(uri,
                                                          data_format=fmt))
    assert_blocks_equal(got, want)
    assert ncol == ref_ncol == int(got.index.max()) + 1


@pytest.mark.parametrize("name", ["libsvm_weights", "libfm", "csv"])
def test_disk_row_iter_cold_then_warm_matches_reference(tmp_path, name):
    uri = _write(tmp_path, name)
    fmt = FORMATS[name]
    want, ref_ncol = _read_iter(ref_create_row_block_iter(
        uri + "#" + str(tmp_path / "ref.cache"), data_format=fmt))
    cache = str(tmp_path / "port.cache")
    for _ in ("cold", "warm"):
        it = create_row_block_iter(uri + "#" + cache, data_format=fmt,
                                   device="cpu")
        assert isinstance(it, DiskRowIter)
        got, ncol = _read_iter(it)
        assert_blocks_equal(got, want)
        assert ncol == ref_ncol
    # a second epoch through before_first replays the pages
    it = create_row_block_iter(uri + "#" + cache, data_format=fmt,
                               device="cpu")
    first = _concat(list(it))
    it.before_first()
    second, _ = _read_iter(it)
    assert_blocks_equal(first, second)


def test_cache_pages_load_across_packages(tmp_path):
    """A cache the port wrote loads in the JAX package's DiskRowIter, and
    one the JAX package wrote loads in the port's: same pages, same
    num_col."""
    uri = _write(tmp_path, "libsvm_qid")
    ours, theirs = str(tmp_path / "ours.cache"), str(tmp_path / "theirs.cache")
    port_block, port_ncol = _read_iter(create_row_block_iter(
        uri + "#" + ours, device="cpu"))
    ref_block, ref_ncol = _read_iter(ref_create_row_block_iter(
        uri + "#" + theirs))
    got, ncol = _read_iter(RefDiskRowIter(None, ours))
    assert_blocks_equal(got, port_block)
    assert ncol == port_ncol
    got, ncol = _read_iter(DiskRowIter(None, theirs))
    assert_blocks_equal(got, ref_block)
    assert ncol == ref_ncol == port_ncol
    assert (open(ours, "rb").read() == open(theirs, "rb").read())


def test_disk_row_iter_spills_pages(tmp_path, monkeypatch):
    """Small pages: the cache holds several, and reads back in order."""
    from dmlc_tpu_torch.data import row_iter

    monkeypatch.setattr(row_iter, "PAGE_BYTES", 4096)
    uri = _write(tmp_path, "libsvm")
    cache = str(tmp_path / "small.cache")
    parser = create_parser(uri, threaded=False, device="cpu")
    parser._source.hint_chunk_size(2000)
    got, _ = _read_iter(DiskRowIter(parser, cache))
    want, _ = _read_iter(create_row_block_iter(uri, device="cpu"))
    assert_blocks_equal(got, want)
    with create_stream(cache, "r") as stream:
        pages = 0
        while True:
            try:
                RowBlockContainer.load(stream)
            except EOFError:
                break
            pages += 1
    assert pages > 2


def test_row_iter_resolves_its_device_first(tmp_path, monkeypatch):
    uri = _write(tmp_path, "libsvm")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        create_row_block_iter(uri)
    with pytest.raises(DMLCError, match="no CUDA device"):
        create_parser(uri)


# ---------------------------------------------------------------------------
# RowBlock views and the serializer
# ---------------------------------------------------------------------------


def test_row_block_views_match_reference():
    text = _libsvm_text(9, 50, weights=True, qid=True).encode()
    cont = RowBlockContainer()
    vparse.parse_libsvm_vector(text, cont)
    block = cont.to_block()
    ref_cont = RefContainer()
    ref_vparse.parse_libsvm_vector(text, ref_cont)
    ref = ref_cont.to_block()
    assert block.num_col() == ref.num_col()
    assert block.mem_cost_bytes() == ref.mem_cost_bytes()
    assert cont.mem_cost_bytes() == ref_cont.mem_cost_bytes()
    assert cont.max_index == ref_cont.max_index
    assert np.array_equal(block.to_dense(), ref.to_dense())
    w = np.random.RandomState(0).rand(block.num_col())
    for row, ref_row in zip(block, ref):
        assert (row.label, row.weight, row.qid, len(row)) == (
            ref_row.label, ref_row.weight, ref_row.qid, len(ref_row))
        assert np.array_equal(row.index, ref_row.index)
        assert row.sdot(w) == ref_row.sdot(w)
    assert block[3].get_value(0) == ref[3].get_value(0)


PAYLOADS = {
    "page": lambda: {
        "offset": np.arange(5, dtype=np.int64),
        "label": np.array([1, 0, 1, 1], np.float32),
        "index": np.array([3, 9, 2, 7], np.uint32),
        "value": None, "weight": np.ones(4, np.float32),
        "qid": np.array([1, 1, 2, 2], np.int64), "field": None,
        "max_index": 9},
    "scalars": lambda: [True, False, -7, 2**63 - 1, -(2**63), 2**70,
                        -(2**90), 0.1, float("inf"), b"\x00ab", "héllo"],
    "nested": lambda: {"t": (1, [2.5, None]), 3: {"x", "y", "z"},
                       "e": np.zeros((0, 3), np.float64),
                       "s": np.array(4.5, np.float32),
                       "n": np.int16(-3), "f": np.float32(0.25)},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_serializer_bytes_match_reference(name):
    obj = PAYLOADS[name]()
    ours = MemoryStream()
    save_obj(ours, obj)
    theirs = RefMemoryStream()
    ref_serializer.save_obj(theirs, obj)
    assert ours.getvalue() == theirs.getvalue()
    back = load_obj(MemoryStream(theirs.getvalue()))
    ref_back = ref_serializer.load_obj(RefMemoryStream(ours.getvalue()))
    assert repr(back) == repr(ref_back)


def test_container_page_bytes_match_reference():
    text = _libsvm_text(10, 80, weights=True, qid=True).encode()
    cont, ref_cont = RowBlockContainer(), RefContainer()
    vparse.parse_libsvm_vector(text, cont)
    ref_vparse.parse_libsvm_vector(text, ref_cont)
    ours, theirs = MemoryStream(), RefMemoryStream()
    cont.save(ours)
    cont.save(ours)
    ref_cont.save(theirs)
    ref_cont.save(theirs)
    assert ours.getvalue() == theirs.getvalue()
    stream = MemoryStream(theirs.getvalue())
    for _ in range(2):
        page = RowBlockContainer.load(stream)
        assert_blocks_equal(page.to_block(), ref_cont.to_block())
        assert page.max_index == ref_cont.max_index
    with pytest.raises(EOFError):
        RowBlockContainer.load(stream)


# ---------------------------------------------------------------------------
# the training path over the new parser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_fit_uri_bits_do_not_depend_on_the_parser_threads(tmp_path, layout):
    """fit_uri reads through create_parser's PipelinedParser over 2
    worker threads; its fit must equal, bit for bit, a fit over one
    unthreaded single-thread parser with 700-byte chunks: the rows and
    their order are the same, so every batch is."""
    uri = _write(tmp_path, "libsvm_weights")
    hyper = dict(objective="logistic", learning_rate=0.5, momentum=0.5)
    learner = LinearLearner(device="cpu", **hyper)
    history = learner.fit_uri(uri, batch_size=32, epochs=2, layout=layout,
                              num_features=300)
    parser = create_parser(uri, nthread=1, threaded=False, device="cpu")
    parser._source.hint_chunk_size(700)
    feed = DeviceFeed(parser, BatchSpec(batch_size=32, layout=layout,
                                        num_features=300), device="cpu")
    other = LinearLearner(device="cpu", **hyper)
    try:
        other_history = other.fit_feed(feed, epochs=2)
    finally:
        feed.close()
    assert history == other_history
    got, want = params_to_numpy(learner.params), params_to_numpy(
        other.params)
    for k in ("w", "b"):
        assert got[k].tobytes() == want[k].tobytes()


def test_device_feed_from_a_uri_parses_on_its_device(tmp_path):
    uri = _write(tmp_path, "libsvm")
    feed = DeviceFeed(uri, BatchSpec(batch_size=64, layout="csr",
                                     num_features=300), device="cpu")
    try:
        assert feed._parser.device == torch.device("cpu")
        assert sum(b["num_rows"] for b in feed) == 400
    finally:
        feed.close()

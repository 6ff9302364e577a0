"""The port's ordered window (``io/readahead``) and cross-chunk pipelined
parser (``data/pipeline``) against the JAX package's and serial parsing.

``PipelinedParser`` is held block for block, bit for bit, against the JAX
package's ``PipelinedParser`` (its vectorized numpy parse,
``DMLC_TPU_PARSE_BACKEND=vector``, without the native core,
``DMLC_TPU_NATIVE=0``) and against the port's unthreaded single-thread
parser, at 1, 2 and 4 workers, with chunks small enough that each file
spans many of them.
"""

import threading
import time

import numpy as np
import pytest

from dmlc_tpu.data.parsers import PARSER_REGISTRY as REF_REGISTRY
from dmlc_tpu.data.pipeline import PipelinedParser as RefPipelinedParser
from dmlc_tpu.io.input_split import create_input_split as ref_create_split
from dmlc_tpu.io.uri_spec import URISpec as RefURISpec
from dmlc_tpu_torch.data import (LibSVMParser, PipelinedParser,
                                 ThreadedParser, create_parser,
                                 register_parser)
from dmlc_tpu_torch.io import OrderedWindow, create_input_split, \
    fetch_ordered
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.utils import DMLCError

CHUNK = 3000  # bytes: each file below spans 6 to 15 chunks


@pytest.fixture
def vector_backend(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")


# ---------------------------------------------------------------------------
# OrderedWindow / fetch_ordered
# ---------------------------------------------------------------------------


def test_ordered_window_delivers_in_submission_order():
    """Later items finish first (shorter sleeps); pops still come back in
    submission order, through the window and through fetch_ordered."""
    def slow(i):
        time.sleep(0.002 * (20 - i))
        return i * i

    win = OrderedWindow(slow, workers=4, window=20)
    try:
        for i in range(20):
            win.submit(i)
        assert [win.pop() for _ in range(20)] == [i * i for i in range(20)]
    finally:
        win.close()
    assert list(fetch_ordered(slow, range(20), workers=4)) == \
        [i * i for i in range(20)]


@pytest.mark.parametrize("workers,window", [(1, 0), (2, 3), (4, 0)])
def test_fetch_ordered_backpressure(workers, window):
    """At most ``window`` (default 2×workers) items are drawn from the
    source ahead of the consumer."""
    drawn = []

    def source():
        for i in range(40):
            drawn.append(i)
            yield i

    bound = window if window > 0 else 2 * workers
    ahead = []
    for consumed, value in enumerate(fetch_ordered(
            lambda i: i + 1, source(), workers=workers, window=window)):
        assert value == consumed + 1
        ahead.append(len(drawn) - consumed)
    assert max(ahead) <= bound and len(drawn) == 40


def test_ordered_window_poisons_at_the_failed_position():
    started = []
    lock = threading.Lock()

    def fn(i):
        with lock:
            started.append(i)
        if i == 3:
            raise ValueError("bad item 3")
        return i

    win = OrderedWindow(fn, workers=2, window=8)
    for i in range(8):
        win.submit(i)
    assert [win.pop() for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="bad item 3"):
        win.pop()
    # everything behind the failure is gone, and the window takes no more
    assert len(win) == 0
    with pytest.raises(DMLCError, match="closed"):
        win.submit(9)


def test_ordered_window_close_cancels_pending():
    gate = threading.Event()
    calls = []

    def fn(i):
        calls.append(i)
        gate.wait(10)
        return i

    win = OrderedWindow(fn, workers=1, window=10)
    for i in range(10):
        win.submit(i)
    time.sleep(0.05)
    win.close()
    win.close()  # idempotent
    gate.set()
    time.sleep(0.05)
    assert calls == [0]  # the running call finished; the rest never ran


# ---------------------------------------------------------------------------
# PipelinedParser
# ---------------------------------------------------------------------------


def _libsvm_text(rng, rows):
    lines = []
    for _ in range(rows):
        ids = np.sort(rng.choice(np.arange(1, 500), rng.randint(0, 9),
                                 replace=False))
        head = str(rng.randint(0, 2))
        if rng.rand() < 0.3:
            head += ":%g" % rng.choice([0.5, 2.0])
        lines.append(" ".join([head] + ["%d:%.5g" % (j, rng.randn())
                                        for j in ids]))
    return "\n".join(lines) + "\n"


def _libfm_text(rng, rows):
    return "".join("%d %s\n" % (rng.randint(0, 2), " ".join(
        "%d:%d:%.4f" % (rng.randint(0, 5), rng.randint(0, 200), rng.rand())
        for _ in range(rng.randint(0, 6)))) for _ in range(rows))


def _csv_text(rng, rows):
    return "".join(",".join([str(rng.randint(0, 2))] + [
        "%.4f" % v for v in rng.randn(4)]) + "\n" for _ in range(rows))


TEXTS = {"libsvm": _libsvm_text, "libfm": _libfm_text, "csv": _csv_text}
FIELDS = ("offset", "label", "index", "value", "weight", "qid", "field")


def _write(tmp_path, fmt, rows=900, seed=5):
    path = tmp_path / f"{fmt}.txt"
    path.write_text(TEXTS[fmt](np.random.RandomState(seed), rows))
    return str(path)


def _assert_same_blocks(got, want):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for name in FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), name


def _source_of(parser):
    return parser._base._source


def _drain(parser):
    try:
        return list(parser)
    finally:
        parser.close()


@pytest.mark.parametrize("nthread", [1, 2, 4])
@pytest.mark.parametrize("fmt", sorted(TEXTS))
def test_pipelined_blocks_match_reference_and_serial(tmp_path,
                                                     vector_backend, fmt,
                                                     nthread):
    uri = _write(tmp_path, fmt)
    if fmt == "csv":
        uri += "?label_column=0"
    port = create_parser(uri, 0, 1, fmt, nthread, device="cpu")
    assert isinstance(port, PipelinedParser)
    # what the JAX package's create_parser builds, over an unthreaded
    # InputSplit: its prefetching one may read the first chunk before a
    # size hint lands
    ref_split = ref_create_split(uri, 0, 1, "text", threaded=False)
    ref_split.hint_chunk_size(CHUNK)
    ref = RefPipelinedParser(REF_REGISTRY.find(fmt)(
        ref_split, RefURISpec(uri, 0, 1).args, 1), nthread)
    serial = create_parser(uri, 0, 1, fmt, 1, threaded=False, device="cpu")
    for src in (_source_of(port), serial._source):
        src.hint_chunk_size(CHUNK)
    kernels.reset_launch_counts()
    got, want, plain = _drain(port), _drain(ref), _drain(serial)
    _assert_same_blocks(got, want)
    _assert_same_blocks(got, plain)
    assert port.bytes_read == ref.bytes_read == serial.bytes_read
    stats = port.stats()
    assert stats["chunks"] == len(got) and stats["nthread"] == nthread
    assert stats["window"] == 2 * nthread and stats["parse_ns"] > 0
    # the CPU route takes the tokenizer's plain version: no launch
    assert kernels.tokenize_boundaries.launches == 0


class _FailingParser(LibSVMParser):
    """Raises on the chunk that holds the feature id 4242."""

    def parse_chunk(self, chunk):
        if b" 4242:" in chunk:
            raise ValueError("bad chunk")
        return super().parse_chunk(chunk)


@pytest.mark.parametrize("nthread", [1, 4])
def test_worker_error_surfaces_at_its_chunk(tmp_path, nthread):
    uri = _write(tmp_path, "libsvm")
    serial = create_parser(uri, 0, 1, "libsvm", 1, threaded=False,
                           device="cpu")
    serial._source.hint_chunk_size(CHUNK)
    whole = _drain(serial)
    # plant the id in the 5th chunk's second row
    lines = open(uri).read().splitlines()
    row = sum(len(b) for b in whole[:4]) + 1
    lines[row] += " 4242:1"
    open(uri, "w").write("\n".join(lines) + "\n")
    parser = PipelinedParser(_FailingParser(create_input_split(uri, 0, 1),
                                            1, "cpu"), nthread=nthread)
    parser._base._source.hint_chunk_size(CHUNK)
    got = []
    try:
        with pytest.raises(ValueError, match="bad chunk"):
            while True:
                block = parser.next_block()
                assert block is not None, "the failed chunk was skipped"
                got.append(block)
        _assert_same_blocks(got, whole[:4])
        # the window is poisoned: the parser does not go on past the fault
        with pytest.raises(DMLCError, match="closed"):
            parser.next_block()
    finally:
        parser.close()


def test_before_first_replays_an_epoch(tmp_path):
    uri = _write(tmp_path, "libsvm")
    parser = create_parser(uri, nthread=4, device="cpu")
    _source_of(parser).hint_chunk_size(CHUNK)
    try:
        first = list(parser)
        parser.before_first()
        partial = [parser.next_block(), parser.next_block()]
        parser.before_first()  # mid-epoch: in-flight chunks are dropped
        second = list(parser)
        assert parser.stats()["chunks"] >= 2 * len(first) + 2
    finally:
        parser.close()
    _assert_same_blocks(second, first)
    _assert_same_blocks(partial, first[:2])
    with pytest.raises(DMLCError, match="closed"):
        parser.next_block()


def test_create_parser_wraps_a_non_parser_plugin_in_threaded_parser(
        tmp_path):
    uri = _write(tmp_path, "libsvm")

    class Plugin:
        """A registered parser that is not a Parser: no chunk surface."""

        def __init__(self, source, device):
            self._inner = LibSVMParser(source, 1, device)
            self.device = self._inner.device

        @property
        def bytes_read(self):
            return self._inner.bytes_read

        def next_block(self):
            return self._inner.next_block()

        def before_first(self):
            self._inner.before_first()

        def close(self):
            self._inner.close()

    register_parser("plugin_not_a_parser",
                    lambda source, args, nthread, device:
                    Plugin(source, device))
    parser = create_parser(uri, data_format="plugin_not_a_parser",
                           device="cpu")
    assert isinstance(parser, ThreadedParser)
    rows = sum(len(b) for b in _drain(parser))
    assert rows == 900

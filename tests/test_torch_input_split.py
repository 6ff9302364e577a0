"""The port's InputSplits (``dmlc_tpu_torch/io/input_split.py``) against
the JAX package's on the same seeded files: the records (and, where both
read the same chunk size, the chunks) of every part of text, recordio and
indexed-recordio data; the shuffles' orders over two epochs; the cache
file's frames and its replay; standard input; recursive directories; and
the prefetch thread's epoch, partition and close handling. Host code
over bytes: every comparison is equality."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from dmlc_tpu.io import input_split as ref_split
from dmlc_tpu_torch.io import input_split as split_mod
from dmlc_tpu_torch.io import recordio
from dmlc_tpu_torch.io.stream import FileObjStream
from dmlc_tpu_torch.utils import DMLCError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
create_input_split = split_mod.create_input_split
MAGIC = (0xCED7230A).to_bytes(4, "little")


@pytest.fixture(autouse=True)
def python_stack(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")


def _text_files(tmp_path, nfiles=3, rows=400, seed=0):
    """A ;-list of text files: runs of blank lines, \\r\\n and \\r breaks,
    a last line with no break."""
    rng = np.random.RandomState(seed)
    paths = []
    for f in range(nfiles):
        lines = []
        for i in range(rows):
            line = "%d %s" % (i, " ".join(
                "%d:%.3f" % (j, rng.rand())
                for j in sorted(rng.choice(90, rng.randint(0, 7), False))))
            brk = ["\n", "\r\n", "\n\n\n", "\r"][rng.randint(0, 4)]
            lines.append(line + brk)
        path = tmp_path / f"t{f}.txt"
        path.write_text("".join(lines).rstrip("\n\r"))
        paths.append(str(path))
    return ";".join(paths)


def _rec_files(tmp_path, nfiles=2, nrec=300, seed=1):
    """RecordIO files whose payloads sometimes hold the aligned magic."""
    rng = np.random.RandomState(seed)
    paths, records = [], []
    for f in range(nfiles):
        path = tmp_path / f"r{f}.rec"
        with open(path, "wb") as fh:
            writer = recordio.RecordIOWriter(FileObjStream(fh))
            for i in range(nrec):
                body = bytearray(rng.bytes(int(rng.randint(0, 200))))
                if i % 5 == 0 and len(body) >= 8:
                    pos = 4 * int(rng.randint(0, len(body) // 4 - 1))
                    body[pos:pos + 4] = MAGIC
                writer.write_record(bytes(body))
                records.append(bytes(body))
        paths.append(str(path))
    return ";".join(paths), records


def _index(tmp_path, uri):
    """An index over the concatenation of ``uri``'s files (offsets are
    dataset offsets)."""
    data = b"".join(open(p, "rb").read() for p in uri.split(";"))
    whole = tmp_path / "whole.rec"
    whole.write_bytes(data)
    idx = tmp_path / "whole.idx"
    recordio.build_index(str(whole), str(idx))
    return str(idx)


def _drain_records(split):
    try:
        return [bytes(r) for r in split.records()]
    finally:
        split.close()


def _drain_chunks(split):
    try:
        return [bytes(c) for c in split.chunks()]
    finally:
        split.close()


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("nparts", [1, 2, 3, 5])
@pytest.mark.parametrize("kind", ["text", "recordio", "indexed_recordio"])
def test_records_of_every_part_match_reference(tmp_path, kind, nparts,
                                               threaded):
    if kind == "text":
        uri, kw = _text_files(tmp_path), {}
    else:
        uri, _ = _rec_files(tmp_path)
        kw = ({"index_uri": _index(tmp_path, uri), "batch_size": 7}
              if kind == "indexed_recordio" else {})
    every = []
    for part in range(nparts):
        got = _drain_records(create_input_split(
            uri, part, nparts, kind, threaded=threaded, **kw))
        want = _drain_records(ref_split.create_input_split(
            uri, part, nparts, kind, threaded=False, **kw))
        assert got == want
        every.extend(got)
    whole = _drain_records(ref_split.create_input_split(
        uri, 0, 1, kind, threaded=False, **kw))
    assert every == whole and len(whole) > 100


@pytest.mark.parametrize("chunk", [64, 1000])
@pytest.mark.parametrize("kind", ["text", "recordio"])
def test_chunks_match_reference_after_a_hint(tmp_path, kind, chunk):
    """A hint given before the first read holds from the first chunk: the
    prefetch thread starts at the first read."""
    uri = _text_files(tmp_path) if kind == "text" \
        else _rec_files(tmp_path)[0]
    for part in range(3):
        port = create_input_split(uri, part, 3, kind)
        assert isinstance(port, split_mod.ThreadedInputSplit)
        port.hint_chunk_size(chunk)
        ref = ref_split.create_input_split(uri, part, 3, kind,
                                           threaded=False)
        ref.hint_chunk_size(chunk)
        got, want = _drain_chunks(port), _drain_chunks(ref)
        assert got == want and len(got) > 1


def test_indexed_shuffle_and_batches_match_reference(tmp_path):
    uri, records = _rec_files(tmp_path)
    idx = _index(tmp_path, uri)
    for seed in (0, 7):
        for part, nparts in ((0, 1), (1, 3)):
            kw = dict(index_uri=idx, shuffle=True, seed=seed, batch_size=5)
            port = create_input_split(uri, part, nparts, "indexed_recordio",
                                      threaded=False, **kw)
            ref = ref_split.create_input_split(
                uri, part, nparts, "indexed_recordio", threaded=False, **kw)
            epochs = []
            for epoch in range(2):
                got = [bytes(r) for r in port.records()]
                assert got == [bytes(r) for r in ref.records()]
                epochs.append(got)
                port.before_first()
                ref.before_first()
            assert epochs[0] != epochs[1]
            assert sorted(epochs[0]) == sorted(epochs[1])
            # next_batch completes a short batch before a new one
            assert port.next_batch(3) == ref.next_batch(3)
            assert port.next_batch(4) == ref.next_batch(4)
            port.close()
            ref.close()
    unshuffled = create_input_split(uri, 0, 1, "indexed_recordio",
                                    index_uri=idx, threaded=False)
    assert unshuffled.get_total_size() == sum(
        os.path.getsize(p) for p in uri.split(";"))
    assert _drain_records(unshuffled) == records


@pytest.mark.parametrize("nparts", [1, 2])
@pytest.mark.parametrize("kind", ["text", "recordio"])
def test_shuffled_sub_splits_match_reference_over_two_epochs(tmp_path, kind,
                                                             nparts):
    uri = _text_files(tmp_path) if kind == "text" \
        else _rec_files(tmp_path)[0]
    for part in range(nparts):
        port = create_input_split(uri, part, nparts, kind,
                                  num_shuffle_parts=4, seed=11)
        ref = ref_split.create_input_split(uri, part, nparts, kind,
                                           num_shuffle_parts=4, seed=11,
                                           threaded=False)
        assert isinstance(port, split_mod.InputSplitShuffle)
        orders = []
        for epoch in range(2):
            got = [bytes(r) for r in port.records()]
            assert got == [bytes(r) for r in ref.records()]
            orders.append(got)
            port.before_first()
            ref.before_first()
        assert sorted(orders[0]) == sorted(orders[1])
        assert orders[0] != orders[1]
        port.close()
        ref.close()


def test_cached_split_frames_and_replay_match_reference(tmp_path):
    uri = _text_files(tmp_path, nfiles=1, rows=900)
    port_base = split_mod.LineSplitter(uri)
    ref_base = ref_split.LineSplitter(uri)
    for base in (port_base, ref_base):
        base.reset_partition(0, 1)
        base.hint_chunk_size(2000)
    cache = {"port": str(tmp_path / "port.cache"),
             "ref": str(tmp_path / "ref.cache")}
    port = split_mod.CachedInputSplit(port_base, cache["port"])
    ref = ref_split.CachedInputSplit(ref_base, cache["ref"])
    try:
        first = [bytes(c) for c in port.chunks()]
        assert first == [bytes(c) for c in ref.chunks()] and len(first) > 3
        frames = open(cache["port"], "rb").read()
        assert frames == open(cache["ref"], "rb").read()
        assert frames == b"".join(len(c).to_bytes(8, "little") + c
                                  for c in first)
        port.before_first()
        ref.before_first()
        assert [bytes(c) for c in port.chunks()] == first
        assert [bytes(c) for c in ref.chunks()] == first
        with pytest.raises(DMLCError, match="chunk-only"):
            port.next_record()
    finally:
        port.close()
        ref.close()
    # a new split over the warm cache replays it; so does the reference's
    # over the port's cache
    again = create_input_split(uri + "#" + cache["port"], 0, 1)
    assert isinstance(again, split_mod.CachedInputSplit)
    assert _drain_chunks(again) == first
    cross = ref_split.CachedInputSplit(ref_split.LineSplitter(uri),
                                       cache["port"])
    assert _drain_chunks(cross) == first


_STDIN_READER = """
import hashlib, sys
sys.path.insert(0, sys.argv[1])
from dmlc_tpu_torch.io import create_input_split
split = create_input_split("stdin", 0, 1)
split.hint_chunk_size(int(sys.argv[2]))
recs = list(split.records())
print(len(recs), hashlib.sha256(b"|".join(recs)).hexdigest())
"""


@pytest.mark.parametrize("chunk", [16, 1 << 20])
def test_single_file_split_reads_stdin(tmp_path, chunk):
    uri = _text_files(tmp_path, nfiles=1, rows=300)
    with open(uri, "rb") as fh:
        out = subprocess.run(
            [sys.executable, "-c", _STDIN_READER, ROOT, str(chunk)],
            stdin=fh, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    ref = ref_split.SingleFileSplit(uri)
    want = [bytes(r) for r in ref.records()]
    assert out.stdout.split() == [
        str(len(want)), hashlib.sha256(b"|".join(want)).hexdigest()]
    port = split_mod.SingleFileSplit(uri)
    port.hint_chunk_size(chunk)
    assert [bytes(r) for r in port.records()] == want
    port.before_first()
    assert len(list(port.records())) == len(want)
    with pytest.raises(DMLCError, match="partitioning"):
        port.reset_partition(0, 2)
    port.close()


def test_recurse_directories_matches_reference(tmp_path):
    root = tmp_path / "data"
    for sub in ("", "a", "a/deep", "b"):
        d = root / sub
        d.mkdir(parents=True, exist_ok=True)
        for k in range(2):
            (d / f"part-{k}").write_text(
                "".join(f"{sub or 'top'} {k} {i}\n" for i in range(30)))
    (root / "empty").write_text("")
    for recurse in (False, True):
        got = [path for path, _ in
               split_mod.list_split_files(str(root), recurse)]
        want = [info.path.name for info in
                ref_split.list_split_files(str(root), recurse)]
        assert got == want
        for nparts in (1, 3):
            for part in range(nparts):
                kw = dict(recurse_directories=recurse)
                assert _drain_records(create_input_split(
                    str(root), part, nparts, **kw)) == _drain_records(
                    ref_split.create_input_split(str(root), part, nparts,
                                                 threaded=False, **kw))
    assert len(split_mod.list_split_files(str(root), True)) == 8


def test_threaded_split_epochs_partitions_and_close(tmp_path):
    uri = _text_files(tmp_path)
    whole = _drain_records(create_input_split(uri, 0, 1, threaded=False))
    split = create_input_split(uri, 0, 1)
    split.hint_chunk_size(256)
    first = [split.next_record() for _ in range(5)]
    split.before_first()  # mid-epoch: the prefetched chunks are dropped
    assert [bytes(r) for r in split.records()] == whole
    assert first == whole[:5]
    parts = []
    for part in range(3):
        split.reset_partition(part, 3)
        parts.extend(bytes(r) for r in split.records())
    assert parts == whole
    assert split.get_total_size() == sum(
        os.path.getsize(p) for p in uri.split(";"))
    split.close()
    assert split._iter is None  # the prefetch thread was joined


def test_bad_arguments_raise(tmp_path):
    uri = _text_files(tmp_path, nfiles=1)
    with pytest.raises(DMLCError, match="unknown input split type"):
        create_input_split(uri, 0, 1, "parquet")
    with pytest.raises(DMLCError, match="index_uri"):
        create_input_split(uri, 0, 1, "indexed_recordio")
    with pytest.raises(DMLCError, match="align"):
        (tmp_path / "odd.rec").write_bytes(b"abc")
        create_input_split(str(tmp_path / "odd.rec"), 0, 1, "recordio")
    with pytest.raises(DMLCError, match="Cannot find"):
        create_input_split(str(tmp_path / "none-*"), 0, 1)

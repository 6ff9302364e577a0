"""The port's determinism audit (``dmlc_tpu_torch/obs/audit.py``) against
the JAX package's, on the same files and the same chunking.

- The ``io_read``, ``parse`` and ``batch`` digest chains of a seeded
  libsvm file and a libfm file, read through each package's
  ``PipelinedParser`` (3000-byte chunks, one worker; the JAX package on
  its vector parse, ``DMLC_TPU_NATIVE=0``) into a csr ``DeviceFeed``:
  exactly equal (the same seqs, the same hex digests, the same rolling
  heads) — the parsers emit the reference's dtypes in every
  ``audit_arrays`` field. With more workers the parse chain's seqs and
  digests stay equal, but its rolling head follows the workers' arrival
  order in either package.
- The ``model`` chain of a linear fit on integer data with the squared
  objective, where both packages' fits are bit-identical: equal heads.
- An injected byte flip (``audit.corrupt``) in the second epoch leaves the
  io_read chain clean, forks the parse chain at the flipped chunk's seq
  (and the batch chain downstream of it), and writes the
  ``audit-rank<k>.json`` bundle; a clean fit's self-check finds nothing.
- ``export_state`` / ``restore_state`` round-trip through a job snapshot
  and ``collective.load_snapshot``.
"""

import json

import numpy as np
import pytest

from dmlc_tpu.data.parsers import PARSER_REGISTRY as REF_REGISTRY
from dmlc_tpu.data.pipeline import PipelinedParser as RefPipelinedParser
from dmlc_tpu.device import BatchSpec as RefBatchSpec
from dmlc_tpu.device import DeviceFeed as RefDeviceFeed
from dmlc_tpu.io.input_split import create_input_split as ref_create_split
from dmlc_tpu.io.uri_spec import URISpec as RefURISpec
from dmlc_tpu.models import LinearLearner as RefLinearLearner
from dmlc_tpu.obs import audit as ref_audit
from dmlc_tpu_torch import collective
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.models import LinearLearner
from dmlc_tpu_torch.obs import audit
from dmlc_tpu_torch.resilience import faults, preempt

CHUNK = 3000  # bytes: each file below spans several chunks


@pytest.fixture
def audited(monkeypatch):
    """Both packages' auditors armed in full mode, the JAX package on its
    vector parse; both reset afterwards."""
    monkeypatch.setenv("DMLC_TPU_AUDIT", "full")
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")
    audit.reset_auditor()
    ref_audit.reset_auditor()
    yield
    audit.reset_auditor()
    ref_audit.reset_auditor()
    faults.reset()


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


TEXTS = {"libsvm": _libsvm_text, "libfm": _libfm_text}


def _feeds(uri, fmt, nthread):
    """(port feed, reference feed) over 3000-byte chunks, csr, 64 rows a
    batch."""
    port_parser = create_parser(uri, 0, 1, fmt, nthread, device="cpu")
    port_parser._base._source.hint_chunk_size(CHUNK)
    ref_split = ref_create_split(uri, 0, 1, "text", threaded=False)
    ref_split.hint_chunk_size(CHUNK)
    ref_parser = RefPipelinedParser(REF_REGISTRY.find(fmt)(
        ref_split, RefURISpec(uri, 0, 1).args, 1), nthread)
    spec = dict(batch_size=64, layout="csr", num_features=512)
    return (DeviceFeed(port_parser, BatchSpec(**spec), device="cpu"),
            RefDeviceFeed(ref_parser, RefBatchSpec(**spec), host_prefetch=0))


@pytest.mark.parametrize("nthread", [1, 3])
@pytest.mark.parametrize("fmt", sorted(TEXTS))
def test_data_chains_equal_the_reference(tmp_path, audited, fmt, nthread):
    path = tmp_path / f"{fmt}.txt"
    path.write_text(TEXTS[fmt](np.random.RandomState(7), 900))
    port, ref = _feeds(str(path), fmt, nthread)
    try:
        n_port = sum(1 for _ in port)
        n_ref = sum(1 for _ in ref)
    finally:
        port.close()
        ref.close()
    assert n_port == n_ref > 4
    got = audit.auditor().export()["chains"]
    want = ref_audit.auditor().export()["chains"]
    for stage in ("io_read", "parse", "batch"):
        assert got[stage]["n"] > 1, stage
        if stage == "parse" and nthread > 1:
            # the rolling head follows the workers' arrival order
            got[stage].pop("head")
            want[stage].pop("head")
        assert got[stage] == want[stage], stage
    assert got["batch"]["n"] == n_port


def test_container_digest_equals_its_block():
    """The container's part-by-part stream hashes as its concatenation,
    and default-filled fields hash as the explicit ones and zeros."""
    c = RowBlockContainer()
    c.push_row(1.0, [1, 4], [0.5, 2.0])
    c.push_row(0.0, [2], None)
    c.push_row(1.0, [], [])
    block = c.to_block()
    assert audit.rows_digest(c) == audit.rows_digest(block)
    assert block.weight is None and block.qid is None
    explicit = RowBlock(offset=block.offset, label=block.label,
                        index=block.index, value=block.value,
                        weight=np.ones(3, np.float32),
                        qid=np.zeros(3, np.int64))
    assert audit.rows_digest(explicit) == audit.rows_digest(block)


def _write_int(path, rows=64, nf=9, seed=3):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        ids = np.sort(rng.choice(np.arange(1, nf), rng.randint(1, 5),
                                 replace=False))
        lines.append("%d %s" % (rng.randint(0, 2), " ".join(
            "%d:%d" % (j, v) for j, v in zip(ids, rng.randint(-2, 3,
                                                              len(ids))))))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_model_chain_equals_the_reference(tmp_path, audited, layout):
    """One batch of 64 integer rows an epoch, the squared objective and a
    power-of-two learning rate: both packages' fits are bit-identical, so
    the model chains (loss bits + strided param samples) are too."""
    uri = _write_int(tmp_path / "int.svm")
    hyper = dict(objective="squared", learning_rate=0.125)
    port = LinearLearner(device="cpu", **hyper)
    got_hist = port.fit_uri(uri, batch_size=64, epochs=2, layout=layout,
                            num_features=9)
    ref = RefLinearLearner(**hyper)
    want_hist = ref.fit_uri(uri, batch_size=64, epochs=2, layout=layout,
                            num_features=9)
    assert got_hist == want_hist
    got = audit.auditor().export()["chains"]["model"]
    want = ref_audit.auditor().export()["chains"]["model"]
    assert got["n"] == want["n"] == 2
    assert got == want


def test_injected_flip_is_located_and_bundled(tmp_path, audited,
                                              monkeypatch):
    (tmp_path / "rec").mkdir()
    monkeypatch.setenv("DMLC_TPU_FLIGHTREC", str(tmp_path / "rec"))
    path = tmp_path / "a.svm"
    path.write_text(_libsvm_text(np.random.RandomState(2), 900))
    parser = create_parser(str(path), 0, 1, "libsvm", 1, device="cpu")
    parser._base._source.hint_chunk_size(CHUNK)
    feed = DeviceFeed(parser, BatchSpec(batch_size=64, layout="csr",
                                        num_features=512), device="cpu")
    auditor = audit.auditor()
    try:
        nchunks = 0
        for _ in feed:
            pass
        nchunks = parser.stats()["chunks"]
        assert nchunks > 3
        assert auditor.roll_epoch(0) == []  # nothing to compare yet
        # epoch 1: the 3rd chunk's bytes flip after its io_read digest
        faults.configure("audit.corrupt:nth=3")
        feed.before_first()
        for _ in feed:
            pass
        found = auditor.roll_epoch(1)
    finally:
        feed.close()
    # the flip lands after the chunk's io_read digest: io_read stays
    # clean, parse forks at the flipped chunk, and the batch holding its
    # rows forks downstream
    assert [(d["stage"], d["seq"]) for d in found][0] == ("parse", 2)
    assert [d["stage"] for d in found] == ["parse", "batch"]
    bundle = tmp_path / "rec" / "audit-rank0.json"
    obj = json.loads(bundle.read_text())
    assert obj["divergence"]["stage"] == "parse"
    assert obj["divergence"]["seq"] == 2
    assert obj["shard"]["uri"] == str(path)
    assert "DMLC_TPU_AUDIT" in obj["knobs"]


def test_clean_epochs_self_check_clean(tmp_path, audited):
    path = tmp_path / "a.svm"
    path.write_text(_libsvm_text(np.random.RandomState(4), 600))
    learner = LinearLearner(device="cpu")
    learner.fit_uri(str(path), batch_size=64, epochs=3, layout="csr",
                    num_features=512)
    snap = audit.auditor().snapshot()
    assert snap["divergences"] == []
    assert snap["chains"]["model"] == 3


def test_export_state_round_trips_through_a_snapshot(tmp_path, audited):
    path = tmp_path / "a.svm"
    path.write_text(_libsvm_text(np.random.RandomState(5), 300))
    learner = LinearLearner(device="cpu")
    try:
        learner.fit_uri(str(path), batch_size=64, epochs=2, layout="csr",
                        num_features=512,
                        snapshot_uri=str(tmp_path / "snap"))
    finally:
        preempt.uninstall()
    state = audit.auditor().export_state()
    assert state["model"]["head"] and state["prev_epoch"] == 1
    audit.reset_auditor()
    fresh = audit.auditor()
    assert fresh.export_state() == {}
    snap = collective.JobSnapshot(str(tmp_path / "snap"), rank=0,
                                  world_size=1)
    version, loaded, _meta = collective.load_snapshot(snap)
    assert version == 2
    assert loaded["audit"] == state
    assert fresh.export_state() == state

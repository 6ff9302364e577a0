"""The tier-2 CLIs against the JAX package's (``dmlc_tpu/tools``) on the
same files: the same stdout, with the rates (MB/sec, examples/sec,
rows/sec) taken out, and the same exit codes. The JAX side runs its
Python stack (``DMLC_TPU_PARSE_BACKEND=vector``, ``DMLC_TPU_NATIVE=0``)."""

import json
import re

import numpy as np
import pytest

from dmlc_tpu.tools import audit_report as ref_audit_report
from dmlc_tpu.tools import bench_gate as ref_bench_gate
from dmlc_tpu.tools import dataiter as ref_dataiter
from dmlc_tpu.tools import parse as ref_parse
from dmlc_tpu.tools import split_read as ref_split_read
from dmlc_tpu.tools import stream_read as ref_stream_read
from dmlc_tpu.tools import strtonum as ref_strtonum
from dmlc_tpu_torch import tools
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.tools import (audit_report, bench_gate, dataiter, parse,
                                  split_read, stream_read, strtonum)

RATE = re.compile(r"[0-9.]+ (MB/sec|examples/sec|rows/sec)")


@pytest.fixture(autouse=True)
def _python_stack(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")


def _run(capsys, main, argv):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, RATE.sub(r"R \1", cap.out), cap.err


def _same(capsys, port_main, ref_main, argv, port_extra=()):
    got = _run(capsys, port_main, list(argv) + list(port_extra))
    want = _run(capsys, ref_main, list(argv))
    assert got[:2] == want[:2]
    return got


@pytest.fixture(scope="module")
def svm(tmp_path_factory):
    """20,000 seeded libsvm rows of 1-11 float entries."""
    rng = np.random.RandomState(3)
    path = tmp_path_factory.mktemp("t2") / "d.svm"
    lines = []
    for i in range(20000):
        ids = np.sort(rng.choice(np.arange(1, 5000), rng.randint(1, 12),
                                 replace=False))
        lines.append("%d %s" % (i % 2, " ".join(
            "%d:%.4f" % (j, rng.randn()) for j in ids)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("argv", [
    ["0", "1"], ["1", "3", "--repeat", "3"], ["0", "2", "--count-only"],
])
def test_split_read(capsys, svm, argv):
    rc, out, _ = _same(capsys, split_read.main, ref_split_read.main,
                       [svm] + argv)
    assert rc == 0 and "records" in out


def test_split_read_recordio(capsys, tmp_path, svm):
    from dmlc_tpu_torch.data.rowrec import convert_to_recordio

    rec = str(tmp_path / "d.rec")
    convert_to_recordio(svm, rec, device="cpu")
    rc, out, _ = _same(capsys, split_read.main, ref_split_read.main,
                       [rec, "0", "2", "--type", "recordio"])
    assert rc == 0


def test_split_read_reports_every_10_mb(capsys, tmp_path):
    path = tmp_path / "big.txt"
    path.write_bytes((b"x" * 99 + b"\n") * (120 * 1024))  # 11.7 MB
    rc, out, _ = _same(capsys, split_read.main, ref_split_read.main,
                       [str(path), "0", "1"])
    assert rc == 0 and "10 MB read" in out


@pytest.mark.parametrize("argv", [[], ["--rw", "--size-mb", "9"]])
def test_stream_read(capsys, tmp_path, svm, argv):
    uri = svm if not argv else str(tmp_path / "rw.bin")
    rc, out, _ = _same(capsys, stream_read.main, ref_stream_read.main,
                       [uri] + argv)
    assert rc == 0 and "read " in out


def test_stream_read_over_mem_uri(capsys):
    """Any registered scheme: ``mem://`` in both packages."""
    rc, out, _ = _same(capsys, stream_read.main, ref_stream_read.main,
                       ["mem://t2/rw.bin", "--rw", "--size-mb", "4"])
    assert rc == 0 and "wrote 4194304 bytes" in out


@pytest.mark.parametrize("argv", [
    [], ["1", "3"], ["--nthread", "1"], ["--format", "libsvm"],
])
def test_parse(capsys, svm, argv):
    kernels.reset_launch_counts()
    rc, out, _ = _same(capsys, parse.main, ref_parse.main, [svm] + argv,
                       port_extra=["--device", "cpu"])
    assert rc == 0 and "examples" in out
    assert kernels.tokenize_boundaries.launches == 0  # the CPU route


def test_parse_csv_and_libfm(capsys, tmp_path):
    csv = tmp_path / "d.csv"
    csv.write_text("".join("%d,%d,%.2f\n" % (i % 2, i, i / 7)
                           for i in range(500)))
    fm = tmp_path / "d.fm"
    fm.write_text("".join("%d %d:%d:1 %d:%d:0.5\n" % (i % 2, i % 3, i,
                                                      i % 5, i + 9)
                          for i in range(500)))
    for uri, fmt in ((str(csv) + "?label_column=0", "csv"),
                     (str(fm), "libfm")):
        rc, _, _ = _same(capsys, parse.main, ref_parse.main,
                         [uri, "--format", fmt],
                         port_extra=["--device", "cpu"])
        assert rc == 0


@pytest.mark.parametrize("cache", [False, True])
def test_dataiter(capsys, tmp_path, svm, cache):
    uri = svm + ("#" + str(tmp_path / "cache") if cache else "")
    rc, out, _ = _same(capsys, dataiter.main, ref_dataiter.main,
                       [uri, "--epochs", "3"],
                       port_extra=["--batch-size", "512", "--device", "cpu"])
    assert rc == 0 and out.count("epoch") == 3


def test_dataiter_reads_through_the_feed(capsys, svm, monkeypatch):
    """Each epoch's rows pass through a csr DeviceFeed."""
    from dmlc_tpu_torch.device import feed as feed_mod

    seen = []
    real = feed_mod.DeviceFeed.__iter__

    def counting(self):
        for batch in real(self):
            seen.append(int(batch["num_rows"]))
            yield batch

    monkeypatch.setattr(feed_mod.DeviceFeed, "__iter__", counting)
    assert dataiter.main([svm, "--epochs", "2", "--batch-size", "4096",
                          "--device", "cpu"]) == 0
    assert sum(seen) == 2 * 20000 and max(seen) == 4096
    capsys.readouterr()


@pytest.mark.parametrize("argv", [[], ["--n", "5000", "--seed", "3"]])
def test_strtonum(capsys, argv):
    """The python route against the JAX package's Python stack."""
    got = _run(capsys, strtonum.main,
               argv + ["--route", "python", "--device", "cpu"])
    want = _run(capsys, ref_strtonum.main, argv)
    assert got[0] == want[0] == 0
    # the parenthesis names the route: the route and device here, the
    # native core there
    strip = re.compile(r" \((route|native)=[^)]*\)")
    assert strip.sub("", got[1]) == strip.sub("", want[1])
    assert "(route=python, device=cpu)" in got[1]


@pytest.mark.parametrize("argv", [[], ["--n", "5000", "--seed", "3"]])
def test_strtonum_native_route(capsys, monkeypatch, argv):
    """The native route (the default) against the JAX package's fuzz of
    its own native core."""
    monkeypatch.delenv("DMLC_TPU_NATIVE")
    monkeypatch.delenv("DMLC_TPU_PARSE_BACKEND")
    got = _run(capsys, strtonum.main, argv)
    want = _run(capsys, ref_strtonum.main, argv)
    assert got[0] == want[0] == 0
    assert "(native=yes)" in want[1] and "(route=native)" in got[1]
    strip = re.compile(r" \((route|native)=[^)]*\)")
    assert strip.sub("", got[1]) == strip.sub("", want[1])


def test_strtonum_fails_past_its_ulp_limit(capsys, monkeypatch):
    """A parse off by 3 ulp fails the default 1-ulp limit, as there."""
    from dmlc_tpu_torch.data import vparse

    real = vparse.parse_libsvm_vector

    def off(chunk, out, masks):
        real(chunk, out, masks)
        for v in out._value_parts:
            if v is not None:
                v.view(np.int32)[:] += 3

    monkeypatch.setattr(vparse, "parse_libsvm_vector", off)
    rc, _, err = _run(capsys, strtonum.main,
                      ["--n", "50", "--route", "python", "--device", "cpu"])
    assert rc == 1 and "3 ulp" in err


def _records(tmp_path):
    hist = []
    for i, v in enumerate((500.0, 510.0, 505.0)):
        p = tmp_path / f"BENCH_r{i:02d}.json"
        p.write_text(json.dumps({"metric": "higgs_libsvm_ingest",
                                 "value": v, "unit": "MB/s",
                                 "extra": {}}))
        hist.append(str(p))
    return hist


@pytest.mark.parametrize("fresh,rc", [(504.0, 0), (300.0, 1)])
def test_bench_gate(capsys, tmp_path, fresh, rc):
    _records(tmp_path)
    f = tmp_path / "fresh.json"
    f.write_text(json.dumps({"metric": "higgs_libsvm_ingest",
                             "value": fresh, "unit": "MB/s", "extra": {}}))
    argv = ["--fresh", str(f), "--history", str(tmp_path / "BENCH_r*.json")]
    got = _same(capsys, bench_gate.main, ref_bench_gate.main, argv)
    assert got[0] == rc


def test_bench_gate_smoke_and_advisory(capsys, tmp_path):
    got = _same(capsys, bench_gate.main, ref_bench_gate.main, ["--smoke"])
    assert got[0] == 0 and "--smoke OK" in got[1]
    f = tmp_path / "fresh.json"
    f.write_text(json.dumps({"metric": "m", "value": 1.0, "extra": {}}))
    got = _same(capsys, bench_gate.main, ref_bench_gate.main,
                ["--fresh", str(f), "--history", str(tmp_path / "none*")])
    assert got[0] == 0 and "ADVISORY" in got[1]
    assert tools.main(["bench_gate", "--smoke"]) == 0
    capsys.readouterr()


def test_audit_report(capsys, tmp_path, monkeypatch):
    from dmlc_tpu_torch.obs import audit

    monkeypatch.setenv("DMLC_TPU_SHUFFLE", "7")
    div = {"stage": "parse", "seq": 4, "scope": "cross-rank",
           "ours": "aa", "theirs": "bb", "against_rank": 0}
    chains = {"parse": [[s, "d%d" % s] for s in range(9)],
              "batch": [[s, "b%d" % s] for s in range(3)]}
    audit.write_bundle(1, div, chains, {"uri": "x.svm", "part": 1,
                                        "nparts": 2}, out_dir=str(tmp_path))
    got = _same(capsys, audit_report.main, ref_audit_report.main,
                [str(tmp_path)])
    assert got[0] == 1 and "stage=parse seq=4" in got[1]
    assert "DMLC_TPU_SHUFFLE=7" in got[1]
    empty = tmp_path / "empty"
    empty.mkdir()
    got = _same(capsys, audit_report.main, ref_audit_report.main,
                [str(empty)])
    assert got[0] == 2
    # the default directory is the flight recorder's
    monkeypatch.setenv("DMLC_TPU_FLIGHTREC", str(tmp_path))
    got = _same(capsys, audit_report.main, ref_audit_report.main, [])
    assert got[0] == 1

"""The port's command-line tools: ``python -m dmlc_tpu_torch.tools <cmd>``
over ``bake``, ``parity``, ``recordio`` and ``rowrec``, each run as a
subprocess on the CPU route, writes what the library call writes (and, for
``recordio``, what the JAX package's tool writes); a second ``bake`` of
the same source is skipped by its sidecar and a changed source bakes
again; a command the port lacks raises an error that names the ported
ones."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dmlc_tpu.tools import recordio as ref_recordio_tool
from dmlc_tpu_torch import tools
from dmlc_tpu_torch.data import convert_to_recordio
from dmlc_tpu_torch.tools.bake import bake_dataset
from dmlc_tpu_torch.utils import DMLCError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def python_stack(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_NATIVE", "0")


def _run(*args):
    """``python -m dmlc_tpu_torch.tools *args`` from the repo root."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.run(
        [sys.executable, "-m", "dmlc_tpu_torch.tools", *map(str, args)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def _libsvm(path, rows, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for i in range(rows):
            ids = np.sort(rng.choice(300, rng.randint(0, 9), False))
            fh.write(" ".join(["%d" % (i % 2)] + ["%d:%.4f" % (j, rng.rand())
                                                  for j in ids]) + "\n")
    return str(path)


@pytest.mark.parametrize("nparts", [1, 2])
def test_bake_cli_writes_what_the_library_writes(tmp_path, nparts):
    src = _libsvm(tmp_path / "src.svm", 1500, 1)
    cli_dst, lib_dst = tmp_path / "cli.dtsh", tmp_path / "lib.dtsh"
    out = _run("bake", src, cli_dst, "--nparts", nparts,
               "--rows-per-window", 100, "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "bake: 1500 rows -> %d shard file(s)" % nparts in out.stdout
    lib = bake_dataset(src, str(lib_dst), nparts=nparts, rows_per_window=100,
                       device="cpu")
    cli = json.loads((tmp_path / "cli.dtsh.bake.json").read_text())
    assert cli["sig"] == lib["sig"] and cli["rows"] == lib["rows"]
    for got, want in zip(cli["outputs"], lib["outputs"]):
        assert open(got["path"], "rb").read() \
            == open(want["path"], "rb").read()
    # the same source again: the sidecar skips the work
    again = _run("bake", src, cli_dst, "--nparts", nparts,
                 "--rows-per-window", 100, "--device", "cpu")
    assert again.returncode == 0 and "up to date" in again.stdout
    # a changed source bakes again
    with open(src, "a") as fh:
        fh.write("1 7:0.5\n")
    changed = _run("bake", src, cli_dst, "--nparts", nparts,
                   "--rows-per-window", 100, "--device", "cpu")
    assert changed.returncode == 0, changed.stderr
    assert "bake: 1501 rows" in changed.stdout
    # --force bakes even when nothing changed
    forced = bake_dataset(src, str(cli_dst), nparts=nparts,
                          rows_per_window=100, device="cpu", force=True)
    assert not forced["skipped"] and forced["rows"] == 1501


def test_recordio_cli_writes_the_reference_tools_file(tmp_path):
    out = _run("recordio", tmp_path / "port.rec", "--n", 120, "--nsplit", 5,
               "--seed", 3, "--write-index", tmp_path / "port.idx")
    assert out.returncode == 0, out.stderr
    assert "chunk read ok across 5 parts" in out.stdout
    assert "indexed read ok: 120 records" in out.stdout
    assert ref_recordio_tool.main([str(tmp_path / "ref.rec"), "--n", "120",
                                   "--nsplit", "5", "--seed", "3"]) == 0
    assert (tmp_path / "port.rec").read_bytes() \
        == (tmp_path / "ref.rec").read_bytes()


def test_rowrec_cli_writes_what_the_library_writes(tmp_path):
    src = _libsvm(tmp_path / "src.svm", 700, 6)
    out = _run("rowrec", "convert", src, tmp_path / "cli.rec",
               "--rows-per-group", 50, "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "converted 700 rows" in out.stdout
    convert_to_recordio(src, str(tmp_path / "lib.rec"), rows_per_group=50,
                        device="cpu")
    assert (tmp_path / "cli.rec").read_bytes() \
        == (tmp_path / "lib.rec").read_bytes()


def test_dispatcher_names_the_ported_commands(capsys):
    assert sorted(tools._COMMANDS) == ["bake", "filesys", "parity",
                                       "recordio", "rowrec"]
    assert tools.main(["--help"]) == 0
    assert "bake filesys parity recordio rowrec" in capsys.readouterr().out
    assert tools.main([]) == 2
    with pytest.raises(DMLCError,
                       match="bake filesys parity recordio rowrec"):
        tools.main(["split_read", "x"])
    out = _run("obs-report")
    assert out.returncode != 0
    assert "the port has: bake filesys parity recordio rowrec" in out.stderr


def test_parity_runs_through_the_dispatcher_and_its_module():
    out = _run("parity", "--help")
    assert out.returncode == 0, out.stderr
    assert "--single-backend" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_tpu_torch.tools.parity", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "--single-backend" in out.stdout

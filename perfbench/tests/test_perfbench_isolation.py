"""The benchmark stands apart: no module of it imports JAX or the JAX
package (top-level names compared whole), the references import nothing
of the program, and a cell, a configuration or a metric added as a new
file is found by its name with no edit."""

import ast
import json
import shutil
from pathlib import Path

import pytest

from perfbench.lib import bench

BENCH = bench.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "dmlc_tpu"}


def imported_roots(path: Path) -> set:
    """Top-level names of every module the file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            roots.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".", 1)[0])
    return roots


def sources(sub: str = ""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    roots = imported_roots(path)
    assert "dmlc_tpu_torch" not in roots and not roots & FORBIDDEN


def test_the_check_compares_whole_top_level_names():
    loaded = {"dmlc_tpu_torch": 1, "dmlc_tpu_torch.ops": 1, "jaxtyping": 1,
              "numpy": 1}
    assert bench.forbidden_loaded(loaded) == []
    loaded.update({"dmlc_tpu.models": 1, "jax": 1, "flax.linen": 1})
    assert bench.forbidden_loaded(loaded) == ["dmlc_tpu.models", "flax.linen",
                                              "jax"]


def test_the_import_scan_sees_each_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom dmlc_tpu import x\n"
                   "import dmlc_tpu_torch\n"
                   "importlib.import_module('flax.core')\n")
    assert imported_roots(src) == {"jax", "dmlc_tpu", "dmlc_tpu_torch",
                                   "flax"}


def test_every_named_file_exists():
    spec = bench.benchmark()
    for c in spec["configs"]:
        assert (bench.ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/configs/")
        cfg = bench.config(c["name"])
        assert all(k in cfg for k in c["reduced"])
    for w in spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell["config"] == w["config"]
        assert (BENCH / "jobs" / (cell["job"] + ".py")).is_file()
    for m in spec["per_layer"]:
        assert callable(bench.load_module("metrics", m["name"]).read)
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_new_cell_config_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = bench.benchmark()
    new_dir = root / "perfbench"
    (new_dir / "configs" / "tiny-fm.json").write_text(json.dumps(
        dict(bench.config("criteo-fm"), rows=4096)))
    (new_dir / "cells" / "tiny_fm.text.json").write_text(json.dumps(
        {"config": "tiny-fm", "job": "fm_fit",
         "traffic": {"format": "libfm", "parse_threads": 1},
         "why": "a new cell"}))
    (new_dir / "metrics" / "rows_read.fm.py").write_text(
        "def read(r):\n    return float(r['rows'])\n")
    spec["workloads"].append({"name": "tiny_fm.text", "config": "tiny-fm",
                              "traffic": "text", "chips": 1, "why": "new"})
    spec["per_layer"].append({"name": "rows_read.fm", "unit": "rows",
                              "better": "higher", "source": "host_clock",
                              "layer": "feed", "moves": "rows_per_s",
                              "workloads": ["tiny_fm.text"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    found = bench.benchmark(root)
    cell = bench.cell("tiny_fm.text", new_dir)
    assert bench.config(cell["config"], new_dir)["rows"] == 4096
    layer = bench.metrics_of(found, "per_layer", "tiny_fm.text")
    assert [m["name"] for m in layer] == ["rows_read.fm"]
    assert bench.load_module("metrics", "rows_read.fm", new_dir).read(
        {"rows": 7}) == 7.0
    e2e = bench.metrics_of(found, "end_to_end", "tiny_fm.text")
    assert [m["name"] for m in e2e] == ["setup_s"]
    # the cells already there keep their metrics
    assert "rows_read.fm" not in [m["name"] for m in bench.metrics_of(
        found, "per_layer", "criteo_fm.text")]

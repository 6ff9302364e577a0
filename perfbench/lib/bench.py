"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, ``perfbench/cells/<cell>.json``, ``perfbench/configs/
<config>.json``, ``perfbench/jobs/<job>.py`` and ``perfbench/metrics/
<metric>.py``. A new cell, configuration, job or metric is a new file;
nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

#: top-level module names that no process of the benchmark may hold:
#: the JAX stack and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dmlc_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """A cell's file, with its ``name`` added."""
    out = load_json(bench_dir / "cells" / (name + ".json"))
    out["name"] = name
    return out


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    out = load_json(bench_dir / "configs" / (name + ".json"))
    out["name"] = name
    return out


def load_module(kind: str, name: str,
                bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (the name may hold
    dots, so it is loaded by path)."""
    key = "perfbench_%s__%s" % (kind, name.replace(".", "_").replace(
        "-", "_"))
    if key in sys.modules:
        return sys.modules[key]
    path = bench_dir / kind / (name + ".py")
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def metrics_of(bench: dict, kind: str, cell_name: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports:
    those that list it under ``workloads``, or list no cells."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def forbidden_loaded(modules: Optional[Dict] = None) -> List[str]:
    """Names in ``sys.modules`` whose top-level name (the part before the
    first dot) is one of :data:`FORBIDDEN_MODULES`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in list(modules)
                  if name.split(".", 1)[0] in FORBIDDEN_MODULES)

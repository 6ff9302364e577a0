"""Every metric name the port registers follows the repo's naming rule and
is documented in docs/observability.md: the JAX package's lint
(``scripts/check_metric_names.py``: its call-site regex, unit suffixes and
documented-name scan, imported, not copied) applied to
``dmlc_tpu_torch/**/*.py``. So the port adds no metric name the reference
lacks."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _lint():
    spec = importlib.util.spec_from_file_location(
        "check_metric_names", ROOT / "scripts" / "check_metric_names.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_names():
    lint = _lint()
    out = {}
    for path in sorted((ROOT / "dmlc_tpu_torch").glob("**/*.py")):
        for kind, name in lint.CALL_RE.findall(path.read_text()):
            out.setdefault(name, []).append(
                (str(path.relative_to(ROOT)), kind))
    return out


NAMES = _port_names()


def test_the_port_registers_the_observability_layer():
    assert len(NAMES) >= 40
    for name in ("dmlc_feed_consume_ns", "dmlc_fit_steps_total",
                 "dmlc_xla_flops", "dmlc_device_hbm_bytes",
                 "dmlc_audit_digests_total", "dmlc_step_device_ms",
                 "dmlc_collective_op_ns", "dmlc_goodput_mfu_ratio"):
        assert name in NAMES, name


@pytest.mark.parametrize("name", sorted(NAMES))
def test_metric_name_is_well_formed_and_documented(name):
    lint = _lint()
    segs = name.split("_")
    assert segs[0] == "dmlc" and len(segs) >= 3, name
    assert segs[-1] in lint.UNITS, name
    if any(kind == "counter" for _path, kind in NAMES[name]):
        assert segs[-1] == "total", name
    assert name in lint.documented_names(), (name, NAMES[name])

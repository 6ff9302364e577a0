"""The PyTorch port stands alone: importing ``dmlc_tpu_torch`` and training
with it loads neither JAX nor any module of ``dmlc_tpu``, and its entry
points refuse to fall back to the CPU silently."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_FIT_AND_LIST_MODULES = """
import sys
import torch
import dmlc_tpu_torch
from dmlc_tpu_torch.models import LinearLearner
from dmlc_tpu_torch.ops import sequence_parallel as sp

for layout in ("dense", "csr"):
    history = LinearLearner(device="cpu", momentum=0.5).fit_uri(
        sys.argv[1], batch_size=4, epochs=2, layout=layout, num_features=8)
    assert len(history) == 2, history
attend = sp.make_ulysses_attention(local_attention=sp.make_flash_local(True))
q = torch.randn(1, 16, 4, 32, requires_grad=True)
kv = torch.randn(1, 16, 2, 32, requires_grad=True)
(attend(q, kv, kv) ** 2).sum().backward()
assert q.grad.shape == q.shape and kv.grad.shape == kv.shape
loaded = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "dmlc_tpu")
    or m.startswith(("jax.", "jaxlib.", "dmlc_tpu."))
)
print("LOADED", loaded)
"""


def test_import_and_cpu_fit_load_no_jax_and_no_reference(tmp_path):
    data = tmp_path / "tiny.svm"
    data.write_text("".join(
        f"{i % 2} 1:{i * 0.1:.2f} {2 + i % 5}:1.5 7:0.25\n" for i in range(11)
    ))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run(
        [sys.executable, "-c", _FIT_AND_LIST_MODULES, str(data)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_entry_points_without_cuda_raise(monkeypatch, tmp_path):
    from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
    from dmlc_tpu_torch.models import LinearLearner, init_linear_params
    from dmlc_tpu_torch.utils import DMLCError, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "one.svm"
    data.write_text("1 1:1\n")
    with pytest.raises(DMLCError, match="no CUDA device"):
        LinearLearner()
    with pytest.raises(DMLCError, match="no CUDA device"):
        LinearLearner(device="cuda")
    with pytest.raises(DMLCError, match="no CUDA device"):
        init_linear_params(3)
    with pytest.raises(DMLCError, match="no CUDA device"):
        DeviceFeed(str(data), BatchSpec(batch_size=2, num_features=2))
    assert resolve_device("cpu") == torch.device("cpu")
    assert LinearLearner(device="cpu").device == torch.device("cpu")


_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|dmlc_tpu)(?:\.|\s|,|$)",
    re.MULTILINE,
)


def _port_sources():
    files = sorted((ROOT / "dmlc_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_reference(path):
    text = path.read_text()
    assert not _FORBIDDEN_IMPORT.search(text), path
    assert "__import__(\"jax" not in text and "import_module(\"jax" not in text

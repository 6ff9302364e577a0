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
import dmlc_tpu_torch.data.row_iter
from dmlc_tpu_torch.data import create_row_block_iter
from dmlc_tpu_torch import collective
from dmlc_tpu_torch.data import PipelinedParser, create_parser
from dmlc_tpu_torch.io import fetch_ordered
from dmlc_tpu_torch.models import GBDTLearner, LinearLearner
from dmlc_tpu_torch.models import gbdt
from dmlc_tpu_torch.ops import sequence_parallel as sp
from dmlc_tpu_torch.tools import parity
from dmlc_tpu_torch.utils import prng
from dmlc_tpu_torch.parallel import distributed
from dmlc_tpu_torch.tracker import RabitTracker

# a world of one on the port's tracker and socket engine: the hostsync fit
tracker = RabitTracker("127.0.0.1", 1, port=21400, port_end=21500)
tracker.start()
collective.init("socket", tracker_uri="127.0.0.1", tracker_port=tracker.port)
assert collective.engine_kind() == "socket" and collective.world_size() == 1
for layout in ("dense", "csr"):
    for sync in ("spmd", "host"):
        learner = LinearLearner(device="cpu", sync=sync, momentum=0.5)
        history = learner.fit_uri(sys.argv[1], batch_size=4, epochs=2,
                                  layout=layout, num_features=8)
        assert len(history) == 2, history
learner.save(sys.argv[1] + ".model")
LinearLearner(device="cpu").load(sys.argv[1] + ".model")
# an elastic world-1 fit: rounds under run_with_recovery, a re-entry into
# generation 2, and the launcher's modules
import os
from dmlc_tpu_torch.data import reshard_split
from dmlc_tpu_torch.tracker import launchers, opts, submit
os.environ["DMLC_TPU_ELASTIC"] = "1"
def one_round():
    return LinearLearner(device="cpu", sync="host").fit_uri(
        sys.argv[1], batch_size=4, epochs=1, layout="csr", num_features=8)
assert len(collective.run_with_recovery(one_round)) == 1
assert not collective.elastic_sync()
assert collective.reenter_elastic() == 2 and collective.world_size() == 1
assert len(collective.run_with_recovery(one_round)) == 1
assert launchers.get_launcher("local").MAX_PREEMPT_RELAUNCHES > 0
collective.finalize()
tracker.thread.join(10)
tracker.close()
assert not tracker.alive()
assert distributed.process_count() == 1
parser = create_parser(sys.argv[1], nthread=2, device="cpu")
assert isinstance(parser, PipelinedParser) and sum(len(b) for b in parser) == 11
parser.close()
assert list(fetch_ordered(abs, [-1, -2])) == [1, 2]
it = create_row_block_iter(sys.argv[1] + "#" + sys.argv[1] + ".cache",
                           device="cpu")
assert sum(len(b) for b in it) == 11 and it.num_col() == 8
it.close()
gbdt_learner = GBDTLearner(device="cpu", num_trees=2, max_depth=2,
                           num_bins=4, subsample=0.5, colsample_bytree=0.5)
gbdt_learner.fit_uri(sys.argv[1], num_features=8)
gbdt_learner.save(sys.argv[1] + ".gbdt")
GBDTLearner(device="cpu").load(sys.argv[1] + ".gbdt")
assert prng.permutation(prng.PRNGKey(1), 5).shape == (5,)
assert parity._ulp_diff(gbdt.fit_bins([[0.0], [1.0]], 4),
                        gbdt.fit_bins([[0.0], [1.0]], 4)) == 0
attend = sp.make_ulysses_attention(local_attention=sp.make_flash_local(True))
q = torch.randn(1, 16, 4, 32, requires_grad=True)
kv = torch.randn(1, 16, 2, 32, requires_grad=True)
(attend(q, kv, kv) ** 2).sum().backward()
assert q.grad.shape == q.shape and kv.grad.shape == kv.shape
# factorization machines with a job snapshot, and the linear resume
from dmlc_tpu_torch import resilience
from dmlc_tpu_torch.collective import JobSnapshot, Snapshotter, load_snapshot
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.models import FMLearner
fm_learner = FMLearner(device="cpu", num_features=8, num_factors=2)
feed = DeviceFeed(create_parser(sys.argv[1], device="cpu"),
                  BatchSpec(batch_size=4, layout="csr", num_features=8),
                  device="cpu")
snapper = Snapshotter(JobSnapshot(sys.argv[1] + ".fmsnap"),
                      install_sigterm=False)
assert len(fm_learner.fit_feed(feed, 2, snapshotter=snapper)) == 2
snapper.close()
feed.close()
assert load_snapshot(JobSnapshot(sys.argv[1] + ".fmsnap"))[2]["epoch"] == 1
assert len(LinearLearner(device="cpu").fit_uri(
    sys.argv[1], batch_size=4, epochs=2, num_features=8,
    snapshot_uri=sys.argv[1] + ".snap", resume=True)) == 2
resilience.preempt.uninstall()
# the model-parallel layers at one rank, and the MoE-transformer example
from dmlc_tpu_torch.ops import moe, pipeline_parallel as pp
from dmlc_tpu_torch.examples import moe_transformer
params = moe.init_moe_params(4, 8, 16, device="cpu")
y, aux = moe.make_moe_layer(None, 4, capacity=6, top_k=2)(
    moe.shard_moe_params(params), torch.randn(1, 6, 8, requires_grad=True))
(y.square().sum() + aux).backward()
import numpy as np
stages = pp.pipeline_params_from_numpy({"w": np.full((1, 1, 1), 0.5)},
                                       device="cpu")
x = torch.ones(4, 1, requires_grad=True)
pp.make_pipeline(None, lambda p, a: a @ p["w"], 2)(
    pp.shard_pipeline_params(stages), x).sum().backward()
assert x.grad.tolist() == [[0.5]] * 4
assert moe_transformer.main(["--device", "cpu", "--world", "1"]) == 0
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
    from dmlc_tpu_torch.models import (GBDTLearner, LinearLearner,
                                       init_linear_params)
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
    with pytest.raises(DMLCError, match="no CUDA device"):
        GBDTLearner()
    assert resolve_device("cpu") == torch.device("cpu")
    assert LinearLearner(device="cpu").device == torch.device("cpu")
    assert GBDTLearner(device="cpu").device == torch.device("cpu")


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

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
parser = create_parser(sys.argv[1], nthread=2, device="cpu", threaded=False)
parser = PipelinedParser(parser, nthread=2)
assert sum(len(b) for b in parser) == 11
parser.close()
# the native core: built from the port's own sources, the native route
# and its batch staging, RecordIO through it
from dmlc_tpu_torch import native
from dmlc_tpu_torch.data.parsers import NativePipelineParser
assert "native/_build" in str(native.library_path())
assert native.simd_level() in (0, 2)
parser = create_parser(sys.argv[1], nthread=2, device="cpu")
assert isinstance(parser, NativePipelineParser)
assert sum(len(b) for b in parser) == 11
parser.before_first()
assert parser.read_batch_coo(16).num_rows == 11
parser.close()
assert native.recordio_unpack_chunk(
    native.recordio_pack_records([b"ab", b"cde"]))[0] == b"abcde"
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
# the binary formats: RecordIO row groups, a baked shard, the indexed,
# cached and shuffled splits, and a csr fit from each format
from dmlc_tpu_torch import tools
from dmlc_tpu_torch.data import convert_to_recordio
from dmlc_tpu_torch.io import build_index, create_input_split, shard
from dmlc_tpu_torch.tools import bake, recordio, rowrec
rec, dtsh = sys.argv[1] + ".rec", sys.argv[1] + ".dtsh"
assert convert_to_recordio(sys.argv[1], rec, device="cpu") == 11
assert build_index(rec, rec + ".idx") == 1
assert bake.bake_dataset(sys.argv[1], dtsh, device="cpu")["rows"] == 11
for uri in (rec + "?format=recordio", dtsh,
            dtsh + "?shuffle_chunks=1", sys.argv[1] + "?shuffle_chunks=1",
            sys.argv[1] + "#" + sys.argv[1] + ".chunks"):
    parser = create_parser(uri, device="cpu")
    assert sum(len(b) for b in parser) == 11, uri
    parser.close()
    assert len(LinearLearner(device="cpu").fit_uri(
        uri, batch_size=4, epochs=2, layout="csr", num_features=8)) == 2
split = create_input_split(rec, 0, 1, "indexed_recordio",
                           index_uri=rec + ".idx", shuffle=True)
assert len(list(split.records())) == 1
split.close()
assert shard.cache_token(dtsh, "shard")[0] == shard.SHARD_FORMAT_VERSION
assert sorted(tools._COMMANDS) == [
    "audit_report", "bake", "bench_gate", "dataiter", "dispatch", "filesys",
    "obs_report", "obs_top", "parity", "parse", "recordio", "rowrec",
    "serve", "split_read", "stream_read", "strtonum"]
# the remote filesystems: a parser read and a csr fit from a fake s3://,
# the fit's snapshot and the model written there too
import dmlc_tpu_torch.io.azure
import dmlc_tpu_torch.io.webhdfs
from dmlc_tpu_torch.io import filesystem, object_store, readahead
from dmlc_tpu_torch.resilience import hedge
from dmlc_tpu_torch.tools import filesys
root = os.path.dirname(os.path.dirname(os.path.abspath(
    dmlc_tpu_torch.__file__)))
sys.path.insert(0, os.path.join(root, "tests"))
import fake_object_store
server, store, base = fake_object_store.serve()
os.environ["S3_ENDPOINT"] = base
filesystem.register_filesystem("s3://", lambda uri: object_store.S3FileSystem())
with open(sys.argv[1], "rb") as fh:
    store.objects[("bkt", "tiny.svm")] = fh.read()
parser = create_parser("s3://bkt/tiny.svm", device="cpu")
assert sum(len(b) for b in parser) == 11
parser.close()
learner = LinearLearner(device="cpu")
assert len(learner.fit_uri("s3://bkt/tiny.svm", batch_size=4, epochs=2,
                           layout="csr", num_features=8,
                           snapshot_uri="s3://bkt/snap")) == 2
resilience.preempt.uninstall()
learner.save("s3://bkt/tiny.model")
assert ("bkt", "snap/LATEST") in store.objects
assert hedge.hedged_call(lambda: 3, 0.0) == 3
server.shutdown()
# the data service: a dispatcher, an in-process worker and a fleet-fed fit;
# the host modules of Parameter JSON, Config and the managed threads
from dmlc_tpu_torch.data import (BlockService, DataDispatcher,
                                 RemoteBlockParser, WorkerAutoscaler)
from dmlc_tpu_torch.io import json as dmlc_json
from dmlc_tpu_torch.params import Config
from dmlc_tpu_torch.tools import dispatch, serve
from dmlc_tpu_torch.utils import ThreadGroup, hash_combine
with DataDispatcher(sys.argv[1], nchunks=3) as disp:
    with BlockService(dispatcher=disp.address, nthread=1, device="cpu"):
        feed = DeviceFeed(RemoteBlockParser(disp.address, dispatcher=True,
                                            device="cpu"),
                          BatchSpec(batch_size=4, layout="csr",
                                    num_features=8), device="cpu")
        assert len(LinearLearner(device="cpu").fit_feed(feed)) == 1
        feed.close()
        assert disp.join(timeout=30)
assert dmlc_json.loads(dmlc_json.dumps({"a": [1]})) == {"a": [1]}
# the feed's producer thread and window, the tier-2 tools and the examples
from dmlc_tpu_torch.io import FixedMemoryStream, Serializable
from dmlc_tpu_torch.tools import (audit_report, bench_gate, dataiter, parse,
                                  split_read, stream_read, strtonum)
from dmlc_tpu_torch.examples import (boosted_trees, criteo_sparse,
                                     distributed_sgd, long_context,
                                     parameter)
feed = DeviceFeed(create_parser(sys.argv[1], device="cpu"),
                  BatchSpec(batch_size=4, layout="dense", num_features=8,
                            prefetch=2), device="cpu", host_prefetch=2)
assert len(LinearLearner(device="cpu").fit_feed(feed, epochs=2)) == 2
feed.close()
assert parse.main([sys.argv[1], "--device", "cpu"]) == 0
assert dataiter.main([sys.argv[1], "--batch-size", "4", "--device",
                      "cpu"]) == 0
assert split_read.main([sys.argv[1], "0", "1"]) == 0
assert strtonum.main(["--n", "200"]) == 0
assert strtonum.main(["--n", "200", "--route", "python", "--device",
                      "cpu"]) == 0
assert bench_gate.main(["--smoke"]) == 0
# the status plane armed: a tracker with its HTTP server, a csr fit that
# publishes at each epoch, the obs tools against the live server, a
# dispatcher behind a plane, every launcher and the shim
import urllib.request
from dmlc_tpu_torch.obs import plane
from dmlc_tpu_torch.tools import obs_report, obs_top
from dmlc_tpu_torch.tracker import PSTracker, shim
from dmlc_tpu_torch.tracker.launchers import (gpu, kubernetes, mesos, mpi,
                                              sge, slurm, ssh, yarn,
                                              yarn_controller)
os.environ["DMLC_TPU_STATUS_PORT"] = "0"
armed = RabitTracker("127.0.0.1", 1, port=21400, port_end=21500)
assert armed.status is not None
armed.start(1)
for key, value in armed.worker_envs().items():
    os.environ[key] = str(value)
os.environ["DMLC_TASK_ID"] = "0"
plane.reset_default_publisher()
assert len(LinearLearner(device="cpu").fit_uri(
    sys.argv[1], batch_size=4, epochs=2, layout="csr", num_features=8,
    part_index=0, num_parts=1)) == 2
import time
deadline = time.time() + 30  # the tracker acks a heartbeat, then reads it
while (armed.plane.workers().get("0", {}).get("payloads", 0) < 2
       and time.time() < deadline):
    time.sleep(0.05)
assert armed.plane.workers()["0"]["payloads"] == 2
status_uri = os.environ["DMLC_TPU_STATUS_URI"]
assert obs_top.main(["--once", "--status", status_uri]) == 0
assert obs_report.main(["--status", status_uri, "--top"]) == 0
with DataDispatcher(sys.argv[1], nchunks=3) as disp:
    armed.attach_data_dispatcher(disp)
    with urllib.request.urlopen("http://%s/data" % status_uri) as resp:
        assert b'"attached": true' in resp.read()
assert gpu.plan(opts.get_opts(["--cluster", "gpu", "-n", "1", "x"]), 1, 0,
                {})[0][3]["CUDA_VISIBLE_DEVICES"] == "0"
plane.reset_default_publisher()
armed.close()
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


_ARMED_FIT = """
import sys
import dmlc_tpu_torch.obs
from dmlc_tpu_torch import collective, obs
from dmlc_tpu_torch.models import GBDTLearner, LinearLearner
from dmlc_tpu_torch.models.fitloop import FitLoopObs
from dmlc_tpu_torch.obs import (aggregate, audit, device_telemetry,
                                exporters, flight, goodput, sentry,
                                watchdog, xla_cost)
collective.init()
for layout in ("dense", "csr"):
    LinearLearner(device="cpu").fit_uri(sys.argv[1], batch_size=4, epochs=2,
                                        layout=layout, num_features=8,
                                        log_every=1)
GBDTLearner(device="cpu", num_trees=2, max_depth=2,
            num_bins=4).fit_uri(sys.argv[1], num_features=8)
device_telemetry.sample()
device_telemetry.capture_profile(0.05, block=True)
assert xla_cost.probed_peak_flops() > 0
assert sentry.gate(sentry.record_values(sentry.smoke_degraded()),
                   sentry.metric_series(sentry.SMOKE_HISTORY))
assert audit.auditor().snapshot()["chains"]["model"] == 2
obs.flush_trace()
collective.finalize()
loaded = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "dmlc_tpu")
    or m.startswith(("jax.", "jaxlib.", "dmlc_tpu."))
)
print("LOADED", loaded)
"""


def test_fit_with_the_observability_layer_armed_loads_no_jax(tmp_path):
    """The subprocess fits again with every observability setting on: the
    layer's modules load neither JAX nor the reference package either."""
    data = tmp_path / "tiny.svm"
    data.write_text("".join(
        f"{i % 2} 1:{i * 0.1:.2f} {2 + i % 5}:1.5 7:0.25\n" for i in range(11)
    ))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update({
        "DMLC_TPU_METRICS": "1", "DMLC_TPU_DEVICE_TELEMETRY": "1",
        "DMLC_TPU_TRACE": str(tmp_path / "trace.json"),
        "DMLC_TPU_METRICS_EXPORT": str(tmp_path / "m.prom"),
        "DMLC_TPU_FLIGHTREC": str(tmp_path / "rec"),
        "DMLC_TPU_AUDIT": "full", "DMLC_TPU_STEP_SAMPLE_N": "1",
        "DMLC_TPU_HBM_POLL_S": "0.05",
    })
    out = subprocess.run(
        [sys.executable, "-c", _ARMED_FIT, str(data)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert (tmp_path / "trace.json").exists()
    assert "dmlc_fit_steps_total" in (tmp_path / "m.prom").read_text()
    assert list((tmp_path / "rec").glob("profile-rank0-req0/trace.json"))


_SERVE_WORKER = """
import sys
from dmlc_tpu_torch.tools import main
rc = main(["serve", "--dispatcher", sys.argv[1], "--host", "127.0.0.1",
           "--nthread", "1", "--grace", "10", "--device", "cpu"])
loaded = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "dmlc_tpu")
    or m.startswith(("jax.", "jaxlib.", "dmlc_tpu."))
)
print("LOADED", loaded, "RC", rc)
"""


def test_serve_worker_process_loads_no_jax(tmp_path):
    """A ``serve --dispatcher --device cpu`` worker process parses and
    serves a whole epoch for this process's dispatcher and consumer, and
    ends with neither JAX nor any ``dmlc_tpu`` module loaded."""
    import numpy as np

    from dmlc_tpu_torch.data import DataDispatcher, RemoteBlockParser

    data = tmp_path / "tiny.svm"
    data.write_text("".join(f"{i % 2} 1:{i}\n" for i in range(30)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    with DataDispatcher(str(data), nchunks=3) as disp:
        worker = subprocess.Popen(
            [sys.executable, "-c", _SERVE_WORKER, "%s:%d" % disp.address],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            assert worker.stdout.readline().startswith("serving ")
            parser = RemoteBlockParser(disp.address, dispatcher=True,
                                       device="cpu")
            vals = sorted(v for b in parser
                          for v in np.asarray(b.value).tolist())
            parser.close()
            assert disp.join(timeout=30)
            out, err = worker.communicate(timeout=120)
        finally:
            if worker.poll() is None:
                worker.kill()
    assert vals == [float(i) for i in range(30)]
    assert worker.returncode == 0, err
    assert "LOADED [] RC 0" in out, out + err


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


@pytest.mark.parametrize(
    "path", sorted((ROOT / "dmlc_tpu_torch" / "native" / "csrc").iterdir()),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_native_sources_stand_alone(path):
    """The port's C++ includes only its own headers (never ``cpp/``'s) and
    reads no environment; its build and bindings name no ``cpp/`` file."""
    text = path.read_text()
    for name in re.findall(r'#include\s+"([^"]+)"', text):
        assert (path.parent / name).exists(), (path, name)
    assert "getenv" not in text
    for py in ("_build.py", "__init__.py"):
        src = (ROOT / "dmlc_tpu_torch" / "native" / py).read_text()
        assert "libdmlc_tpu.so\"" not in src and "\"cpp\"" not in src

"""The port's launchers (``dmlc_tpu_torch/tracker/launchers``) and shim
held against the JAX package's on the CPU:

- ssh, mpi, sge, slurm, kubernetes, mesos and yarn plan the reference's
  argv, environment, scripts and manifests for the same options;
- yarn's retry policy and REST driver against a fake ResourceManager, and
  its blocking submission retried, as ``tests/test_launcher_controllers.py``
  drives the reference's;
- mesos's drive loop with a fake scheduler (real rank processes over the
  port's tracker), a failed launch, and pymesos missing;
- ``shim.main``: the SGE role, archives, the Hadoop library path;
- the GPU launcher's plan: the coordination triple, ``CUDA_VISIBLE_DEVICES``
  by host entry, a count mismatch and servers raising;
- a world-2 job over gloo through ``--cluster gpu`` with CPU ranks equal to
  the same job through ``--cluster local``;
- ``--cluster ssh`` with a fake ``ssh`` on PATH that runs the remote
  command on this host.

Trackers scan from 9091 up, as the other launcher tests' do.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from dmlc_tpu.tracker import opts as ref_opts
from dmlc_tpu.tracker.launchers import (
    kubernetes as ref_kube,
    mesos as ref_mesos,
    mpi as ref_mpi,
    sge as ref_sge,
    slurm as ref_slurm,
    ssh as ref_ssh,
    yarn as ref_yarn,
)
from dmlc_tpu_torch.tracker import opts, shim
from dmlc_tpu_torch.tracker.launchers import (
    gpu,
    kubernetes,
    mesos,
    mpi,
    sge,
    slurm,
    ssh,
    yarn,
    yarn_controller,
)
from dmlc_tpu_torch.utils.logging import DMLCError

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENVS = {"DMLC_TRACKER_URI": "10.0.0.1", "DMLC_TRACKER_PORT": 9091,
        "DMLC_NUM_WORKER": 2, "DMLC_NUM_SERVER": 1}


@pytest.fixture(autouse=True)
def _no_jax_env(monkeypatch):
    """The reference forwards JAX_PLATFORMS / XLA_FLAGS to its tasks, the
    port does not: unset here, the two plans must be equal."""
    for key in ("JAX_PLATFORMS", "XLA_FLAGS"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "3")


def both(argv):
    return opts.get_opts(argv), ref_opts.get_opts(argv)


@pytest.fixture()
def hostfile(tmp_path):
    path = tmp_path / "hosts"
    path.write_text("10.0.0.2\n10.0.0.3:2222\n# comment\n")
    return str(path)


@pytest.mark.parametrize("n,s,extra", [
    (2, 1, []), (3, 0, ["--sync-dst-dir", "/remote/job"]),
    (1, 2, ["--env", "A=1 2"])])
def test_ssh_plan_matches_reference(hostfile, n, s, extra):
    args, ref_args = both(["--cluster", "ssh", "-n", str(n), "-s", str(s),
                           "-H", hostfile, *extra, "./train", "--lr", "1"])
    got = ssh.plan(args, n, s, ENVS)
    assert got == ref_ssh.plan(ref_args, n, s, ENVS)
    assert [t[0] for t in got] == ["worker"] * n + ["server"] * s
    assert "export DMLC_JOB_CLUSTER=ssh;" in got[0][2][-1]
    assert ssh.parse_hostfile(hostfile) == ref_ssh.parse_hostfile(hostfile)
    assert ssh.sync_dir("/a", "h", 22, "/b") == ref_ssh.sync_dir("/a", "h",
                                                                 22, "/b")


@pytest.mark.parametrize("flavor", ["openmpi", "mpich"])
@pytest.mark.parametrize("n,s", [(3, 0), (2, 2)])
def test_mpi_plan_matches_reference(hostfile, flavor, n, s):
    args, ref_args = both(["--cluster", "mpi", "-n", str(n), "-s", str(s),
                           "-H", hostfile, "./train"])
    got = mpi.plan(args, n, s, ENVS, flavor=flavor)
    assert got == ref_mpi.plan(ref_args, n, s, ENVS, flavor=flavor)
    assert len(got) == 1 + (s > 0) and got[0][:3] == ["mpirun", "-n", str(n)]


@pytest.mark.parametrize("n,s,extra", [
    (4, 2, ["--slurm-worker-nodes", "2", "--worker-cores", "3"]),
    (2, 0, ["--worker-memory", "512m"]),
    (1, 1, ["--slurm-server-nodes", "1", "--server-memory", "2g"])])
def test_slurm_plan_matches_reference(n, s, extra):
    args, ref_args = both(["--cluster", "slurm", "-n", str(n), "-s", str(s),
                           *extra, "./train"])
    got = slurm.plan(args, n, s, ENVS)
    assert got == ref_slurm.plan(ref_args, n, s, ENVS)
    assert got[0][0] == "env" and f"--ntasks={n}" in got[0]


@pytest.mark.parametrize("n,s", [(2, 1), (3, 0)])
def test_sge_script_and_qsub_match_reference(n, s):
    env = {"DMLC_TRACKER_URI": "10.0.0.1", "A": "x y"}
    text = sge.plan_run_script(env, "./train --lr 1", n, s)
    assert text == ref_sge.plan_run_script(env, "./train --lr 1", n, s)
    assert "SGE_TASK_ID" in text and text.strip().endswith("./train --lr 1")
    for log_dir in (None, "/logs"):
        argv = sge.plan_qsub("rundmlc.sh", n + s, "gpuq", 2, log_dir, "j")
        assert argv == ref_sge.plan_qsub("rundmlc.sh", n + s, "gpuq", 2,
                                         log_dir, "j")


@pytest.mark.parametrize("n,s", [(2, 1), (4, 0)])
def test_kubernetes_manifests_match_reference(n, s):
    args, ref_args = both(["--cluster", "kubernetes", "-n", str(n), "-s",
                           str(s), "--jobname", "myjob", "--kube-namespace",
                           "ns1", "--max-attempts", "2", "./train"])
    got = kubernetes.plan(args, n, s, ENVS)
    assert got == ref_kube.plan(ref_args, n, s, ENVS)
    assert [m["kind"] for m in got] == (["Service", "Job"] if s else []) \
        + ["Job"]
    json.dumps(got)  # kubectl apply takes it as JSON


@pytest.mark.parametrize("n,s", [(2, 1), (3, 0)])
def test_mesos_plan_matches_reference(n, s):
    args, ref_args = both(["--cluster", "mesos", "-n", str(n), "-s", str(s),
                           "--mesos-master", "zk://m:5050", "--worker-cores",
                           "2", "--worker-memory", "1g", "./train"])
    got = mesos.plan(args, n, s, ENVS)
    assert got == ref_mesos.plan(ref_args, n, s, ENVS)
    assert got[0]["cpus"] == 2 and got[0]["mem_mb"] == 1024


@pytest.mark.parametrize("extra", [[], ["--archives", "a.zip", "--jobname",
                                        "j", "--queue", "q"]])
def test_yarn_plan_matches_reference(tmp_path, extra):
    script = tmp_path / "train.py"
    script.write_text("print(1)\n")
    args, ref_args = both(["--cluster", "yarn", "-n", "2", "-s", "1",
                           *extra, str(script), "--lr", "1"])
    got = yarn.plan_hadoop_jar(args, 2, 1, ENVS, "/tmp/am.jar")
    assert got == ref_yarn.plan_hadoop_jar(ref_args, 2, 1, ENVS,
                                           "/tmp/am.jar")
    assert got[:2] == ["hadoop", "jar"] and "python train.py" in got


# ---- yarn: the retry policy, the REST driver, the submission ------------

def test_yarn_retry_policy():
    ctl = yarn_controller.RetryController(num_tasks=2, max_attempt=2)
    assert ctl.pending() == [0, 1]
    ctl.assigned(0, "n1")
    ctl.assigned(1, "n2")
    ctl.completed(0, 0)
    ctl.completed(1, 1)
    assert not ctl.allowed_node("n2") and ctl.pending() == [1]
    ctl.check_healthy()
    ctl.assigned(1, "n3")
    ctl.completed(1, 1)
    assert ctl.aborted
    with pytest.raises(DMLCError, match="failed 2 times"):
        ctl.check_healthy()


def test_yarn_max_attempt_env_default(monkeypatch):
    monkeypatch.setenv("DMLC_MAX_ATTEMPT", "5")
    assert yarn_controller.default_max_attempt() == 5
    assert yarn_controller.RetryController(num_tasks=1).max_attempt == 5


class _FakeRM:
    """Minimal RM REST: /ws/v1/cluster/apps/{id}[/appattempts]."""

    def __init__(self):
        self.apps = {}
        self._id = 0

    def next_app(self, state, final, node):
        self._id += 1
        app_id = f"application_1_{self._id:04d}"
        self.apps[app_id] = {"state": state, "finalStatus": final,
                             "diagnostics": f"{app_id} {final}",
                             "node": node}
        return app_id

    def serve(self):
        rm = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                app = rm.apps.get(parts[4] if len(parts) > 4 else "")
                if app is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                if len(parts) > 5 and parts[5] == "appattempts":
                    body = {"appAttempts": {"appAttempt": [
                        {"nodeHttpAddress": app["node"]}]}}
                else:
                    body = {"app": app}
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, f"http://127.0.0.1:{server.server_address[1]}"


def test_yarn_rest_driver_retries_with_a_blacklist():
    rm = _FakeRM()
    server, url = rm.serve()
    outcomes = [("FAILED", "FAILED", "bad-1:8042"),
                ("FAILED", "FAILED", "bad-2:8042"),
                ("FINISHED", "SUCCEEDED", "good:8042")]
    seen = []

    def submit_fn(blacklist):
        seen.append(set(blacklist))
        return rm.next_app(*outcomes[len(seen) - 1])

    try:
        app_id = yarn_controller.drive_app(url, submit_fn, max_attempt=3,
                                           poll_interval_s=0.01)
        with pytest.raises(DMLCError, match="failed 2 times"):
            yarn_controller.drive_app(
                url, lambda bl: rm.next_app("KILLED", "KILLED", "n:1"),
                max_attempt=2, poll_interval_s=0.01)
    finally:
        server.shutdown()
        server.server_close()
    assert app_id.endswith("0003")
    assert seen == [set(), {"bad-1:8042"}, {"bad-1:8042", "bad-2:8042"}]


SOCKET_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    from dmlc_tpu_torch import collective
    collective.init()
    out = collective.allreduce(np.ones(3, dtype=np.float32))
    if len(sys.argv) > 1:  # a file a rank: lines on one pipe interleave
        with open(os.path.join(sys.argv[1], "rank%d" % collective.rank()),
                  "w") as fh:
            fh.write("%d %g %s" % (collective.world_size(), out[0],
                                   os.environ.get("DMLC_JOB_CLUSTER")))
    ok = float(out[0]) == collective.world_size()
    collective.finalize()
    sys.exit(0 if ok else 1)
""")


@pytest.fixture()
def socket_worker(tmp_path):
    path = tmp_path / "worker.py"
    path.write_text(SOCKET_WORKER.format(root=str(ROOT)))
    return str(path)


def test_yarn_submission_retries_then_succeeds(monkeypatch, tmp_path,
                                               socket_worker):
    calls = []
    real_check_call = subprocess.check_call

    def fake_check_call(argv):
        calls.append(argv)
        if len(calls) < 2:
            raise subprocess.CalledProcessError(1, argv)
        env = dict(os.environ)
        for pair in argv[argv.index("-env") + 1].split(","):
            k, _, v = pair.partition("=")
            env[k] = v
        env.update(DMLC_TASK_ID="0", DMLC_ROLE="worker")
        real_check_call([sys.executable, socket_worker], env=env)

    monkeypatch.setattr(yarn.subprocess, "check_call", fake_check_call)
    monkeypatch.setenv("DMLC_YARN_JAR", str(tmp_path / "dmlc.jar"))
    args = opts.get_opts(["--cluster", "yarn", "-n", "1", "--max-attempts",
                          "3", "--host-ip", "127.0.0.1", "echo", "hi"])
    yarn.submit(args)
    assert len(calls) == 2 and calls[0][:2] == ["hadoop", "jar"]


def test_yarn_needs_a_jar(monkeypatch):
    monkeypatch.delenv("DMLC_YARN_JAR", raising=False)
    args = opts.get_opts(["--cluster", "yarn", "-n", "1", "echo", "hi"])
    with pytest.raises(RuntimeError, match="ApplicationMaster jar"):
        yarn.submit(args)


# ---- mesos: the drive loop -----------------------------------------------

def test_mesos_drive_loop_with_a_fake_scheduler(socket_worker):
    args = opts.get_opts(["--cluster", "mesos", "-n", "2", "--mesos-master",
                          "127.0.0.1:5050", "--host-ip", "127.0.0.1",
                          sys.executable, socket_worker])
    launched = []

    def fake_runner(task):
        launched.append((task["role"], task["task_id"], task["cpus"]))
        env = {**os.environ, **{k: str(v) for k, v in task["env"].items()}}
        subprocess.check_call(task["command"], shell=True, env=env)

    mesos.submit(args, runner=fake_runner)
    assert sorted(launched) == [("worker", 0, 1), ("worker", 1, 1)]


def test_mesos_failed_launch_raises_and_master_required(monkeypatch):
    args = opts.get_opts(["--cluster", "mesos", "-n", "2", "--mesos-master",
                          "127.0.0.1:5050", "--host-ip", "127.0.0.1",
                          "echo", "hi"])

    def broken_runner(task):
        raise RuntimeError("no offers")

    with pytest.raises(RuntimeError, match="no offers"):
        mesos.submit(args, runner=broken_runner)
    monkeypatch.delenv("MESOS_MASTER", raising=False)
    with pytest.raises(ValueError, match="mesos-master"):
        mesos.submit(opts.get_opts(["--cluster", "mesos", "-n", "1", "echo",
                                    "hi"]), runner=lambda task: None)


def test_mesos_without_pymesos_raises(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pymesos(name, *a, **kw):
        if name.startswith("pymesos"):
            raise ImportError("no pymesos here")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pymesos)
    with pytest.raises(DMLCError, match="pymesos"):
        mesos._pick_runner()
    args = opts.get_opts(["--cluster", "mesos", "-n", "1", "--mesos-master",
                          "m:5050", "echo", "hi"])
    with pytest.raises(DMLCError, match="pymesos"):
        mesos.submit(args)


# ---- the shim ------------------------------------------------------------

@pytest.mark.parametrize("sge_id,slurm_id,want", [
    ("3", None, "server 0"), ("1", None, "worker 0"),
    (None, "1", "worker 1"), (None, "4", "server 2")])
def test_shim_derives_the_role(sge_id, slurm_id, want):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DMLC_ROLE", "DMLC_TASK_ID", "SGE_TASK_ID",
                        "SLURM_PROCID")}
    env.update(DMLC_NUM_WORKER="2", PYTHONPATH=str(ROOT))
    if sge_id:
        env["SGE_TASK_ID"] = sge_id
    if slurm_id:
        env["SLURM_PROCID"] = slurm_id
    cmd = ("python -c \"import os; print(os.environ['DMLC_ROLE'], "
           "os.environ['DMLC_TASK_ID'])\"")
    got = subprocess.run(
        [sys.executable, "-m", "dmlc_tpu_torch.tracker.shim", cmd],
        capture_output=True, text=True, timeout=60, cwd=ROOT, env=env)
    want_ref = subprocess.run(
        [sys.executable, "-m", "dmlc_tpu.tracker.shim", cmd],
        capture_output=True, text=True, timeout=60, cwd=ROOT, env=env)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == want_ref.stdout.strip() == want


def test_shim_unpacks_archives_and_extends_the_library_path(
        tmp_path, monkeypatch):
    with zipfile.ZipFile(tmp_path / "data.zip", "w") as zf:
        zf.writestr("inner.txt", "hello")
    hadoop = tmp_path / "hadoop"
    (hadoop / "lib" / "native").mkdir(parents=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DMLC_JOB_ARCHIVES", "hdfs://x/data.zip, ")
    monkeypatch.setenv("HADOOP_HOME", str(hadoop))
    monkeypatch.setenv("LD_LIBRARY_PATH", "/old")
    monkeypatch.setenv("DMLC_ROLE", "worker")
    monkeypatch.setenv("DMLC_TASK_ID", "0")
    assert shim.main(["test -f data/inner.txt && exit 3"]) == 3
    assert os.environ["LD_LIBRARY_PATH"] == f"{hadoop}/lib/native:/old"
    assert shim.main(["sh", "-c", "exit 4"]) == 4
    assert shim.main([]) == 2


# ---- the GPU launcher ----------------------------------------------------

def test_gpu_hosts_in_order_of_precedence(tmp_path):
    args = opts.get_opts(["--cluster", "gpu", "-n", "2", "--gpu-hosts",
                          "a, b", "./train"])
    assert gpu.discover_hosts(args) == [("a", 22), ("b", 22)]
    hosts = tmp_path / "hosts"
    hosts.write_text("c:2222\nc:2222\n")
    args = opts.get_opts(["--cluster", "gpu", "-n", "2", "-H", str(hosts),
                          "./train"])
    assert gpu.discover_hosts(args) == [("c", 2222), ("c", 2222)]
    args = opts.get_opts(["--cluster", "gpu", "-n", "1", "./train"])
    assert gpu.discover_hosts(args) == [("localhost", 22)]


@pytest.mark.parametrize("hosts,per_host,cards", [
    ("localhost,localhost", 1, ["0", "0"]),
    ("localhost,127.0.0.1,localhost", 2, ["0", "1", "0"]),
    ("a,b,a,a,b", 2, ["0", "0", "1", "0", "1"]),
    ("a,a,a,a", 4, ["0", "1", "2", "3"])])
def test_gpu_plan_exports_the_coordination_env(hosts, per_host, cards):
    n = len(hosts.split(","))
    args = opts.get_opts(["--cluster", "gpu", "-n", str(n), "--gpu-hosts",
                          hosts, "--gpus-per-host", str(per_host),
                          "--gpu-coordinator-port", "9999", "--env", "X=1",
                          "./train"])
    tasks = gpu.plan(args, n, 0, ENVS)
    first = hosts.split(",")[0]
    coord = "127.0.0.1" if first in gpu.LOCAL_HOSTS else first
    assert [t[3]["CUDA_VISIBLE_DEVICES"] for t in tasks] == cards
    for i, (host, port, tid, env, argv) in enumerate(tasks):
        assert tid == i and env["DMLC_TASK_ID"] == str(i)
        assert env["DMLC_TPU_COORDINATOR"] == f"{coord}:9999"
        assert env["DMLC_TPU_NUM_PROC"] == str(n)
        assert env["DMLC_TPU_PROC_ID"] == str(i)
        assert env["DMLC_JOB_CLUSTER"] == "gpu" and env["X"] == "1"
        if host in gpu.LOCAL_HOSTS:
            assert argv is None
        else:
            assert argv[0] == "ssh" and argv[-1].endswith("./train")
            assert f"export CUDA_VISIBLE_DEVICES={cards[i]};" in argv[-1]


def test_gpu_plan_refuses_a_mismatch_and_servers():
    args = opts.get_opts(["--cluster", "gpu", "-n", "3", "--gpu-hosts",
                          "a,b", "./train"])
    with pytest.raises(ValueError, match="one worker per card entry"):
        gpu.plan(args, 3, 0, ENVS)
    with pytest.raises(ValueError, match="parameter servers"):
        gpu.plan(args, 2, 1, ENVS)


GLOO_WORKER = textwrap.dedent("""
    import hashlib, os, sys
    sys.path.insert(0, {root!r})
    import torch.distributed as dist
    from dmlc_tpu_torch import collective
    from dmlc_tpu_torch.models import LinearLearner, params_to_numpy
    from dmlc_tpu_torch.parallel import distributed

    collective.init()  # the tracker's rendezvous (the control plane)
    rank = int(os.environ["DMLC_TASK_ID"])
    if os.environ.get("DMLC_TPU_COORDINATOR"):  # --cluster gpu
        assert distributed.initialize_from_env(backend="gloo", device="cpu")
    else:  # --cluster local: the same group through a file rendezvous
        distributed.initialize("file://" + sys.argv[2], 2, rank,
                               backend="gloo", device="cpu")
    assert dist.get_rank() == rank and dist.get_world_size() == 2
    learner = LinearLearner(device="cpu", group=dist.group.WORLD,
                            objective="logistic", learning_rate=0.5)
    learner.fit_uri(sys.argv[1], batch_size=16, epochs=2, layout="csr",
                    num_features=8, part_index=rank, num_parts=2,
                    drop_remainder=True)
    p = params_to_numpy(learner.params)
    # a file a rank: two ranks' lines on one pipe may interleave
    with open(sys.argv[2] + "-digest%d" % rank, "w") as fh:
        fh.write(os.environ["DMLC_JOB_CLUSTER"] + " " + hashlib.sha256(
            p["w"].tobytes() + p["b"].tobytes()).hexdigest())
    distributed.shutdown()
    collective.finalize()
""")


def _digests(prefix):
    return {r: tuple(pathlib.Path(f"{prefix}-digest{r}").read_text().split())
            for r in (0, 1)}


def test_world2_gloo_job_through_gpu_equals_local(tmp_path):
    data = tmp_path / "d.svm"
    data.write_text("".join(
        f"{i % 2} {1 + i % 7}:{(i % 5) * 0.25:.2f} 7:1.0\n"
        for i in range(140)))  # 69-71 rows a part: 4 full batches each
    script = tmp_path / "worker.py"
    script.write_text(GLOO_WORKER.format(root=str(ROOT)))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    runs = {}
    for cluster, extra in (("gpu", ["--gpu-hosts", "localhost,localhost",
                                     "--gpu-coordinator-port", "21930"]),
                           ("local", [])):
        proc = subprocess.run(
            [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit",
             "--cluster", cluster, "-n", "2", "--host-ip", "127.0.0.1",
             *extra, sys.executable, str(script), str(data),
             str(tmp_path / f"pg-{cluster}")],
            capture_output=True, text=True, timeout=180, cwd=ROOT, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        runs[cluster] = _digests(tmp_path / f"pg-{cluster}")
    assert sorted(runs["gpu"]) == [0, 1]
    assert {c for c, _ in runs["gpu"].values()} == {"gpu"}
    digests = {d for run in runs.values() for _, d in run.values()}
    assert len(digests) == 1, runs


FAKE_SSH = """#!/bin/bash
# a stand-in for ssh: skip the options, the port and the host, run the
# remote command string here
while [ $# -gt 1 ]; do
  case "$1" in
    -o|-p) shift 2 ;;
    *) shift ; break ;;
  esac
done
exec bash -c "$1"
"""


def test_ssh_cluster_with_a_fake_ssh(tmp_path, socket_worker):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "ssh"
    fake.write_text(FAKE_SSH)
    fake.chmod(0o755)
    hosts = tmp_path / "hosts"
    hosts.write_text("localhost\nlocalhost:2200\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit", "--cluster",
         "ssh", "-n", "2", "-H", str(hosts), "--host-ip", "127.0.0.1",
         sys.executable, socket_worker, str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for rank in (0, 1):
        assert (tmp_path / f"rank{rank}").read_text() == "2 2 ssh"

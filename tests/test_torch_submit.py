"""The port's launcher (``python -m dmlc_tpu_torch.tracker.submit``,
``tracker.opts``, ``tracker.launchers``) against the JAX package's
(``dmlc_tpu.tracker``):

- ``task_env`` gives the JAX package's env for a task, without the
  JAX-only forwarded settings;
- ``get_opts`` parses the ported options to the JAX package's values and
  defaults, and fails where it fails;
- a cluster that is not ported raises;
- a task that exits with ``EXIT_PREEMPTED`` (75) is relaunched without
  spending an attempt, up to ``MAX_PREEMPT_RELAUNCHES``;
- a warm spare the job never calls up exits 0.

The jobs here let the tracker scan for a free port from 9091 on.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from dmlc_tpu.tracker import opts as ref_opts
from dmlc_tpu.tracker.launchers import common as ref_common
from dmlc_tpu_torch.tracker import opts
from dmlc_tpu_torch.tracker.launchers import common, get_launcher, local
from dmlc_tpu_torch.tracker.submit import main
from dmlc_tpu_torch.utils.logging import DMLCError

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("extra,attempt", [(None, 0), ({"X": "1"}, 3)])
def test_task_env_matches_reference(monkeypatch, extra, attempt):
    for key in ("OMP_NUM_THREADS", "PYTHONPATH", "JAX_PLATFORMS",
                "XLA_FLAGS"):
        monkeypatch.setenv(key, f"v-{key}")
    base = {"DMLC_TRACKER_URI": "10.0.0.1", "DMLC_TRACKER_PORT": 9091,
            "DMLC_NUM_WORKER": 2}
    env = common.task_env(base, 1, "worker", "local", extra=extra,
                          attempt=attempt)
    ref = ref_common.task_env(base, 1, "worker", "local", extra=extra,
                              attempt=attempt)
    assert env == {k: v for k, v in ref.items()
                   if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    assert env["DMLC_TASK_ID"] == "1" and env["DMLC_ROLE"] == "worker"
    assert env["DMLC_JOB_CLUSTER"] == "local"
    assert env["DMLC_NUM_ATTEMPT"] == str(attempt)
    assert env["DMLC_TRACKER_PORT"] == "9091"
    assert env["OMP_NUM_THREADS"] == "v-OMP_NUM_THREADS"
    assert set(common.PASS_ENV_KEYS) == set(ref_common.PASS_ENV_KEYS) - {
        "JAX_PLATFORMS", "XLA_FLAGS"}


PORTED = ("cluster", "num_workers", "num_servers", "max_attempts",
          "host_ip", "spares", "elastic", "env", "env_map", "log_level",
          "log_file", "command")


@pytest.mark.parametrize("argv", [
    ["--cluster", "local", "-n", "2", "python", "train.py"],
    ["--cluster=local", "--num-workers", "3", "-s", "0", "--max-attempts",
     "2", "--host-ip", "127.0.0.1", "--spares", "1", "--elastic", "--env",
     "A=1", "--env", "B=x=y", "--log-level", "DEBUG", "--log-file",
     "t.log", "--", "python", "train.py", "--", "--lr", "0.1"],
    ["--cluster", "ssh", "-n", "1", "./run.sh", "--flag"],
])
def test_get_opts_matches_reference(argv):
    got = opts.get_opts(argv)
    want = ref_opts.get_opts(argv)
    for name in PORTED:
        assert getattr(got, name) == getattr(want, name), name


def test_get_opts_defaults_match_reference(monkeypatch):
    monkeypatch.setenv("DMLC_SUBMIT_CLUSTER", "local")
    got = opts.get_opts(["-n", "1", "cmd"])
    want = ref_opts.get_opts(["-n", "1", "cmd"])
    for name in PORTED:
        assert getattr(got, name) == getattr(want, name), name
    assert (got.cluster, got.num_servers, got.max_attempts, got.spares,
            got.elastic, got.log_level) == ("local", 0, None, 0, False,
                                            "INFO")
    assert opts.CLUSTERS == ref_opts.CLUSTERS


@pytest.mark.parametrize("argv,error", [
    (["--cluster", "local", "-n", "1"], ValueError),  # no command
    (["--cluster", "local", "-n", "1", "--env", "NOEQ", "cmd"], ValueError),
    (["--cluster", "local", "cmd"], SystemExit),  # no -n
    (["--cluster", "nowhere", "-n", "1", "cmd"], SystemExit),
    (["-n", "1", "cmd"], SystemExit),  # no cluster, no env default
])
def test_get_opts_errors_match_reference(monkeypatch, argv, error):
    monkeypatch.delenv("DMLC_SUBMIT_CLUSTER", raising=False)
    with pytest.raises(error):
        ref_opts.get_opts(argv)
    with pytest.raises(error):
        opts.get_opts(argv)


@pytest.mark.parametrize("cluster", ["ssh", "mpi", "slurm", "tpu"])
def test_cluster_not_ported_raises(cluster, capsys):
    with pytest.raises(ValueError, match="not ported"):
        get_launcher(cluster)
    with pytest.raises(SystemExit) as exc:
        main(["--cluster", cluster, "-n", "1", "true"])
    assert exc.value.code == 2
    assert "not ported" in capsys.readouterr().err
    assert get_launcher("local") is local


def test_parameter_servers_are_not_ported():
    args = opts.get_opts(["--cluster", "local", "-n", "1", "-s", "1",
                          "true"])
    with pytest.raises(DMLCError, match="PS scheduler"):
        local.submit(args)


# a worker that exits 75 (preempted) until its count file has N lines,
# then joins the job; with a third argument it finishes only once that
# many processes are about to join (a spare parks right after)
WORKER = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, {root!r})
    count, needed = sys.argv[1], int(sys.argv[2])
    with open(count, "a") as fh:
        fh.write(os.environ["DMLC_NUM_ATTEMPT"] + "\\n")
    with open(count) as fh:
        runs = len(fh.readlines())
    if runs <= needed:
        sys.exit(75)
    from dmlc_tpu_torch import collective
    with open(count + ".ready", "a") as fh:
        fh.write("ready\\n")
    collective.init()
    print("WORKER", collective.rank(), "of", collective.world_size(),
          "spare" if os.environ.get("DMLC_TPU_SPARE") else "", flush=True)
    if len(sys.argv) > 3:
        deadline = time.time() + 60
        while time.time() < deadline:
            with open(count + ".ready") as fh:
                if len(fh.readlines()) >= int(sys.argv[3]):
                    break
            time.sleep(0.05)
        time.sleep(1.0)  # from its line to its join: a few calls
    collective.finalize()
""")


def _worker(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(root=str(ROOT)))
    return script


def test_preempted_task_relaunches_without_spending_an_attempt(tmp_path,
                                                                capfd):
    count = tmp_path / "count"
    args = opts.get_opts(["--cluster", "local", "-n", "1",
                          "--max-attempts", "1", "--host-ip", "127.0.0.1",
                          sys.executable, str(_worker(tmp_path)),
                          str(count), "2"])
    local.submit(args)
    # two preemptions relaunched on attempt 0, then the run that finished
    assert count.read_text().split() == ["0", "0", "0"]
    out = capfd.readouterr().out
    assert out.count("preempted (exit 75)") == 2
    assert "WORKER 0 of 1" in out


def test_preempt_relaunches_stop_at_the_cap(tmp_path, monkeypatch, capfd):
    monkeypatch.setattr(local, "MAX_PREEMPT_RELAUNCHES", 2)
    count = tmp_path / "count"
    args = opts.get_opts(["--cluster", "local", "-n", "1",
                          "--max-attempts", "2", "--host-ip", "127.0.0.1",
                          sys.executable, str(_worker(tmp_path)),
                          str(count), "100"])
    # the task never reaches rendezvous: once it is gone the job fails
    with pytest.raises(DMLCError, match="waiting for rendezvous"):
        local.submit(args)
    # 2 relaunches spend nothing; then each of the 2 attempts exits 75
    # past the cap and is spent
    assert count.read_text().split() == ["0", "0", "0", "1"]
    assert capfd.readouterr().out.count("preempted (exit 75)") == 2


def test_spare_never_called_up_exits_zero(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit", "--cluster",
         "local", "-n", "1", "--spares", "1", "--max-attempts", "2",
         "--host-ip", "127.0.0.1", sys.executable, str(_worker(tmp_path)),
         str(tmp_path / "count"), "0", "2"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "WORKER 0 of 1" in proc.stdout
    assert "spare" not in proc.stdout  # the spare never joined
    assert "never activated" in out
    assert "exited" not in out  # the spare spent no attempt
    assert "events=rebuild,join" in out or "events=join,rebuild" in out

"""The port's launcher (``python -m dmlc_tpu_torch.tracker.submit``,
``tracker.opts``, ``tracker.launchers``) against the JAX package's
(``dmlc_tpu.tracker``):

- ``task_env`` gives the JAX package's env for a task, without the
  JAX-only forwarded settings;
- ``get_opts`` parses the options to the JAX package's values and
  defaults, and fails where it fails; ``build_parser`` has every flag of
  the reference's under the same name and default, but the ``tpu`` names,
  which are ``gpu`` here; ``get_memory_mb`` and ``get_cache_file_set``;
- every cluster of ``CLUSTERS`` has a launcher, an unknown one raises;
- ``--status-port`` arms the tracker's status plane;
- parameter servers run under ``PSTracker``: its scheduler command, the
  workers' env, and the fail-fast when every worker died;
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
    assert opts.CLUSTERS == tuple("gpu" if c == "tpu" else c
                                  for c in ref_opts.CLUSTERS)


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
    """Every cluster of ``CLUSTERS`` is ported now; the JAX package's
    ``tpu`` is the one name the port does not know (its ``gpu``)."""
    if cluster == "tpu":
        with pytest.raises(ValueError, match="unknown cluster"):
            get_launcher(cluster)
        with pytest.raises(SystemExit) as exc:
            main(["--cluster", cluster, "-n", "1", "true"])
        assert exc.value.code == 2
        assert "invalid choice: 'tpu'" in capsys.readouterr().err
    else:
        mod = get_launcher(cluster)
        assert mod.__name__ == f"dmlc_tpu_torch.tracker.launchers.{cluster}"
        assert callable(mod.submit)
    assert get_launcher("local") is local
    assert [get_launcher(c).__name__.rsplit(".", 1)[1]
            for c in opts.CLUSTERS] == list(opts.CLUSTERS)


def test_parameter_servers_are_not_ported(tmp_path):
    """``-s`` > 0 now runs under ``PSTracker``: with no scheduler command
    the local launcher starts the workers and the servers with the PS
    env (no rabit tracker), each with its role and id."""
    out = tmp_path / "roles"
    args = opts.get_opts([
        "--cluster", "local", "-n", "2", "-s", "1", "--host-ip",
        "127.0.0.1", "sh", "-c",
        f"'echo $DMLC_ROLE $DMLC_TASK_ID $DMLC_NUM_SERVER "
        f"${{DMLC_TRACKER_URI:-none}} >> {out}'"])
    local.submit(args)
    assert sorted(out.read_text().splitlines()) == [
        "server 0 1 none", "worker 0 1 none", "worker 1 1 none"]


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


def _flags(parser):
    """option string -> (dest, default, choices) of every optional flag."""
    return {o: (a.dest, a.default, a.choices)
            for a in parser._actions for o in a.option_strings
            if o not in ("-h", "--help")}


def test_build_parser_matches_the_reference_but_the_gpu_names():
    got, want = _flags(opts.build_parser()), _flags(ref_opts.build_parser())
    renamed = {"--tpu-hosts": "--gpu-hosts",
               "--tpu-coordinator-port": "--gpu-coordinator-port"}
    for flag, (dest, default, choices) in want.items():
        port_flag = renamed.get(flag, flag)
        assert port_flag in got, flag
        gdest, gdefault, gchoices = got[port_flag]
        assert gdefault == default, flag
        if flag == "--cluster":
            assert list(gchoices) == ["gpu" if c == "tpu" else c
                                      for c in choices]
        else:
            assert gchoices == choices, flag
            assert gdest == dest.replace("tpu_", "gpu_"), flag
    # the one flag of the port's own: the card a host entry sees
    assert set(got) - {renamed.get(f, f) for f in want} \
        == {"--gpus-per-host"}
    assert got["--gpus-per-host"][1] == 1
    assert got["--gpu-coordinator-port"][1] == 8476


@pytest.mark.parametrize("text,mb", [("1g", 1024), ("512m", 512),
                                      ("2048", 2048), ("1.5g", 1536),
                                      (" 3G ", 3072)])
def test_get_memory_mb_matches_reference(text, mb):
    assert opts.get_memory_mb(text) == ref_opts.get_memory_mb(text) == mb


@pytest.mark.parametrize("auto", ["1", "0"])
def test_get_cache_file_set_matches_reference(tmp_path, auto):
    script = tmp_path / "train.py"
    script.write_text("print('hi')\n")
    data = tmp_path / "data.txt"
    data.write_text("x\n")
    argv = ["--cluster", "yarn", "-n", "1", "--auto-file-cache", auto,
            "--files", "extra.cfg", str(script), str(data), "--lr=1",
            str(tmp_path)]
    got = opts.get_cache_file_set(opts.get_opts(argv))
    want = ref_opts.get_cache_file_set(ref_opts.get_opts(argv))
    assert got == want
    if auto == "1":
        assert got[1] == ["python train.py", "./data.txt", "--lr=1",
                          str(tmp_path)]
        assert got[0] == {"extra.cfg", str(script), str(data)}


def test_status_port_arms_the_tracker(tmp_path, monkeypatch):
    """``--status-port`` sets DMLC_TPU_STATUS_PORT for the tracker, which
    then advertises the status server to its workers."""
    from dmlc_tpu_torch.tracker import submit as submit_mod

    # set, then unset: the monkeypatch restores the variable's absence
    # after submit() sets it
    monkeypatch.setenv("DMLC_TPU_STATUS_PORT", "-1")
    monkeypatch.delenv("DMLC_TPU_STATUS_PORT")
    out = tmp_path / "env"
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {str(ROOT)!r})
        from dmlc_tpu_torch import collective
        collective.init()
        with open({str(out)!r}, "w") as fh:
            fh.write(os.environ["DMLC_TPU_STATUS_URI"] + " "
                     + os.environ["DMLC_TPU_OBS_PUBLISH"])
        collective.finalize()
    """))
    args = opts.get_opts(["--cluster", "local", "-n", "1", "--host-ip",
                          "127.0.0.1", "--status-port", "0",
                          sys.executable, str(script)])
    assert args.status_port == 0
    submit_mod.submit(args)
    assert os.environ["DMLC_TPU_STATUS_PORT"] == "0"
    uri, publish = out.read_text().split()
    assert uri.startswith("127.0.0.1:") and int(uri.split(":")[1]) > 0
    assert publish == "1"


def test_ps_tracker_runs_the_scheduler_and_fails_fast(tmp_path):
    from dmlc_tpu_torch.tracker.rendezvous import (PSTracker,
                                                    submit_with_tracker)

    out = tmp_path / "sched"
    seen = {}

    def fun_submit(nworker, nserver, envs):
        seen.update(envs, n=(nworker, nserver))

    submit_with_tracker(
        1, 1, fun_submit, host_ip="127.0.0.1",
        # a scheduler that runs until its workers have been launched
        # (submit_with_tracker launches them only while it is alive)
        pscmd=f"echo $DMLC_ROLE $DMLC_PS_ROOT_URI $DMLC_PS_ROOT_PORT "
              f"$DMLC_NUM_WORKER > {out}; sleep 1")
    role, uri, port, nworker = out.read_text().split()
    assert (role, uri, nworker) == ("scheduler", "127.0.0.1", "1")
    assert seen["DMLC_PS_ROOT_URI"] == "127.0.0.1"
    assert seen["DMLC_PS_ROOT_PORT"] == int(port)
    assert seen["n"] == (1, 1) and seen["DMLC_NUM_SERVER"] == 1
    # a scheduler that outlives every worker: the job fails fast
    ps = PSTracker("127.0.0.1", "sleep 3", port=21960, port_end=21980)
    assert ps.alive()
    assert ps.worker_envs()["DMLC_PS_ROOT_PORT"] in range(21960, 21980)
    with pytest.raises(DMLCError, match="scheduler is still running"):
        ps.join(tasks_alive=lambda: False, grace_s=0.2)
    ps.join()  # the scheduler's own end
    assert PSTracker("127.0.0.1", None).worker_envs() == {}

"""The port's examples (``dmlc_tpu_torch/examples``) against the JAX
package's (``examples/*.py`` under ``JAX_PLATFORMS=cpu``) on the same
seeded data: the same printed lines, with the seconds and MB/s taken
out. Losses printed to 4 decimals (GBDT) and the host SGD's float64
losses must match as printed; the csr fit's f32 losses to rtol 1e-5 (its
sums run in another f32 order: torch's CPU index_add_ and XLA's
scatter). The distributed run's losses equal the single process's."""

import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
       "DMLC_TPU_PARSE_BACKEND": "vector", "DMLC_TPU_NATIVE": "0"}


def _ref(script, *args, extra_env=None, timeout=280):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script)]
        + [str(a) for a in args], capture_output=True, text=True,
        timeout=timeout, env={**ENV, **(extra_env or {})})
    return out


def _port(module, *args, timeout=280):
    return subprocess.run(
        [sys.executable, "-m", f"dmlc_tpu_torch.examples.{module}"]
        + [str(a) for a in args], capture_output=True, text=True,
        timeout=timeout, env=ENV, cwd=REPO)


def _untimed(text):
    """Lines without the seconds, MB/s and log prefixes."""
    out = []
    for line in text.splitlines():
        line = re.sub(r"^\[[0-9:]+\] \w+ \S+: ", "", line)
        line = re.sub(r"^\d{4}-\d\d-\d\d [0-9:,]+ ", "", line)
        line = re.sub(r" fit [0-9.]+s", " fit Ts", line)
        line = re.sub(r"\d+ steps, [0-9.]+s(, \d+ MB/s)?", "steps", line)
        out.append(line)
    return out


class TestParameter:
    @pytest.mark.parametrize("args", [
        ["num_hidden=100", "name=aaa", "activation=relu"],
        ["nhidden=7", "act=sigmoid", "learning_rate=0.5"],
        [],  # the usage and the generated docstring
    ])
    def test_same_stdout(self, args, capsys):
        from dmlc_tpu_torch.examples import parameter

        rc = parameter.main(args)
        got = capsys.readouterr().out
        want = _ref("parameter.py", *args)
        assert rc == want.returncode
        assert got == want.stdout

    def test_constraint_error(self, capsys):
        from dmlc_tpu_torch.examples import parameter

        assert parameter.main(["num_hidden=100", "activation=tanh"]) == 1
        err = capsys.readouterr().err
        assert "relu" in err
        want = _ref("parameter.py", "num_hidden=100", "activation=tanh")
        assert want.returncode == 1 and "relu" in want.stderr
        assert parameter.main(["num_hidden=-1"]) == 1


def _losses(text):
    return [float(m) for m in re.findall(r"loss (\d+\.\d+)", text)]


class TestCriteoSparse:
    def test_synthetic_matches_the_reference(self, tmp_path, monkeypatch,
                                             capsys):
        """The seeded 20,000-row file, written by the port and read by
        both (the same bytes either would write)."""
        from dmlc_tpu_torch.examples import criteo_sparse

        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        assert criteo_sparse.main(["--synthetic", "--device", "cpu"]) == 0
        got = capsys.readouterr().out
        want = _ref("criteo_sparse.py", "--synthetic",
                    extra_env={"TMPDIR": str(tmp_path)})
        assert want.returncode == 0, want.stderr[-800:]
        assert "3 steps" in got
        g, w = _losses(got), _losses(want.stdout)
        assert len(g) == 2 and g[1] < g[0]
        np.testing.assert_allclose(g, w, rtol=1e-5)
        gl = [ln for ln in _untimed(got) if not ln.startswith("epoch")]
        wl = [ln for ln in _untimed(want.stdout) if not ln.startswith("epoch")]
        assert gl == wl  # the data path and the touched-weight count

    def test_recordio_input(self, tmp_path, capsys):
        from dmlc_tpu.data.rowrec import convert_to_recordio

        from dmlc_tpu_torch.examples import criteo_sparse

        svm = tmp_path / "c.svm"
        rng = np.random.RandomState(5)
        with open(svm, "w") as fh:
            for i in range(3000):
                ids = sorted(rng.choice(1 << 16, size=8, replace=False))
                fh.write("%d %s\n" % (i % 2, " ".join(
                    f"{j}:{rng.rand():.4f}" for j in ids)))
        rec = tmp_path / "c.rec"
        convert_to_recordio(str(svm), str(rec), rows_per_group=512)
        args = [str(rec), "--format", "recordio", "--num-features",
                str((1 << 16) + 1), "--batch-size", "1024",
                "--nnz-bucket", "16384", "--epochs", "2"]
        assert criteo_sparse.main(args + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        want = _ref("criteo_sparse.py", *args)
        assert want.returncode == 0, want.stderr[-800:]
        np.testing.assert_allclose(_losses(got), _losses(want.stdout),
                                   rtol=1e-5)
        assert _untimed(got)[-1] == _untimed(want.stdout)[-1]


class TestBoostedTrees:
    @pytest.mark.parametrize("args", [
        ["--synthetic", "--num-trees", "8", "--max-depth", "4"],
        ["--synthetic", "--objective", "softmax", "--num-trees", "6",
         "--max-depth", "4"],
        ["--synthetic", "--objective", "squared", "--num-trees", "5",
         "--max-depth", "3"],
        ["--synthetic", "--num-trees", "8", "--max-depth", "4", "--dp",
         "2"],
    ], ids=["logistic", "softmax", "squared", "dp2"])
    def test_same_line_as_the_reference(self, args):
        got = _port("boosted_trees", *args, "--device", "cpu")
        # the reference's --dp N takes a mesh of exactly N devices
        want = _ref("boosted_trees.py", *args, extra_env={
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
        assert got.returncode == 0, got.stderr[-800:]
        assert want.returncode == 0, want.stderr[-800:]
        assert _untimed(got.stdout) == _untimed(want.stdout)
        assert "train-acc" in got.stdout

    def test_libsvm_uri_input(self, tmp_path, capsys):
        from dmlc_tpu_torch.examples import boosted_trees

        svm = tmp_path / "g.svm"
        rng = np.random.RandomState(9)
        with open(svm, "w") as fh:
            for _ in range(2000):
                vals = rng.rand(6)
                fh.write("%d %s\n" % (int(vals[0] > 0.5), " ".join(
                    f"{j}:{vals[j]:.4f}" for j in range(6))))
        args = [str(svm), "--num-features", "6", "--num-trees", "10",
                "--max-depth", "3"]
        assert boosted_trees.main(args + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        want = _ref("boosted_trees.py", *args)
        assert want.returncode == 0, want.stderr[-800:]
        assert _untimed(got) == _untimed(want.stdout)


class TestDistributedSGD:
    @pytest.fixture()
    def data(self, tmp_path):
        rng = np.random.RandomState(1)
        path = tmp_path / "toy.svm"
        with open(path, "w") as f:
            for _ in range(400):
                x = rng.rand(5)
                y = 1 if x.sum() > 2.5 else 0
                f.write(f"{y} " + " ".join(
                    f"{j + 1}:{x[j]:.4f}" for j in range(5)) + "\n")
        return str(path)

    @staticmethod
    def _losses(text):
        return [ln.split("epoch", 1)[1] for ln in text.splitlines()
                if "loss=" in ln]

    def test_single_process_matches_the_reference(self, data):
        got = _port("distributed_sgd", data, "--epochs", "3", "--device",
                    "cpu")
        want = _ref("distributed_sgd.py", data, "--epochs", "3")
        assert got.returncode == 0, got.stderr[-800:]
        ls = self._losses(got.stdout + got.stderr)
        assert len(ls) == 3
        assert ls == self._losses(want.stdout + want.stderr)

    def test_local_cluster_matches_single_process(self, data):
        single = _port("distributed_sgd", data, "--epochs", "2",
                       "--device", "cpu")
        multi = subprocess.run(
            [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit",
             "--cluster", "local", "-n", "2", "--host-ip", "127.0.0.1",
             sys.executable, "-m", "dmlc_tpu_torch.examples.distributed_sgd",
             data, "--epochs", "2", "--device", "cpu"],
            capture_output=True, text=True, timeout=180, env=ENV, cwd=REPO)
        assert multi.returncode == 0, multi.stderr[-800:]
        ls = self._losses(single.stdout + single.stderr)
        lm = self._losses(multi.stdout + multi.stderr)
        assert len(ls) == 2 and ls == lm, (ls, lm)

    def test_shuffle_visits_every_example(self, data):
        got = _port("distributed_sgd", data, "--epochs", "2", "--shuffle",
                    "42", "--device", "cpu")
        assert got.returncode == 0, got.stderr[-800:]
        assert (got.stdout + got.stderr).count("examples=400") == 2


class TestLongContext:
    @pytest.mark.parametrize("kv_heads", ["8", "2"])
    def test_same_schedules_as_the_reference(self, kv_heads, capsys):
        """At one rank, as the reference at one device: every schedule
        it reports is reported, within its 1e-3, plus the flash route."""
        from dmlc_tpu_torch.examples import long_context

        args = ["--seq", "128", "--heads", "8", "--kv-heads", kv_heads]
        assert long_context.main(args + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        want = _ref("long_context.py", *args, extra_env={
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1"})
        assert want.returncode == 0, want.stderr[-800:]

        def names(text):
            return [re.sub(r"max\|Δ\|.*(ok|MISMATCH)$", r"\1", ln).strip()
                    for ln in text.splitlines() if ln.startswith("  ")]

        port_names = names(got)
        assert port_names[:len(names(want.stdout))] == names(want.stdout)
        flash = port_names[-1]
        assert flash.startswith("ulysses all-to-all + flash kernels")
        assert flash.endswith("ok")
        assert got.splitlines()[1:2] == want.stdout.splitlines()[1:2]
        assert "all schedules match exact attention" in got

    @pytest.mark.parametrize("kv_heads", ["8", "2"])
    def test_outputs_equal_the_references_exact_attention(
            self, kv_heads, monkeypatch, capsys):
        """The example draws the reference's inputs (``RandomState(0)``)
        and every attention it computes (exact, ring, zigzag, sliding
        window, Ulysses, Ulysses over the flash route) is the JAX
        package's ``full_attention`` of the same variant on those inputs,
        within atol 1e-5."""
        import jax.numpy as jnp
        import torch

        from dmlc_tpu.ops import full_attention as ref_full_attention
        from dmlc_tpu_torch import ops
        from dmlc_tpu_torch.examples import long_context

        seen = []  # (variant kwargs, q, k, v, output)

        def recorded(fn, variant):
            def call(q, k, v, *a, **kw):
                out = fn(q, k, v, *a, **kw)
                seen.append((variant or kw, q, k, v, out))
                return out
            return call

        real = {name: getattr(ops, name) for name in (
            "full_attention", "make_ring_attention", "zigzag_unshard",
            "make_ulysses_attention")}
        monkeypatch.setattr(ops, "full_attention",
                            recorded(real["full_attention"], None))
        monkeypatch.setattr(ops, "make_ring_attention", lambda g, **kw: (
            real["make_ring_attention"](g, **kw) if kw.get("layout")
            else recorded(real["make_ring_attention"](g, **kw), kw)))
        monkeypatch.setattr(ops, "make_ulysses_attention", lambda g, **kw:
                            recorded(real["make_ulysses_attention"](g, **kw),
                                     {"causal": False}))
        unshard = []
        monkeypatch.setattr(ops, "zigzag_unshard", lambda x, n: unshard.append(
            real["zigzag_unshard"](x, n)) or unshard[-1])

        t, heads, kvh, d = 128, 8, int(kv_heads), 32
        args = ["--seq", str(t), "--heads", str(heads), "--kv-heads",
                kv_heads, "--head-dim", str(d)]
        assert long_context.main(args + ["--device", "cpu"]) == 0
        assert "all schedules match exact attention" in capsys.readouterr().out
        rng = np.random.RandomState(0)
        q, k, v = (rng.randn(1, t, h, d).astype(np.float32)
                   for h in (heads, kvh, kvh))
        assert len(seen) == 7 and len(unshard) == 1
        for variant, gq, gk, gv, _ in seen:
            for got, want in ((gq, q), (gk, k), (gv, v)):
                np.testing.assert_array_equal(got.numpy(), want)
        zigzag = ({"causal": True}, None, None, None, unshard[0])
        for variant, _, _, _, out in seen + [zigzag]:
            want = ref_full_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v),
                                      causal=variant.get("causal", False),
                                      window=variant.get("window", 0))
            assert isinstance(out, torch.Tensor)
            np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5, err_msg=variant)

    def test_too_small_seq_gets_clear_error(self, capsys):
        from dmlc_tpu_torch.examples import long_context

        assert long_context.main(["--seq", "1", "--device", "cpu"]) == 2
        assert "smaller than 2*num_devices" in capsys.readouterr().err

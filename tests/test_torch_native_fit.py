"""The slice as a whole on ``device="cpu"``: the port's dense, csr and FM
fits reading through the native route (``create_parser`` →
``NativePipelineParser`` → the feed's native batch staging) against the
JAX package's fits on its own native route (its library loaded; its feed's
``_host_batches_native``), at a few hundred rows, from the same params.

The input batches are the same bits on both sides (the same C++), so the
limits are the existing fit tests': rtol 1e-5 / atol 1e-6 for the linear
fits (tests/test_torch_linear.py: torch's CPU sums against XLA's in another
f32 order, exp / log1p from two math libraries) and the reference's own
rtol 1e-4 / atol 1e-6 for FM (tests/test_torch_fm.py). A fit resumed from
its snapshot on the native route is the uninterrupted fit bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.data.parsers import NativePipelineParser as RefNative
from dmlc_tpu.device import BatchSpec as RefBatchSpec
from dmlc_tpu.device import DeviceFeed as RefDeviceFeed
from dmlc_tpu.models import FMLearner as RefFMLearner
from dmlc_tpu.models import LinearLearner as RefLinearLearner
from dmlc_tpu.models import init_fm_params as ref_init_fm_params
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.data.parsers import NativePipelineParser
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.models import FMLearner, LinearLearner, params_to_numpy
from dmlc_tpu_torch.models.fm import fm_params_from_numpy, fm_params_to_numpy
from dmlc_tpu_torch.obs import audit

LINEAR_TOL = dict(rtol=1e-5, atol=1e-6)
FM_TOL = dict(rtol=1e-4, atol=1e-6)
NUM_FEATURES = {"dense": 17, "csr": 4097}


@pytest.fixture(autouse=True)
def _native_routes(monkeypatch):
    for name in ("DMLC_TPU_NATIVE", "DMLC_TPU_PARSE_BACKEND",
                 "DMLC_TPU_PARSE_PROCS", "DMLC_TPU_AUDIT"):
        monkeypatch.delenv(name, raising=False)
    audit.reset_auditor()


def _write_svm(path, rows, nf, seed):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        n = rng.randint(1, min(9, nf - 1))
        ids = np.sort(rng.choice(np.arange(1, nf), n, replace=False))
        lines.append("%d %s" % (rng.randint(0, 2), " ".join(
            "%d:%.6f" % (j, v) for j, v in zip(ids, rng.randn(n)))))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _write_libfm(path, rows, nf, seed):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        ids = np.sort(rng.choice(np.arange(1, nf), 6, replace=False))
        vals = rng.rand(6)
        label = int((ids[0] % 3 == ids[1] % 3) ^ (vals[0] > 0.8))
        lines.append("%d %s" % (label, " ".join(
            "%d:%d:%.5f" % (f, j, v)
            for f, (j, v) in enumerate(zip(ids, vals)))))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _init(nf, seed):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(nf) * 0.01).astype(np.float32),
            "b": np.float32(0.02)}


def _ref_linear(path, layout, nf, params, hyper, epochs, batch_size):
    ref = RefLinearLearner(None, **hyper)
    ref.params = {k: jnp.asarray(a) for k, a in params.items()}
    ref.velocity = {k: jnp.zeros_like(a) for k, a in ref.params.items()}
    parser = ref_create_parser(path)
    assert isinstance(parser, RefNative)
    feed = RefDeviceFeed(parser, RefBatchSpec(batch_size=batch_size,
                                              layout=layout, num_features=nf),
                         host_prefetch=0)
    try:
        assert feed._use_native_batches()
        history = ref.fit_feed(feed, epochs=epochs)
    finally:
        feed.close()
    return ref, history


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_fit_uri_on_the_native_route_matches_the_reference(tmp_path, layout,
                                                           monkeypatch):
    nf = NUM_FEATURES[layout]
    path = _write_svm(tmp_path / "f.svm", 400, nf, 5)
    hyper = dict(objective="logistic", learning_rate=0.5, l2=0.01,
                 momentum=0.5)
    params = _init(nf, 6)
    seen = []
    real = DeviceFeed._host_batches_native

    def spy(feed):
        seen.append(type(feed._parser))
        return real(feed)

    monkeypatch.setattr(DeviceFeed, "_host_batches_native", spy)
    learner = LinearLearner(device="cpu", params=params, **hyper)
    history = learner.fit_uri(path, batch_size=64, epochs=2, layout=layout,
                              num_features=nf)
    assert seen and all(t is NativePipelineParser for t in seen)
    ref, ref_history = _ref_linear(path, layout, nf, params, hyper, 2, 64)
    assert len(history) == 2 and history[1] < history[0]
    np.testing.assert_allclose(history, ref_history, **LINEAR_TOL)
    got = params_to_numpy(learner.params)
    for key in ("w", "b"):
        np.testing.assert_allclose(got[key], np.asarray(ref.params[key]),
                                   **LINEAR_TOL)


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_a_resumed_native_fit_is_the_uninterrupted_fit(tmp_path, layout):
    nf = NUM_FEATURES[layout]
    path = _write_svm(tmp_path / "r.svm", 300, nf, 8)
    hyper = dict(objective="logistic", learning_rate=0.3, momentum=0.5)
    fit = dict(batch_size=32, layout=layout, num_features=nf)
    clean = LinearLearner(device="cpu", params=_init(nf, 9), **hyper)
    clean_history = clean.fit_uri(path, epochs=3, **fit)
    snap = str(tmp_path / "snap")
    first = LinearLearner(device="cpu", params=_init(nf, 9), **hyper)
    first.fit_uri(path, epochs=2, snapshot_uri=snap, **fit)
    resumed = LinearLearner(device="cpu", params=_init(nf, 9), **hyper)
    history = resumed.fit_uri(path, epochs=3, snapshot_uri=snap,
                              resume=True, **fit)
    assert history == clean_history
    want, got = params_to_numpy(clean.params), params_to_numpy(
        resumed.params)
    for key in ("w", "b"):
        assert got[key].tobytes() == want[key].tobytes(), key
    # and the uninterrupted fit is the reference's within the fit limits
    ref, ref_history = _ref_linear(path, layout, nf, _init(nf, 9),
                                   dict(hyper, l2=0.0), 3, 32)
    np.testing.assert_allclose(clean_history, ref_history, **LINEAR_TOL)


def test_fm_fit_on_the_native_route_matches_the_reference(tmp_path):
    nf, batch_size, epochs = 200, 32, 3
    path = _write_libfm(tmp_path / "train.libfm", 256, nf, 3)
    hyper = dict(num_factors=4, learning_rate=0.2, l2=0.001)
    start = {k: np.asarray(a) for k, a in
             ref_init_fm_params(nf, 4, 0.1, seed=2).items()}
    learner = FMLearner(device="cpu", num_features=nf, **hyper)
    learner.params = fm_params_from_numpy(start, "cpu")
    parser = create_parser(path, 0, 1, "libfm", device="cpu")
    assert isinstance(parser, NativePipelineParser)
    feed = DeviceFeed(parser, BatchSpec(batch_size=batch_size, layout="csr",
                                        num_features=nf), device="cpu")
    try:
        assert feed._use_native_batches()
        history = learner.fit_feed(feed, epochs=epochs)
    finally:
        feed.close()
    ref = RefFMLearner(None, num_features=nf, **hyper)
    ref.params = {k: jnp.asarray(v) for k, v in start.items()}
    ref_parser = ref_create_parser(path, 0, 1, "libfm")
    assert isinstance(ref_parser, RefNative)
    ref_feed = RefDeviceFeed(ref_parser, RefBatchSpec(
        batch_size=batch_size, layout="csr", num_features=nf),
        host_prefetch=0)
    try:
        ref_history = ref.fit_feed(ref_feed, epochs=epochs)
    finally:
        ref_feed.close()
    assert len(history) == epochs and history[-1] < history[0]
    np.testing.assert_allclose(history, ref_history, **FM_TOL)
    got = fm_params_to_numpy(learner.params)
    for key in ("w", "b", "v"):
        np.testing.assert_allclose(got[key], np.asarray(ref.params[key]),
                                   err_msg=key, **FM_TOL)

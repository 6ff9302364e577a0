"""The slice as a whole: the port's linear learner against the JAX package's
on one LibSVM file, from the same initial params."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.data import create_parser as ref_create_parser
from dmlc_tpu.device import BatchSpec as RefBatchSpec
from dmlc_tpu.device import DeviceFeed as RefDeviceFeed
from dmlc_tpu.models import LinearLearner as RefLinearLearner
from dmlc_tpu.models import make_linear_train_step as ref_make_step
from dmlc_tpu_torch.data import create_parser
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.models import (LinearLearner, make_linear_train_step,
                                   params_from_numpy, params_to_numpy,
                                   step_batch)
from dmlc_tpu_torch.ops import kernels

NUM_FEATURES = {"dense": 17, "csr": 4097}


def _write(path, rows, num_features, seed, integer):
    """Sorted feature ids in [1, num_features); integer values (every sum
    of the squared objective is then exact) or floats."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        n = rng.randint(1, min(9, num_features - 1))
        ids = np.sort(rng.choice(np.arange(1, num_features), n,
                                 replace=False))
        if integer:
            vals = rng.randint(-2, 3, n)
            feats = " ".join("%d:%d" % (j, v) for j, v in zip(ids, vals))
        else:
            vals = rng.randn(n)
            feats = " ".join("%d:%.6f" % (j, v) for j, v in zip(ids, vals))
        lines.append("%d %s" % (rng.randint(0, 2), feats))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _init(num_features, seed, integer):
    rng = np.random.RandomState(seed)
    if integer:
        w = rng.randint(-1, 2, num_features)
        return ({"w": w.astype(np.float32), "b": np.float32(1.0)},
                {"w": rng.randint(-1, 2, num_features).astype(np.float32),
                 "b": np.float32(-1.0)})
    w = rng.randn(num_features) * 0.01
    return {"w": w.astype(np.float32), "b": np.float32(0.02)}, None


def _first_batches(path, layout, nf, batch_size, count):
    spec = dict(batch_size=batch_size, layout=layout, num_features=nf)
    port = DeviceFeed(create_parser(path, device="cpu"), BatchSpec(**spec),
                      device="cpu")
    ref = RefDeviceFeed(ref_create_parser(path, threaded=False),
                        RefBatchSpec(**spec), host_prefetch=0)
    # copy the reference's batches out at once: its host staging is reused
    got = [step_batch(b, layout) for _, b in zip(range(count), port)]
    want = [{k: jnp.asarray(np.array(v))
             for k, v in step_batch(b, layout).items()}
            for _, b in zip(range(count), ref)]
    port.close()
    ref.close()
    return got, want


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_steps_bit_identical_on_integer_data(tmp_path, monkeypatch, layout,
                                             use_pallas):
    """Squared objective on integer-valued data, a batch of 64 rows (the
    weight sum, and so every division, is by a power of two), learning
    rate, l2 and momentum powers of two: every value the steps compute is
    exact in f32, so the two packages must agree bit for bit. Both batches
    of the file are stepped."""
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    nf = NUM_FEATURES[layout]
    path = _write(tmp_path / "int.svm", 128, nf, 3, integer=True)
    got, want = _first_batches(path, layout, nf, 64, 2)
    hyper = dict(objective="squared", learning_rate=0.125, l2=0.5,
                 momentum=0.5, layout=layout, num_features=nf)
    params, velocity = _init(nf, 4, integer=True)
    port_step = make_linear_train_step(None, **hyper)
    ref_step = ref_make_step(None, use_pallas=use_pallas, **hyper)
    for pb, rb in zip(got, want):
        # each batch steps from the initial state: after one step the
        # params are no longer integers and the next step's sums round
        p = params_from_numpy(params, "cpu")
        v = params_from_numpy(velocity, "cpu")
        rp = {k: jnp.asarray(a) for k, a in params.items()}
        rv = {k: jnp.asarray(a) for k, a in velocity.items()}
        p, v, m = port_step(p, v, pb)
        rp, rv, rm = ref_step(rp, rv, rb)
        for k in ("w", "b"):
            assert np.array_equal(p[k].numpy(), np.asarray(rp[k])), k
            assert np.array_equal(v[k].numpy(), np.asarray(rv[k])), k
        for k in ("loss_sum", "weight_sum"):
            assert np.array_equal(m[k].numpy(), np.asarray(rm[k])), k
    assert float(m["weight_sum"]) == 64.0


def test_step_leaves_inputs_untouched_unless_donated():
    rng = np.random.RandomState(0)
    batch = {"x": torch.tensor(rng.rand(8, 3).astype(np.float32)),
             "label": torch.ones(8), "weight": torch.ones(8)}
    params = params_from_numpy({"w": np.ones(3, np.float32),
                                "b": np.float32(0.5)}, "cpu")
    velocity = {k: torch.zeros_like(t) for k, t in params.items()}
    before = {k: t.clone() for k, t in params.items()}
    step = make_linear_train_step(None, momentum=0.9, l2=0.1)
    new_params, _, _ = step(params, velocity, batch)
    assert all(torch.equal(params[k], before[k]) for k in params)
    assert not torch.equal(new_params["w"], before["w"])
    donating = make_linear_train_step(None, momentum=0.9, l2=0.1,
                                      donate_batch=True)
    out, _, _ = donating(params, velocity, batch)
    assert out["w"] is params["w"] and torch.equal(out["w"], new_params["w"])


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_fit_uri_matches_reference_learner(tmp_path, monkeypatch, layout):
    """Two epochs of logistic SGD with momentum and l2 from the same
    non-zero params. Tolerance rtol 1e-5 / atol 1e-6: the sums run in
    another f32 order (torch's CPU matvec and index_add_ against XLA's
    dot and scatter) and exp/log1p come from two math libraries, a few
    ulps per step that 16 steps do not grow past that."""
    monkeypatch.setenv("DMLC_TPU_PARSE_BACKEND", "vector")
    nf = NUM_FEATURES[layout]
    path = _write(tmp_path / "f.svm", 500, nf, 5, integer=False)
    hyper = dict(objective="logistic", learning_rate=0.5, l2=0.01,
                 momentum=0.5)
    params, _ = _init(nf, 6, integer=False)
    fit = dict(batch_size=64, epochs=2, layout=layout, num_features=nf)
    learner = LinearLearner(device="cpu", params=params, **hyper)
    history = learner.fit_uri(path, **fit)
    ref = RefLinearLearner(None, **hyper)
    ref.params = {k: jnp.asarray(a) for k, a in params.items()}
    ref.velocity = {k: jnp.zeros_like(a) for k, a in ref.params.items()}
    # the reference's fit_uri over its own feed, built here so that it is
    # closed: an unthreaded parser, no prefetch thread
    ref_feed = RefDeviceFeed(
        ref_create_parser(path, threaded=False),
        RefBatchSpec(batch_size=64, layout=layout, num_features=nf),
        host_prefetch=0)
    try:
        ref_history = ref.fit_feed(ref_feed, epochs=2)
    finally:
        ref_feed.close()
    assert len(history) == 2 and history[1] < history[0]
    np.testing.assert_allclose(history, ref_history, rtol=1e-5, atol=1e-6)
    got = params_to_numpy(learner.params)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k], np.asarray(ref.params[k]),
                                   rtol=1e-5, atol=1e-6)
    # the caller's arrays were copied, not trained in place
    assert np.array_equal(params["w"], _init(nf, 6, integer=False)[0]["w"])
    if layout == "dense":
        x = np.random.RandomState(7).randn(5, nf).astype(np.float32)
        np.testing.assert_allclose(learner.predict(x), ref.predict(x),
                                   rtol=1e-5, atol=1e-6)


def test_fit_from_zero_init_counts_no_launch_on_cpu(tmp_path):
    path = _write(tmp_path / "z.svm", 100, 9, 8, integer=False)
    kernels.reset_launch_counts()
    learner = LinearLearner(device="cpu", objective="hinge")
    history = learner.fit_uri(path, batch_size=16, epochs=1,
                              num_features=9, drop_remainder=True)
    assert len(history) == 1 and np.isfinite(history[0])
    assert learner.params["w"].shape == (9,)
    assert kernels.fused_linear_grads.launches == 0


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_save_load_across_packages(tmp_path, saver):
    """A model saved by either package loads in the other: the same bits
    in w and b, the same param dict; the two packages write the same
    bytes for the same model."""
    hyper = dict(objective="hinge", learning_rate=0.25, l2=0.125,
                 momentum=0.5, num_features=9)
    params, _ = _init(9, 11, integer=False)
    port = LinearLearner(device="cpu", params=params, **hyper)
    ref = RefLinearLearner(None, **hyper)
    ref.params = {k: jnp.asarray(a) for k, a in params.items()}
    port.save(str(tmp_path / "port.model"))
    ref.save(str(tmp_path / "ref.model"))
    assert (tmp_path / "port.model").read_bytes() == \
        (tmp_path / "ref.model").read_bytes()
    uri = str(tmp_path / ("port.model" if saver == "port" else "ref.model"))
    loaded = LinearLearner(device="cpu")
    loaded.load(uri)
    ref_loaded = RefLinearLearner(None)
    ref_loaded.load(uri)
    assert loaded.param.to_dict() == ref_loaded.param.to_dict() == \
        port.param.to_dict()
    got = params_to_numpy(loaded.params)
    for k in ("w", "b"):
        want = np.asarray(ref_loaded.params[k])
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        assert got[k].tobytes() == want.tobytes() == \
            np.asarray(params[k], np.float32).tobytes()
    # training goes on from the loaded model, as from the saved one
    x = np.random.RandomState(12).randn(4, 9).astype(np.float32)
    assert np.array_equal(loaded.predict(x), port.predict(x))

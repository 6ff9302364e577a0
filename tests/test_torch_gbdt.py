"""The port's GBDT (``dmlc_tpu_torch.models.gbdt``) against the JAX
package's on the same numpy inputs, one process, on the CPU.

The port sums in the reference's CPU orders (each histogram cell and leaf
in row order from 0, the bins' prefix sum as XLA's CPU cumsum), so:

- binning is bit for bit: ``fit_bins`` edges (ties, a constant feature, a
  NaN column; the card route's sort-and-interpolate on a CPU tensor too),
  ``apply_bins`` ids (NaN values and NaN edges);
- histograms, splits and the squared loss's whole forests are bit for bit,
  on integer and on float data (every op is an f32 add, multiply or divide
  in the same order);
- the logistic and softmax losses give the same tree structure, with
  margins within 1e-5 absolute and loss histories within rtol 1e-5:
  torch's ``sigmoid``/``softmax``/``exp`` round differently from XLA's by
  an ulp, and the mean loss sums its rows in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_tpu.models import gbdt as ref
from dmlc_tpu_torch.models import gbdt as port
from dmlc_tpu_torch.utils import DMLCError

MARGIN_ATOL = 1e-5
LOSS_RTOL = 1e-5
SMALL = dict(num_trees=6, max_depth=3, num_bins=16)


def _synthetic(n=1024, f=6, seed=0):
    """The reference suite's problem: axis-aligned structure a shallow
    tree can express, noisy labels."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f).astype(np.float32)
    logit = (4.0 * (x[:, 0] > 0.5) + 2.0 * (x[:, 1] > 0.3)
             - 3.0 * (x[:, 2] > 0.7) - 1.5)
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return x, y


def _binning_input(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(500, 5).astype(np.float32)
    x[:, 1] = np.round(x[:, 1] * 2)  # heavy ties
    x[:, 2] = 3.25  # constant
    x[::7, 3] = 0.0  # a spike of zeros
    x[11, 4] = np.nan  # a NaN column
    return x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_bins", [2, 16, 256])
def test_fit_bins_matches_reference(num_bins):
    x = _binning_input()
    want = ref.fit_bins(x, num_bins)
    got = port.fit_bins(x, num_bins)
    assert got.dtype == np.float32 and got.shape == (5, num_bins - 1)
    assert got.tobytes() == want.tobytes()
    assert port.fit_bins(_t(x), num_bins).tobytes() == want.tobytes()
    # the non-NaN columns' edges strictly increase
    assert (np.diff(got[:4], axis=1) > 0).all()


@pytest.mark.parametrize("n", [1, 2, 7, 500])
def test_card_quantile_route_equals_numpy(n):
    """The card route (sort each column, gather two order statistics a cut
    point, numpy's interpolation on the host), run on a CPU tensor, gives
    np.quantile's float64 values bit for bit, NaN columns included."""
    x = _binning_input()[:n]
    qs = np.linspace(0.0, 1.0, 257)[1:-1]
    got = port._quantiles_on_device(_t(x), qs)
    want = np.quantile(x, qs, axis=0)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_apply_bins_matches_reference_with_nan():
    x = _binning_input()
    edges = ref.fit_bins(x, 16)  # feature 4's edges are all NaN
    xq = x.copy()
    xq[3, 0] = np.nan
    xq[4, 1] = np.inf
    xq[5, 3] = -np.inf
    xq[6, 0] = -0.0
    want = np.asarray(ref.apply_bins(xq, edges))
    got = port.apply_bins(_t(xq), edges)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3, 0] == 15  # a NaN value lands in the last bin
    np.testing.assert_array_equal(port._apply_bins_np(xq, edges, 16),
                                  ref._apply_bins_np(xq, edges, 16))


@pytest.mark.parametrize("num_bins,dtype", [(256, np.uint8),
                                            (257, np.uint16),
                                            (65536, np.uint16)])
def test_apply_bins_np_dtype_rule(num_bins, dtype):
    x = np.random.RandomState(2).randn(64, 3).astype(np.float32)
    edges = ref.fit_bins(x, num_bins)
    got = port._apply_bins_np(x, edges, num_bins)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got,
                                  ref._apply_bins_np(x, edges, num_bins))


# ---------------------------------------------------------------------------
# histogram and splits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("data", ["int", "float"])
def test_level_histogram_matches_reference(channels, data):
    rng = np.random.RandomState(3)
    n, f, nodes, bins = 300, 4, 4, 16
    xb = rng.randint(0, bins, (n, f)).astype(np.uint8)
    node = rng.randint(0, nodes, n).astype(np.int32)
    shape = (n,) if channels == 1 else (n, channels)
    if data == "int":
        g = rng.randint(-5, 6, shape).astype(np.float32)
        h = rng.randint(0, 4, shape).astype(np.float32)
    else:
        g = rng.randn(*shape).astype(np.float32)
        h = rng.rand(*shape).astype(np.float32)
    rg, rh = ref._level_histogram(jnp.asarray(xb), jnp.asarray(node),
                                  jnp.asarray(g), jnp.asarray(h), nodes,
                                  bins)
    hist = port._level_histogram(_t(xb), _t(node), _t(g), _t(h), nodes, bins)
    assert hist.shape == (nodes, f, bins, 2 * channels)
    assert hist[..., :channels].numpy().tobytes() == \
        np.asarray(rg).tobytes()
    assert hist[..., channels:].numpy().tobytes() == \
        np.asarray(rh).tobytes()
    again = port._level_histogram(_t(xb), _t(node), _t(g), _t(h), nodes,
                                  bins)
    assert torch.equal(hist, again)


def test_level_histogram_int32_guard_matches_reference():
    xb = np.zeros((2, 1024), np.int32)
    node = np.zeros(2, np.int32)
    g = np.zeros(2, np.float32)
    with pytest.raises(Exception, match="overflows int32") as want:
        ref._level_histogram(jnp.asarray(xb), jnp.asarray(node),
                             jnp.asarray(g), jnp.asarray(g), 64, 65536)
    with pytest.raises(DMLCError, match="overflows int32") as got:
        port._level_histogram(_t(xb), _t(node), _t(g), _t(g), 64, 65536)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 40, 256, 300])
def test_cumsum_bins_is_xla_cpu_order(n):
    x = np.random.RandomState(n).randn(2, 3, n, 2).astype(np.float32)
    x *= np.float32(10) ** np.random.RandomState(n + 1).randint(
        -4, 5, x.shape).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=2))
    assert port._cumsum_bins(_t(x)).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("reg_lambda,mcw", [(1.0, 1.0), (0.0, 0.0),
                                            (1.0, 40.0), (0.0, 5.0)])
@pytest.mark.parametrize("masked", [False, True])
def test_find_splits_matches_reference(reg_lambda, mcw, masked):
    rng = np.random.RandomState(4)
    gh = rng.randn(4, 5, 16, 1).astype(np.float32)
    hh = (rng.rand(4, 5, 16, 1) * 8).astype(np.float32)
    hh[0, :, 3:, :] = 0.0  # empty children at reg_lambda = 0
    mask = np.array([True, False, True, True, False]) if masked else None
    want = ref._find_splits(jnp.asarray(gh), jnp.asarray(hh), reg_lambda,
                            mcw, None if mask is None else jnp.asarray(mask))
    got = port._find_splits(_t(gh), _t(hh), reg_lambda, mcw,
                            None if mask is None else _t(mask))
    for name, w, g in zip(("feature", "bin", "gain", "gtot", "htot"), want,
                          got):
        assert g.numpy().tobytes() == np.asarray(w).tobytes(), name
    if mcw == 40.0:
        assert (got[0] >= -1).all()


def test_find_splits_no_positive_gain_is_leaf():
    gh = np.zeros((1, 2, 8, 1), np.float32)
    hh = np.ones((1, 2, 8, 1), np.float32)
    feature = port._find_splits(_t(gh), _t(hh), 1.0, 1.0)[0]
    assert feature.tolist() == [-1]


# ---------------------------------------------------------------------------
# stochastic masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [None, 0, 3])
@pytest.mark.parametrize("tree", [0, 1, 7])
def test_stochastic_masks_match_reference(rank, tree):
    import jax

    n, f = 333, 11
    key = jax.random.PRNGKey(9)

    def reference():
        k = jax.random.fold_in(key, tree)
        order = jax.random.permutation(jax.random.fold_in(k, 1), f)
        keep = int(np.ceil(0.4 * f))
        feat = np.zeros(f, bool)
        feat[np.asarray(order[:keep])] = True
        rk = jax.random.fold_in(k, 2)
        if rank is not None:
            rk = jax.random.fold_in(rk, rank)
        row = np.asarray(jax.random.uniform(rk, (n,)) < 0.6, np.float32)
        return row, feat

    rrow, rfeat = ref._stochastic_masks(key, tree, n, f, 0.6, 0.4, None) \
        if rank is None else reference()
    row, feat = port._stochastic_masks(port.prng.PRNGKey(9), tree, n, f, 0.6,
                                       0.4, rank, torch.device("cpu"))
    np.testing.assert_array_equal(row.numpy(), np.asarray(rrow))
    np.testing.assert_array_equal(feat, np.asarray(rfeat))
    assert feat.sum() == 5


# ---------------------------------------------------------------------------
# whole forests
# ---------------------------------------------------------------------------


def _fit_both(hyper, x, y, weight=None, **kw):
    r = ref.GBDTLearner(**hyper)
    rh = r.fit(x, y, weight=weight, **kw)
    p = port.GBDTLearner(device="cpu", **hyper)
    ph = p.fit(x, y, weight=weight, **kw)
    return r, rh, p, ph


FOREST_CASES = {
    "squared-float": (dict(objective="squared"), "float", False),
    "squared-int-weighted": (dict(objective="squared"), "int", True),
    "squared-lambda0": (dict(objective="squared", reg_lambda=0.0,
                             min_child_weight=0.0), "int", False),
    "logistic": (dict(objective="logistic"), "float", False),
    "logistic-weighted": (dict(objective="logistic"), "float", True),
    "softmax": (dict(objective="softmax", num_class=3), "float", False),
    "stochastic": (dict(objective="logistic", subsample=0.6,
                        colsample_bytree=0.5, seed=7), "float", False),
}


@pytest.mark.parametrize("case", sorted(FOREST_CASES))
def test_forest_matches_reference(case):
    hyper, data, weighted = FOREST_CASES[case]
    rng = np.random.RandomState(5)
    x, y = _synthetic(n=800, f=6, seed=6)
    if data == "int":
        x = rng.randint(-4, 5, x.shape).astype(np.float32)
        y = rng.randint(-3, 4, len(y)).astype(np.float32)
    if hyper["objective"] == "softmax":
        y = np.minimum(x[:, 0] * 3, 2).astype(np.int32).astype(np.float32)
    w = rng.randint(1, 3, len(y)).astype(np.float32) if weighted else None
    r, rh, p, ph = _fit_both(dict(SMALL, **hyper), x, y, w)
    for k in ("feature", "bin"):
        np.testing.assert_array_equal(p.trees[k].numpy(),
                                      np.asarray(r.trees[k]))
    np.testing.assert_allclose(ph, rh, rtol=LOSS_RTOL)
    rm, pm = r.predict_margin(x), p.predict_margin(x)
    if hyper["objective"] == "squared":
        for k in ("gain", "leaf"):
            assert p.trees[k].numpy().tobytes() == \
                np.asarray(r.trees[k]).tobytes(), k
        assert pm.tobytes() == rm.tobytes()
    else:
        np.testing.assert_allclose(pm, rm, rtol=0, atol=MARGIN_ATOL)
    np.testing.assert_allclose(p.predict(x), r.predict(x), rtol=0,
                               atol=MARGIN_ATOL)
    assert ph[-1] < ph[0]


def test_weight_two_equals_duplicated_rows():
    x, y = _synthetic(n=400, f=4, seed=8)
    w = np.where(np.arange(400) % 3 == 0, 2.0, 1.0).astype(np.float32)
    dup = np.repeat(np.arange(400), w.astype(int))
    edges = port.fit_bins(x[dup], 16)
    a = port.GBDTLearner(device="cpu", **SMALL)
    a.fit(x, y, weight=w, edges=edges)
    b = port.GBDTLearner(device="cpu", **SMALL)
    b.fit(x[dup], y[dup], edges=edges)
    for k in ("feature", "bin"):
        assert torch.equal(a.trees[k], b.trees[k])
    np.testing.assert_allclose(a.trees["leaf"].numpy(),
                               b.trees["leaf"].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_log_every_trains_the_same_forest():
    x, y = _synthetic(n=400, f=4, seed=9)
    hyper = dict(SMALL, subsample=0.7, colsample_bytree=0.5, seed=2)
    a = port.GBDTLearner(device="cpu", **hyper)
    ha = a.fit(x, y)
    b = port.GBDTLearner(device="cpu", **hyper)
    hb = b.fit(x, y, log_every=2)
    assert ha == hb
    for k in a.trees:
        assert torch.equal(a.trees[k], b.trees[k])


def test_eval_set_truncate_and_importance_match_reference():
    x, y = _synthetic(n=1000, f=6, seed=10)
    xv, yv = _synthetic(n=300, f=6, seed=11)
    hyper = dict(SMALL, num_trees=10, learning_rate=0.5)
    r, _, p, _ = _fit_both(hyper, x, y, eval_set=(xv, yv))
    np.testing.assert_allclose(p.eval_history, r.eval_history,
                               rtol=LOSS_RTOL)
    assert p.best_iteration == r.best_iteration
    for kind in ("gain", "split"):
        np.testing.assert_allclose(p.feature_importance(kind),
                                   r.feature_importance(kind), rtol=1e-5)
    assert p.feature_importance("split")[:3].sum() > \
        p.feature_importance("split")[3:].sum()
    p.truncate(4)
    r.truncate(4)
    assert p.trees["feature"].shape[0] == 4
    np.testing.assert_allclose(p.predict_margin(xv), r.predict_margin(xv),
                               rtol=0, atol=MARGIN_ATOL)
    with pytest.raises(DMLCError):
        p.truncate(99)
    with pytest.raises(DMLCError, match="eval_set"):
        port.GBDTLearner(device="cpu", **SMALL).fit(
            x, y, eval_set=(xv[:, :3], yv))


def test_softmax_label_and_edges_checks():
    x, y = _synthetic(n=64, f=3)
    with pytest.raises(DMLCError, match="class ids"):
        port.GBDTLearner(device="cpu", objective="softmax", num_class=2,
                         num_trees=1).fit(x, y + 5)
    with pytest.raises(DMLCError, match="num_class >= 2"):
        port.GBDTLearner(device="cpu", objective="softmax",
                         num_trees=1).fit(x, y)
    with pytest.raises(DMLCError, match="edges shape"):
        port.GBDTLearner(device="cpu", num_trees=1).fit(
            x, y, edges=np.zeros((3, 4), np.float32))


# ---------------------------------------------------------------------------
# fit_uri, save / load
# ---------------------------------------------------------------------------


def _write_svm(path, x, y, w=None):
    with open(path, "w") as fh:
        for i, (row, label) in enumerate(zip(x, y)):
            head = "%d" % int(label) if w is None else "%d:%.1f" % (
                int(label), w[i])
            fh.write("%s %s\n" % (head, " ".join(
                f"{j}:{v:.6f}" for j, v in enumerate(row))))
    return str(path)


@pytest.mark.parametrize("sample_rows", [4096, 256])
def test_fit_uri_matches_reference(tmp_path, sample_rows):
    """sample_rows ≥ N keeps every row in the reservoir; < N draws the
    reference's Algorithm R sample from the same RandomState: the same
    edges either way, then the same forest."""
    x, y = _synthetic(n=1500, f=5, seed=12)
    w = np.where(np.arange(1500) % 4 == 0, 2.0, 1.0).astype(np.float32)
    svm = _write_svm(tmp_path / "train.svm", x, y, w)
    hyper = dict(SMALL, objective="squared")
    r = ref.GBDTLearner(**hyper)
    rh = r.fit_uri(svm, num_features=5, sample_rows=sample_rows)
    p = port.GBDTLearner(device="cpu", **hyper)
    ph = p.fit_uri(svm, num_features=5, sample_rows=sample_rows, nthread=1)
    assert p.edges.tobytes() == np.asarray(r.edges).tobytes()
    for k in ("feature", "bin", "gain", "leaf"):
        assert p.trees[k].numpy().tobytes() == \
            np.asarray(r.trees[k]).tobytes(), k
    np.testing.assert_allclose(ph, rh, rtol=LOSS_RTOL)


def test_fit_uri_empty_raises(tmp_path):
    empty = tmp_path / "empty.svm"
    empty.write_text("\n\n")  # a file with no rows
    with pytest.raises(DMLCError, match="no rows"):
        port.GBDTLearner(device="cpu", num_trees=1).fit_uri(
            str(empty), num_features=3)


@pytest.mark.parametrize("objective", ["logistic", "softmax"])
def test_save_load_across_packages(tmp_path, objective):
    x, y = _synthetic(n=500, f=4, seed=13)
    hyper = dict(SMALL, objective=objective)
    if objective == "softmax":
        hyper["num_class"] = 3
        y = np.minimum(x[:, 1] * 3, 2).astype(np.int32).astype(np.float32)
    r, _, p, _ = _fit_both(hyper, x, y)
    r.save(str(tmp_path / "ref.model"))
    p.save(str(tmp_path / "port.model"))
    # the two files differ only where the leaves and gains do
    ref_in_port = port.GBDTLearner(device="cpu")
    ref_in_port.load(str(tmp_path / "ref.model"))
    np.testing.assert_array_equal(ref_in_port.predict_margin(x),
                                  r.predict_margin(x))
    port_in_ref = ref.GBDTLearner()
    port_in_ref.load(str(tmp_path / "port.model"))
    np.testing.assert_array_equal(port_in_ref.predict_margin(x),
                                  p.predict_margin(x))
    assert ref_in_port.param.to_dict() == r.param.to_dict()
    ref_in_port.save(str(tmp_path / "again.model"))
    assert (tmp_path / "again.model").read_bytes() == \
        (tmp_path / "ref.model").read_bytes()

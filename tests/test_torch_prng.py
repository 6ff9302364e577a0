"""The port's threefry (``dmlc_tpu_torch.utils.prng``) against
``jax.random`` (jax's default ``threefry2x32`` with
``jax_threefry_partitionable=True``): every key and draw bit for bit, for
the calls GBDT's masks make, over seeds, tree indices, ranks and sizes.
The row draw's tensor route runs here on CPU tensors; it is the same int64
arithmetic on the card."""

import jax
import numpy as np
import pytest
import torch

from dmlc_tpu_torch.utils import prng

SEEDS = [0, 1, 42, 7919, 2**31 - 1, -3, 2**32 + 5]
TREES = [0, 1, 19, 1000, 2**32 - 1]
SIZES = [1, 2, 28, 129, 1000, 5000]


def _jax_key(seed):
    return jax.random.PRNGKey(seed)


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    got = prng.PRNGKey(seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(
        got, np.asarray(jax.random.key_data(_jax_key(seed))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tree", TREES)
def test_fold_in_chain(seed, tree):
    """The masks' keys: fold_in(key, tree), then 1 (features) or 2 (rows),
    then a rank."""
    k, jk = prng.PRNGKey(seed), _jax_key(seed)
    k, jk = prng.fold_in(k, tree), jax.random.fold_in(jk, tree)
    np.testing.assert_array_equal(k, np.asarray(jk))
    for data in (1, 2, 3):
        np.testing.assert_array_equal(
            prng.fold_in(k, data), np.asarray(jax.random.fold_in(jk, data)))


def test_fold_in_rejects_out_of_range():
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(0), -1)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(0), 2**32)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_split(seed):
    k = prng.fold_in(prng.PRNGKey(seed), 5)
    jk = jax.random.fold_in(_jax_key(seed), 5)
    for num in (2, 3):
        np.testing.assert_array_equal(
            prng.split(k, num), np.asarray(jax.random.split(jk, num)))


@pytest.mark.parametrize("rank", [None, 0, 1, 3])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uniform_row_draw(seed, n, rank):
    k = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), 3), 2)
    jk = jax.random.fold_in(jax.random.fold_in(_jax_key(seed), 3), 2)
    if rank is not None:
        k, jk = prng.fold_in(k, rank), jax.random.fold_in(jk, rank)
    want = np.asarray(jax.random.uniform(jk, (n,)))
    host = prng.uniform(k, n)
    assert host.dtype == np.float32 and host.tobytes() == want.tobytes()
    tensor = prng.uniform(k, n, torch.device("cpu"))
    assert tensor.dtype == torch.float32
    assert tensor.numpy().tobytes() == want.tobytes()
    assert 0.0 <= want.min() and want.max() < 1.0


@pytest.mark.parametrize("n", SIZES + [1700])
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_permutation(seed, n):
    """Round count ceil(3 ln n / ln(2^32 - 1)): one below n = 1626, two
    from 1626 on (5000 and 1700 take two rounds)."""
    k = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), 4), 1)
    jk = jax.random.fold_in(jax.random.fold_in(_jax_key(seed), 4), 1)
    got = prng.permutation(k, n)
    np.testing.assert_array_equal(got, np.asarray(
        jax.random.permutation(jk, n)))
    assert sorted(got.tolist()) == list(range(n))


def test_random_bits():
    k = prng.PRNGKey(11)
    got = prng.random_bits(k, 777)
    want = np.asarray(jax.random.bits(_jax_key(11), (777,), np.uint32))
    np.testing.assert_array_equal(got, want)

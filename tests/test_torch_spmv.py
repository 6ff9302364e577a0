"""``spmv_transpose`` on the CPU at the Criteo batch shape, against
``dmlc_tpu.ops.spmv.spmv_transpose`` on JAX's CPU.

The batch is the csr path's: 8192 rows, a 327,680-entry bucket, 2^20 + 1
features, with Zipf-skewed feature ids (hashed categorical values: a few
ids take most entries, so long runs of one id are summed). PyTorch runs
at its default thread count: the CPU route must give the same bits
whatever the threads do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_tpu.ops.spmv import spmv_transpose as jax_spmv_transpose
from dmlc_tpu_torch.ops import spmv

ROWS, ENTRIES, FEATURES = 8192, 327_680, (1 << 20) + 1


def criteo_batch(integer: bool, seed: int):
    """(values, indices, row_ids, row_grads) as numpy arrays: ~40 entries
    a row from CSR offsets clipped to the bucket (the padded tail lands on
    the last row), Zipf(1.3) ids, integer-valued or float data."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(30, 51, ROWS)
    offsets = np.minimum(np.concatenate([[0], np.cumsum(counts)]), ENTRIES)
    row_ids = spmv.expand_row_ids(
        torch.tensor(offsets.astype(np.int32)), ENTRIES).numpy()
    indices = np.minimum(rng.zipf(1.3, ENTRIES), FEATURES - 1).astype(
        np.int32)
    if integer:
        # every sum exact in f32: 9 x 327,680 entries stays below 2^24
        values = rng.randint(-3, 4, ENTRIES).astype(np.float32)
        row_grads = rng.randint(-3, 4, ROWS).astype(np.float32)
    else:
        values = rng.rand(ENTRIES).astype(np.float32)
        row_grads = rng.randn(ROWS).astype(np.float32)
    return values, indices, row_ids, row_grads


def port(values, indices, row_ids, row_grads):
    return spmv.spmv_transpose(
        torch.from_numpy(values), torch.from_numpy(indices),
        torch.from_numpy(row_ids), torch.from_numpy(row_grads), FEATURES)


def reference(values, indices, row_ids, row_grads):
    return np.asarray(jax_spmv_transpose(
        jnp.asarray(values), jnp.asarray(indices), jnp.asarray(row_ids),
        jnp.asarray(row_grads), num_features=FEATURES))


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "float"])
def test_spmv_transpose_cpu_repeats_its_bits(integer):
    batch = criteo_batch(integer, seed=1)
    first = port(*batch)
    for _ in range(2):
        assert torch.equal(first, port(*batch))


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "float"])
def test_spmv_transpose_cpu_matches_jax_at_criteo_shape(integer,
                                                        record_property):
    """Integer data: the reference's bits (every sum is exact). Float
    data: each feature within 1e-5 of the sum of its contributions'
    magnitudes from the reference, the room a sum in another order needs
    (a sum that cancels can lose every digit of its own size); both sum
    each feature's entries in entry order from 0, so the bits are recorded
    as well (``bits_equal``)."""
    batch = criteo_batch(integer, seed=2)
    got = port(*batch).numpy()
    want = reference(*batch)
    bits_equal = bool(np.array_equal(got, want))
    record_property("bits_equal", bits_equal)
    if integer:
        assert bits_equal
    else:
        values, indices, row_ids, row_grads = batch
        magnitude = reference(np.abs(values), indices, row_ids,
                              np.abs(row_grads))
        assert np.all(np.abs(got - want) <= 1e-5 * magnitude)


def test_spmv_transpose_cpu_with_no_entries_is_zero():
    empty = np.zeros(0, dtype=np.float32)
    got = spmv.spmv_transpose(
        torch.from_numpy(empty), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), torch.ones(4), 7)
    assert torch.equal(got, torch.zeros(7))

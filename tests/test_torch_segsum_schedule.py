"""The summation order of the ``coo_segment_sum`` kernel
(``dmlc_tpu_torch/ops/csrc/coo_segment_sum.cu``), modelled on the CPU.

The kernel gives each CTA a tile of entries, sums each run of equal row ids
in the tile (a thread's entries in order, a Kogge-Stone segmented scan over
the warp, warp pieces added in warp order) and sums a row that spans tiles
from its tile pieces in tile order, in the CTA that arrives last at it.
``chip_smoke.seg_sum_schedule`` repeats that schedule in torch on the CPU,
reading the tile and the column pass from the kernel source. Here the model
is held, on every case of ``chip_smoke.seg_sum_edge_cases()`` and a small
padded Criteo-shaped batch, bit for bit against ``coo_segment_sum_plain`` on
integer data (every sum exact in any order), against the JAX package's
Pallas ``coo_segment_sum`` in interpret mode on float data, for every output
row written exactly once, and for a column order that does not change with
the number of columns. On the card, tests/test_torch_cuda.py holds the
kernel's bits against the model's.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (FM_COLS, SEG_WIDE_COLS, seg_sum_constants,
                        seg_sum_edge_cases, seg_sum_schedule)
from dmlc_tpu.ops import pallas_kernels as jax_kernels
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.device.csr import pad_to_bucket
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops.spmv import expand_row_ids

CSRC = Path(kernels.__file__).parent / "csrc"
# two f32 orders of sums of up to 8,231 N(0, 1) terms (rows up to ~120 in
# magnitude): each order's rounding is a few ulp of the partial sums, so
# the two agree to ~1e-7 relative; a lost or doubled entry reads O(1)
FLOAT_TOL = dict(rtol=1e-5, atol=1e-4)


def small_criteo_batch():
    """(row ids, num_rows) of a padded Criteo-shaped batch as the feed
    builds it: 256 rows of 39 entries in a 10,240-entry bucket, the tail
    clamped onto the last row by expand_row_ids."""
    rows = 256
    offset = np.concatenate([[0], np.cumsum(np.full(rows, 39))])
    rng = np.random.RandomState(5)
    block = RowBlock(offset=offset, label=np.zeros(rows),
                     index=rng.randint(1, 1 << 20, offset[-1]).astype(
                         np.uint32),
                     value=rng.rand(offset[-1]).astype(np.float32))
    batch = pad_to_bucket(block, rows)
    assert batch.values.shape[0] > offset[-1]  # a padded tail
    ids = expand_row_ids(torch.from_numpy(batch.offsets),
                         batch.values.shape[0])
    return ids.numpy(), rows


CASES = {name: (ids, rows) for name, ids, rows in seg_sum_edge_cases()}
CASES["small padded criteo batch"] = small_criteo_batch()


def _contrib(ids, cols, integer, seed=0):
    rng = np.random.RandomState(seed + len(ids))
    shape = (len(ids),) if cols is None else (len(ids), cols)
    a = rng.randint(-5, 6, shape) if integer else rng.randn(*shape)
    return torch.from_numpy(a.astype(np.float32))


def test_tile_constants_match_the_wrapper():
    """kernels.SEG_TILE sizes the wrapper's edge scratch and counters; the
    kernel's tile is kThreads x kPerThread entries, and a warp-chain pass
    takes one thread a (warp, column): kWarps x kColChunk <= kThreads.
    SEG_WIDE_COLS takes two column passes."""
    k = seg_sum_constants()
    assert k["kThreads"] * k["kPerThread"] == kernels.SEG_TILE
    assert k["kThreads"] // 32 * k["kColChunk"] <= k["kThreads"]
    assert k["kColChunk"] < SEG_WIDE_COLS <= 2 * k["kColChunk"]
    assert kernels.seg_sum_tiles(0) == 1
    assert kernels.seg_sum_tiles(327_680) == 320


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_plain_on_integer_data(case):
    ids, rows = CASES[case]
    contrib = _contrib(ids, None, True)
    got, writes = seg_sum_schedule(contrib, ids, rows)
    want = kernels.coo_segment_sum_plain(contrib, torch.from_numpy(ids),
                                         rows)
    assert torch.equal(got, want)
    assert (writes == 1).all(), np.flatnonzero(writes != 1)[:10]


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_against_jax_on_float_data(case):
    """The model against the JAX package's Pallas kernel, interpret mode,
    on N(0, 1) contributions, within FLOAT_TOL (another summation
    order)."""
    ids, rows = CASES[case]
    contrib = _contrib(ids, None, False)
    got, _ = seg_sum_schedule(contrib, ids, rows)
    want = jax_kernels.coo_segment_sum(jnp.asarray(contrib.numpy()),
                                       jnp.asarray(ids), rows,
                                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)


@pytest.mark.parametrize("cols", [1, 5, FM_COLS, SEG_WIDE_COLS])
@pytest.mark.parametrize("case", ["small padded criteo batch",
                                  "a row over three tiles",
                                  "a tile boundary between two rows",
                                  "empty rows at start, middle and end"])
def test_column_order_does_not_change_with_cols(case, cols):
    """Column c of an [E, C] call is summed in the order of a cols = 1
    call on contrib[:, c], whatever C and its column passes: the same
    bits on float data."""
    ids, rows = CASES[case]
    contrib = _contrib(ids, cols, False, seed=cols)
    got, writes = seg_sum_schedule(contrib, ids, rows)
    assert got.shape == (rows, cols) and (writes == 1).all()
    for c in range(cols):
        alone, _ = seg_sum_schedule(contrib[:, c].contiguous(), ids, rows)
        assert torch.equal(got[:, c], alone), c


def _c_signatures():
    """{entry point: [C parameter types]} of every extern "C" function of
    csrc/*.cu."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (dmlc_\w+)\(([^)]*)\)',
                             src.read_text()):
            out[m.group(1)] = [" ".join(p.split()[:-1]) if "*" not in p
                               else "pointer" for p in m.group(2).split(",")]
    return out


C_TYPES = {"pointer": kernels._P, "int64_t": kernels._I64,
           "int": kernels._INT}


@pytest.mark.parametrize("name", sorted(kernels.SIGNATURES))
def test_ctypes_argtypes_match_the_c_signature(name):
    """The ctypes argument types set on each entry point of the library
    are its C parameters, one for one: a pointer or a 64-bit size passed
    as a 32-bit int would be cut."""
    c = _c_signatures()
    assert sorted(c) == sorted(kernels.SIGNATURES)
    assert [C_TYPES[t] for t in c[name]] == kernels.SIGNATURES[name]


def test_coo_segment_sum_is_one_launch_with_no_starts():
    """The entry point launches one kernel (one ``<<<`` in the source, one
    counted launch in the wrapper), and the wrapper allocates no per-row
    ``starts`` array: only the tile edges, the output and the counters it
    keeps on the stream."""
    import inspect

    src = (CSRC / "coo_segment_sum.cu").read_text()
    assert src.count("<<<") == 1
    wrapper = inspect.getsource(kernels.coo_segment_sum)
    assert "starts" not in wrapper
    assert wrapper.count("torch.empty(") == 2  # out, edges
    assert wrapper.count("count_launch(") == 1

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch; from the root of a checkout::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets JAX up for the rest of the suite;
``python -m`` puts the checkout's root on the path, for ``chip_smoke``,
whose flash cases and phase-8 checks the flash test shares.)
"""

import numpy as np
import pytest
import torch

from chip_smoke import (FLASH_CASES, TF32_FAULT_MIN_T, TOKEN_SIZES,
                         flash_case, hold_seg_sum, one_call_ops,
                         read_lost_tile, require_one_kernel,
                         seg_sum_edge_cases, token_chunk)
from dmlc_tpu_torch.data import create_row_block_iter
from dmlc_tpu_torch.device import BatchSpec, DeviceFeed
from dmlc_tpu_torch.models import LinearLearner
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.ops.spmv import expand_row_ids, spmv_transpose

pytestmark = pytest.mark.cuda

OBJECTIVES = ("logistic", "squared", "hinge")
# ragged rows and features, one row, many 128-row tiles, HIGGS's batch,
# and a feature width read in 64 chunks of 32 (only the first stays in
# registers)
SHAPES = ((700, 28), (1, 5), (2048, 16), (300, 64), (16384, 29),
          (4096, 2048))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _dense(device, rows, features, integer):
    rng = np.random.RandomState(rows + features)
    if integer:
        x = rng.randint(-2, 3, (rows, features))
        w = rng.randint(-1, 2, features)
        b = 1.0
        label = rng.randint(0, 2, rows)
        weight = rng.randint(0, 3, rows)
    else:
        x = rng.rand(rows, features)
        w = rng.randn(features) * 0.1
        b = 0.05
        label = rng.rand(rows) < 0.2
        weight = np.ones(rows)
    return [torch.tensor(np.asarray(a, dtype=np.float32), device=device)
            for a in (x, label, weight, w, b)]


@pytest.mark.parametrize("rows,features", SHAPES)
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_fused_linear_grads_kernel_matches_plain(cuda, objective, rows,
                                                 features):
    integer = objective != "logistic"
    args = _dense(cuda, rows, features, integer)
    before = kernels.fused_linear_grads.launches
    got = kernels.fused_linear_grads(*args, objective=objective)
    again = kernels.fused_linear_grads(*args, objective=objective)
    want = kernels.fused_linear_grads_plain(*args, objective=objective)
    torch.cuda.synchronize()
    assert kernels.fused_linear_grads.launches == before + 2
    for g, a, wnt in zip(got, again, want):
        assert torch.equal(g, a)  # no atomics: the same bits every run
        if integer:
            assert torch.equal(g, wnt)  # exact sums in any order
        else:
            # another summation order, and expf against torch's sigmoid
            torch.testing.assert_close(g, wnt, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows,features", ((16384, 29), (1000, 29),
                                           (4096, 2048)))
@pytest.mark.parametrize("objective", ("logistic", "squared"))
def test_fused_linear_grads_on_two_streams(cuda, objective, rows, features):
    """HIGGS's batch, a ragged last tile and a wide F: two calls back to
    back with no sync between them on each of two streams at once (each
    stream has its own arrival counter, which every call leaves at 0) give
    the same bits, one counted launch a call, and hold against the plain
    version as above."""
    integer = objective != "logistic"
    args = _dense(cuda, rows, features, integer)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    before = kernels.fused_linear_grads.launches
    got = []
    for stream in streams:
        with torch.cuda.stream(stream):
            for _ in range(2):
                got.append(kernels.fused_linear_grads(*args,
                                                      objective=objective))
    torch.cuda.synchronize()
    assert kernels.fused_linear_grads.launches == before + 4
    for other in got[1:]:
        assert all(torch.equal(a, c) for a, c in zip(got[0], other))
    want = kernels.fused_linear_grads_plain(*args, objective=objective)
    for g, wnt in zip(got[0], want):
        if integer:
            assert torch.equal(g, wnt)
        else:
            torch.testing.assert_close(g, wnt, rtol=1e-5, atol=1e-6)


def test_fused_linear_grads_is_one_kernel_and_sees_a_lost_tile(cuda):
    """One call runs exactly one kernel on the card and no memset (by a
    captured CUDA graph and, where CUPTI traces, torch.profiler), and
    chip_smoke.py's lost-tile fault (the last tile's rows left out) fails
    the limit the kernel is held to."""
    args = _dense(cuda, 1000, 29, False)
    ops = one_call_ops(lambda: kernels.fused_linear_grads(*args))
    require_one_kernel(ops, "fused_linear_grads", "fused_linear_grads_kernel")
    assert read_lost_tile(kernels, args) > 1.0


SEG_EDGE_CASES = {name: (ids, rows) for name, ids, rows
                  in seg_sum_edge_cases()}


@pytest.mark.parametrize("case", [(8192, 39, 327_680), (100, 3, 512),
                                  (7, 0, 256)] + sorted(SEG_EDGE_CASES),
                         ids=str)
def test_coo_segment_sum_kernel_matches_plain(cuda, case):
    """Row ids from expand_row_ids over ragged offsets (empty rows, a
    padded entry tail), as the main path hands them to the kernel, and
    chip_smoke.py's phase-4 edge cases of the row search: bit-equal to
    the plain version on integer data, the same bits twice."""
    if isinstance(case, str):
        hold_seg_sum(kernels, cuda, case, *SEG_EDGE_CASES[case])
        return
    rows, per_row, bucket = case
    rng = np.random.RandomState(rows)
    counts = rng.randint(0, 2 * per_row + 1, rows)
    offsets = np.minimum(np.concatenate([[0], np.cumsum(counts)]), bucket)
    offsets = torch.tensor(offsets.astype(np.int32), device=cuda)
    row_ids = expand_row_ids(offsets, bucket)
    contrib = torch.tensor(rng.randint(-5, 6, bucket).astype(np.float32),
                           device=cuda)
    got = kernels.coo_segment_sum(contrib, row_ids, rows)
    again = kernels.coo_segment_sum(contrib, row_ids, rows)
    want = kernels.coo_segment_sum_plain(contrib, row_ids, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)


def test_spmv_transpose_repeats_its_bits(cuda):
    rng = np.random.RandomState(0)
    entries, rows, nfeat = 100_000, 2048, 4097
    offsets = torch.tensor(np.linspace(0, entries, rows + 1).astype(np.int32),
                           device=cuda)
    row_ids = expand_row_ids(offsets, entries)
    values = torch.tensor(rng.rand(entries).astype(np.float32), device=cuda)
    # few distinct features: long runs of one id to reduce
    indices = torch.tensor(rng.randint(0, 64, entries).astype(np.int32),
                           device=cuda)
    grads = torch.tensor(rng.randn(rows).astype(np.float32), device=cuda)
    first = spmv_transpose(values, indices, row_ids, grads, nfeat)
    for _ in range(3):
        assert torch.equal(first, spmv_transpose(values, indices, row_ids,
                                                 grads, nfeat))


def test_kernels_reject_what_they_do_not_take(cuda):
    vec = torch.zeros(4, device=cuda)
    w, b = torch.zeros(3, device=cuda), torch.zeros((), device=cuda)
    with pytest.raises(Exception, match="float32"):
        kernels.fused_linear_grads(torch.zeros(4, 3, device=cuda).double(),
                                   vec, vec, w, b)
    with pytest.raises(Exception, match="contiguous"):
        kernels.fused_linear_grads(torch.zeros(3, 4, device=cuda).T, vec,
                                   vec, w, b)
    with pytest.raises(Exception, match="int32"):
        kernels.coo_segment_sum(
            vec, torch.zeros(4, dtype=torch.int64, device=cuda), 2)


@pytest.mark.parametrize("b,t,h,hk,d,causal", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, b, t, h, hk, d, causal):
    """chip_smoke.py's phase 8 for one shape: forward and both backward
    kernels against the plain version with autograd, within
    tests/test_sequence_parallel.py's tolerances (outputs rtol 2e-4 /
    atol 2e-5, gradients rtol 2e-3 / atol 2e-4: f32 sums over the keys in
    another order), the same bits twice (no atomics), and the known
    forward and backward faults outside those limits, among them, from
    T = 512 on, the output and gradients of one TF32 pass per product
    (what the kernels' 3-pass split is there to avoid). Any miss
    raises."""
    before = {n: kernels.KERNELS[n].launches for n in kernels.KERNELS}
    report = flash_case(kernels, cuda, b, t, h, hk, d, causal,
                        seed=t + hk + d)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert kernels.KERNELS[name].launches == before[name] + 2
    assert report["dq_tol_ratio"] <= 1.0
    assert report["diagonal_detached_dq_tol_ratio"] > 1.0
    assert torch.backends.cuda.matmul.allow_tf32 is False
    if t >= TF32_FAULT_MIN_T:
        assert max(report["one_tf32_pass_%s_tol_ratio" % g]
                   for g in ("out", "lse")) > 1.0
        assert max(report["one_tf32_pass_%s_tol_ratio" % g]
                   for g in ("dq", "dk", "dv")) > 1.0


def test_flash_path_trains_through_the_kernels(cuda):
    """Ulysses over a one-rank group with the flash local kernel: forward
    and backward launch each flash kernel once and match the built-in
    full_attention schedule."""
    from dmlc_tpu_torch.ops import make_flash_local, make_ulysses_attention

    rng = np.random.RandomState(5)
    leaves = [torch.tensor(rng.randn(1, 1024, heads, 64).astype(np.float32),
                           device=cuda, requires_grad=True)
              for heads in (8, 2, 2)]  # q, then GQA k and v
    kernels.reset_launch_counts()
    flash = make_ulysses_attention(local_attention=make_flash_local(True))
    out = flash(*leaves)
    (out ** 2).sum().backward()
    got = [out.detach()] + [x.grad.clone() for x in leaves]
    assert {n: kernels.KERNELS[n].launches for n in kernels.KERNELS} == {
        "fused_linear_grads": 0, "coo_segment_sum": 0,
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1, "tokenize_boundaries": 0}
    for x in leaves:
        x.grad = None
    out = make_ulysses_attention(causal=True)(*leaves)
    (out ** 2).sum().backward()
    want = [out.detach()] + [x.grad for x in leaves]
    torch.testing.assert_close(got[0], want[0], rtol=2e-4, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-4)


def test_flash_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 64, 4, 128, device=cuda)
    with pytest.raises(Exception, match="head dim 96"):
        kernels.flash_attention_fwd(torch.zeros(1, 64, 4, 96, device=cuda),
                                    torch.zeros(1, 64, 4, 96, device=cuda),
                                    torch.zeros(1, 64, 4, 96, device=cuda))
    with pytest.raises(Exception, match="aligned"):
        flat = torch.zeros(1 + 64 * 4 * 128, device=cuda)
        kernels.flash_attention_fwd(flat[1:].view(1, 64, 4, 128), q, q)


def _write_svm(path, rows):
    rng = np.random.RandomState(1)
    path.write_text("".join(
        "%d %s\n" % (rng.randint(0, 2), " ".join(
            "%d:%.4f" % (j, rng.rand()) for j in sorted(
                rng.choice(np.arange(1, 30), 5, replace=False))))
        for _ in range(rows)))
    return str(path)


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_feed_reuses_pinned_staging_and_matches_cpu(cuda, tmp_path, layout):
    """A staging buffer goes back into use only after the copy behind it
    completed: the pool stops allocating once it covers the copies in
    flight, and every batch on the card equals the CPU feed's."""
    path = _write_svm(tmp_path / "f.svm", 2000)
    spec = BatchSpec(batch_size=64, layout=layout, num_features=30)
    on_card = DeviceFeed(path, spec)
    on_cpu = DeviceFeed(path, spec, device="cpu")
    batches = 0
    for got, want in zip(on_card, on_cpu):
        for key, value in want.items():
            if isinstance(value, torch.Tensor):
                assert torch.equal(got[key].cpu(), value), key
            else:
                assert got[key] == value, key
        batches += 1
    assert batches == 32
    staged = 3 if layout == "dense" else 5  # arrays per batch
    assert on_card.pool.reused > 0
    assert on_card.pool.allocated + on_card.pool.reused == staged * batches
    on_card.close()
    on_cpu.close()


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_fit_on_the_card_launches_one_kernel_a_step(cuda, tmp_path, layout):
    path = _write_svm(tmp_path / "d.svm", 1000)
    kernels.reset_launch_counts()
    history = LinearLearner(objective="logistic").fit_uri(
        path, batch_size=128, epochs=2, layout=layout, num_features=30)
    cpu = LinearLearner(device="cpu", objective="logistic").fit_uri(
        path, batch_size=128, epochs=2, layout=layout, num_features=30)
    name = "fused_linear_grads" if layout == "dense" else "coo_segment_sum"
    assert kernels.KERNELS[name].launches == 2 * 8
    np.testing.assert_allclose(history, cpu, rtol=1e-5)


def _hold_masks(got, a):
    want = kernels.tokenize_boundaries_plain(a)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and g.shape == a.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind,size", TOKEN_SIZES)
def test_tokenize_boundaries_kernel_matches_plain(cuda, kind, size):
    """chip_smoke.py's phase-11 sizes: ragged n around the 16-byte group,
    an all-separator and a separator-free chunk, and an 8 MiB chunk; the
    masks are exact, so they must be equal."""
    a = torch.tensor(token_chunk(kind, size, seed=size), device=cuda)
    before = kernels.tokenize_boundaries.launches
    got = kernels.tokenize_boundaries(a)
    torch.cuda.synchronize()
    assert kernels.tokenize_boundaries.launches == before + (size > 0)
    _hold_masks(got, a)


@pytest.mark.parametrize("offset", range(1, 16))
def test_tokenize_boundaries_unaligned_starts(cuda, offset):
    """A chunk that starts 1-15 bytes into a buffer: partial first and
    last groups, and outputs aligned as the input is."""
    buf = torch.tensor(token_chunk("mixed", 5000, seed=offset), device=cuda)
    for n in (1, 15, 16, 17, 4096 - offset):
        _hold_masks(kernels.tokenize_boundaries(buf[offset:offset + n]),
                    buf[offset:offset + n])


def test_tokenizer_route_on_the_card_matches_cpu(cuda, tmp_path):
    """create_row_block_iter on the card and on the CPU: the same
    RowBlock, bit for bit, with one kernel launch a non-empty chunk part
    (nthread=2 splits a chunk of 4096 bytes or more in two)."""
    path = _write_svm(tmp_path / "t.svm", 3000)
    kernels.reset_launch_counts()
    got = next(iter(create_row_block_iter(path, nthread=1)))
    launches = kernels.tokenize_boundaries.launches
    want = next(iter(create_row_block_iter(path, device="cpu")))
    assert launches == 1  # one chunk, one part, under 8 MiB
    for name in ("offset", "label", "index", "value"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    kernels.reset_launch_counts()
    again = next(iter(create_row_block_iter(path)))
    assert kernels.tokenize_boundaries.launches == 2
    assert np.array_equal(again.index, want.index)

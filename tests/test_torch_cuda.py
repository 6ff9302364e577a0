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

from chip_smoke import (CELL_FEATURES, FEATURE_SUM_COLS, FLASH_CASES,
                         FM_COLS, FM_PACKED_COLS, FM_SEG_COLS, SEG_WIDE_COLS,
                         TF32_FAULT_MIN_T, TOKEN_SIZES, cell_feature_ids,
                         criteo_batch, drive_recovery, feature_sum_cases,
                         flash_case, hold_feature_sum, hold_seg_schedule,
                         hold_seg_sum, hold_seg_sum_cols, index_put_route,
                         one_call_ops, read_lost_tile, require_one_kernel,
                         seg_sum_edge_cases, sorted_sum_order, token_chunk,
                         write_criteo)
from dmlc_tpu_torch.data import create_parser, create_row_block_iter
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


@pytest.mark.parametrize("cols", [None, FM_COLS, SEG_WIDE_COLS])
@pytest.mark.parametrize("case", ["criteo batch"] + sorted(SEG_EDGE_CASES))
def test_coo_segment_sum_kernel_matches_its_schedule(cuda, case, cols):
    """On float data the kernel gives the bits of
    chip_smoke.seg_sum_schedule, its summation order modelled on the CPU
    (tests/test_torch_segsum_schedule.py holds the model), at [E], FM's
    [E, 17] and a width of two column passes; every row written once."""
    if case == "criteo batch":
        batch = criteo_batch(cuda, 3)
        ids = expand_row_ids(batch["offsets"], batch["values"].shape[0])
        rows = 8192
    else:
        ids, rows = SEG_EDGE_CASES[case]
        ids = torch.tensor(ids, device=cuda)
    rng = np.random.RandomState(len(ids) + (cols or 1))
    shape = (len(ids),) if cols is None else (len(ids), cols)
    contrib = torch.tensor(rng.randn(*shape).astype(np.float32),
                           device=cuda)
    got = hold_seg_schedule(kernels, case, contrib, ids, rows)
    assert torch.equal(got, kernels.coo_segment_sum(contrib, ids, rows))


@pytest.mark.parametrize("cols", [None, FM_COLS])
def test_coo_segment_sum_is_one_kernel_on_any_stream(cuda, cols):
    """One call runs exactly one kernel and no memset (a captured CUDA
    graph and, where CUPTI traces, torch.profiler) at the Criteo batch, as
    [E] and at FM's width; two streams at once give the same bits, one
    counted launch a call, and leave their chain counters at 0."""
    batch = criteo_batch(cuda, 3)
    ids = expand_row_ids(batch["offsets"], batch["values"].shape[0])
    contrib = batch["values"] if cols is None else \
        batch["values"][:, None].repeat(1, cols)
    ops = one_call_ops(lambda: kernels.coo_segment_sum(contrib, ids, 8192))
    require_one_kernel(ops, "coo_segment_sum", "seg_sum_kernel")
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    before = kernels.coo_segment_sum.launches
    got = []
    for stream in streams:
        with torch.cuda.stream(stream):
            got += [kernels.coo_segment_sum(contrib, ids, 8192)
                    for _ in range(2)]
    torch.cuda.synchronize()
    assert kernels.coo_segment_sum.launches == before + 4
    assert all(torch.equal(got[0], g) for g in got[1:])
    for stream in streams:
        chains = kernels._ARRIVAL_COUNTERS[(
            "coo_segment_sum", torch.cuda.current_device(),
            stream.cuda_stream)]
        assert int(chains.abs().sum()) == 0


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
    """chip_smoke.py's phase 8 for one shape: the forward and backward
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
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
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
        "sorted_segment_sum": 0, "flash_attention_fwd": 1,
        "flash_attention_bwd": 1, "tokenize_boundaries": 0}
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


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_is_one_kernel_and_repeats_its_bits(cuda, causal):
    """One call of kernels.flash_attention_fwd runs one kernel
    (flash_fwd_kernel) and no memset, counted from a captured CUDA graph
    (and by torch.profiler where CUPTI traces), and a second call gives the
    same bits, at a ragged T under GQA."""
    rng = np.random.RandomState(4)
    b, t, h, hk, d = 2, 1000, 8, 2, 64
    q, k, v = (torch.tensor(rng.randn(*shape).astype(np.float32),
                            device=cuda)
               for shape in ((b, t, h, d), (b, t, hk, d), (b, t, hk, d)))

    def call():
        return kernels.flash_attention_fwd(q, k, v, causal)

    ops = one_call_ops(call)
    require_one_kernel(ops, "flash_attention_fwd", "flash_fwd_kernel")
    first, again = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_is_one_kernel_and_leaves_its_flags_at_zero(cuda,
                                                                 causal):
    """One call of kernels.flash_attention_bwd runs one kernel
    (flash_bwd_kernel) and no memset, counted from a captured CUDA graph
    (and by torch.profiler where CUPTI traces); afterwards the stream's
    flags (the work counters and every dQ flag) are back at 0, so the next
    call needs no memset either, and a second call gives the same bits."""
    rng = np.random.RandomState(3)
    b, t, h, hk, d = 2, 1000, 8, 2, 64
    q, k, v, dout = (torch.tensor(rng.randn(*shape).astype(np.float32),
                                  device=cuda)
                     for shape in ((b, t, h, d), (b, t, hk, d), (b, t, hk, d),
                                   (b, t, h, d)))
    out, lse = kernels.flash_attention_fwd(q, k, v, causal)
    delta = (dout * out).sum(-1).transpose(1, 2).contiguous()

    def call():
        return kernels.flash_attention_bwd(q, k, v, dout, lse, delta, causal)

    ops = one_call_ops(call)
    require_one_kernel(ops, "flash_attention_bwd", "flash_bwd_kernel")
    first, again = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    stream = torch.cuda.current_stream(q.device)
    sync = kernels._ARRIVAL_COUNTERS[("flash_attention_bwd", q.device.index,
                                      stream.cuda_stream)]
    assert int(sync.abs().sum()) == 0


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
    assert kernels.sorted_segment_sum.launches == (2 * 8 if layout == "csr"
                                                   else 0)
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
    """The Python stack's row iterator on the card and on the CPU: the
    same RowBlock, bit for bit, with one kernel launch a non-empty chunk
    part. Its PipelinedParser parses each chunk whole on one of its
    workers; the unthreaded parser's nthread=2 pool splits a chunk of 4096
    bytes or more in two. create_row_block_iter's native route launches
    no kernel and gives the same rows."""
    from chip_smoke import python_stack_parser
    from dmlc_tpu_torch.data.row_iter import BasicRowIter

    path = _write_svm(tmp_path / "t.svm", 3000)
    kernels.reset_launch_counts()
    got = next(iter(BasicRowIter(python_stack_parser(path, cuda,
                                                     nthread=1))))
    launches = kernels.tokenize_boundaries.launches
    want = next(iter(BasicRowIter(python_stack_parser(path, "cpu"))))
    assert launches == 1  # one chunk, one part, under 8 MiB
    for name in ("offset", "label", "index", "value"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    kernels.reset_launch_counts()
    again = next(iter(BasicRowIter(python_stack_parser(path, cuda))))
    assert kernels.tokenize_boundaries.launches == 1
    assert np.array_equal(again.index, want.index)
    kernels.reset_launch_counts()
    native = next(iter(create_row_block_iter(path)))
    assert kernels.tokenize_boundaries.launches == 0
    assert np.array_equal(native.index, want.index)
    assert np.array_equal(native.offset, want.offset)
    kernels.reset_launch_counts()
    parser = create_parser(path, nthread=2, threaded=False)
    try:
        split = parser.next_block()
    finally:
        parser.close()
    assert kernels.tokenize_boundaries.launches == 2
    assert np.array_equal(split.index, want.index)


def _pooled_parser(path, device, procs, chunk=16 << 10):
    from dmlc_tpu_torch.data import LibSVMParser, PipelinedParser
    from dmlc_tpu_torch.io import create_input_split

    split = create_input_split(path, 0, 1, "text", threaded=False)
    split.hint_chunk_size(chunk)
    return PipelinedParser(LibSVMParser(split, 1, device), nthread=2,
                           procs=procs)


def test_pooled_read_on_the_card_counts_the_pools_launches(
        cuda, tmp_path, monkeypatch):
    """procs=2 on the card: the CPU route's block, bit for bit, with one
    tokenize_boundaries launch, made in a pool process on the card and
    added to this process's count, for each non-empty chunk. A pool whose
    processes see no card raises DMLCError at the first chunk: it never
    tokenizes on the host."""
    from dmlc_tpu_torch.data import RowBlockContainer
    from dmlc_tpu_torch.io import create_input_split
    from dmlc_tpu_torch.utils import DMLCError

    path = _write_svm(tmp_path / "p.svm", 3000)
    split = create_input_split(path, 0, 1, "text", threaded=False)
    split.hint_chunk_size(16 << 10)
    chunks = 0
    while (chunk := split.next_chunk()) is not None:
        chunks += bool(chunk)
    split.close()
    assert chunks > 4

    def read(device, procs):
        parser = _pooled_parser(path, device, procs)
        whole = RowBlockContainer()
        try:
            for block in parser:
                whole.push_block(block)
            assert parser.stats()["procs"] == procs
        finally:
            parser.close()
        return whole.to_block()

    kernels.reset_launch_counts()
    got = read(cuda, 2)
    assert kernels.tokenize_boundaries.launches == chunks
    want = read("cpu", 0)
    for name in ("offset", "label", "index", "value"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name

    torch.zeros(1, device=cuda)  # this process's context is made
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the pool's alone
    kernels.reset_launch_counts()
    parser = _pooled_parser(path, cuda, 2)
    try:
        with pytest.raises(DMLCError, match="no CUDA device"):
            parser.next_block()
    finally:
        parser.close()
    assert kernels.tokenize_boundaries.launches == 0


def test_remote_s3_read_on_the_card_matches_cpu(cuda, tmp_path,
                                                monkeypatch):
    """A libsvm file of several 8 MiB chunks read from the fake s3:// on
    the card (chip_smoke.py phase 22 at a small size): on the native push
    route no tokenizer launch, on the Python stack one a non-empty chunk
    part, and each the rows of the same route's CPU read of the local
    file, bit for bit."""
    from chip_smoke import (count_parts, python_stack_parser, read_all,
                            same_blocks)
    from dmlc_tpu_torch.data.row_iter import BasicRowIter
    from dmlc_tpu_torch.io import filesystem
    from dmlc_tpu_torch.io.object_store import S3FileSystem
    from fake_object_store import serve  # tests/, on the path under pytest

    path = str(tmp_path / "remote.svm")
    write_criteo(path, 60_000, seed=21)
    server, store, base = serve()
    try:
        monkeypatch.setenv("S3_ENDPOINT", base)
        monkeypatch.setenv("no_proxy", "127.0.0.1,localhost")
        filesystem.register_filesystem("s3://", lambda uri: S3FileSystem())
        with open(path, "rb") as fh:
            store.objects[("bkt", "remote.svm")] = fh.read()
        kernels.reset_launch_counts()
        with count_parts() as parts:
            card, _ = read_all(create_row_block_iter("s3://bkt/remote.svm"))
        launches = kernels.tokenize_boundaries.launches
        kernels.reset_launch_counts()
        with count_parts() as py_parts:
            py_card, _ = read_all(BasicRowIter(python_stack_parser(
                "s3://bkt/remote.svm", cuda)))
        py_launches = kernels.tokenize_boundaries.launches
    finally:
        server.shutdown()
        server.server_close()
    cpu, _ = read_all(create_row_block_iter(path, device="cpu"))
    assert launches == len(parts) == 0
    same_blocks("the s3:// read on the card", card, cpu)
    assert len(card) == 60_000
    py_cpu, _ = read_all(BasicRowIter(python_stack_parser(path, "cpu")))
    assert py_launches == len(py_parts) > 2
    same_blocks("the s3:// Python-stack read on the card", py_card, py_cpu)


# ---------------------------------------------------------------------------
# GBDT and the sharded SpMV (chip_smoke.py phases 14-15)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nodes,channels", [(1, 1), (8, 1), (32, 3)])
def test_gbdt_histogram_on_the_card_matches_cpu(cuda, nodes, channels):
    """Integer (g, h): every cell's sum is exact, so the card's histogram
    (stable sort, serial segment sums) equals the CPU route bit for bit,
    and repeats its bits."""
    from dmlc_tpu_torch.models import gbdt

    rng = np.random.RandomState(nodes)
    n, f, bins = 20000, 28, 256
    xb = rng.randint(0, bins, (n, f)).astype(np.uint8)
    node = rng.randint(0, nodes, n).astype(np.int32)
    shape = (n,) if channels == 1 else (n, channels)
    g = rng.randint(-4, 5, shape).astype(np.float32)
    h = rng.randint(0, 3, shape).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xb, node, g, h)]
    want = gbdt._level_histogram(*args, nodes, bins)
    got = gbdt._level_histogram(*[a.to(cuda) for a in args], nodes, bins)
    again = gbdt._level_histogram(*[a.to(cuda) for a in args], nodes, bins)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_gbdt_row_mask_on_the_card_matches_host(cuda, n):
    """The row draw made on the card (int64 threefry) equals the host's
    numpy draw bit for bit."""
    from dmlc_tpu_torch.utils import prng

    key = prng.fold_in(prng.fold_in(prng.PRNGKey(7), 3), 2)
    got = prng.uniform(key, n, cuda)
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert got.cpu().numpy().tobytes() == prng.uniform(key, n).tobytes()


def test_gbdt_squared_tree_on_the_card_matches_cpu(cuda):
    """One squared-loss tree on integer labels: features, bins and leaves
    equal the CPU route's bits."""
    from dmlc_tpu_torch.models import GBDTLearner

    rng = np.random.RandomState(3)
    x = rng.randint(-8, 9, (4096, 10)).astype(np.float32)
    y = rng.randint(-3, 4, 4096).astype(np.float32)
    hyper = dict(objective="squared", num_trees=1, max_depth=6)
    card = GBDTLearner(**hyper)
    card.fit(x, y)
    cpu = GBDTLearner(device="cpu", **hyper)
    cpu.fit(x, y)
    assert card.edges.tobytes() == cpu.edges.tobytes()
    for k in ("feature", "bin", "leaf"):
        assert card.trees[k].cpu().numpy().tobytes() == \
            cpu.trees[k].numpy().tobytes(), k


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_spmv_through_coo_segment_sum(cuda, shards):
    """Each section of a ShardedCSRBatch through the sharded SpMV on the
    card (one coo_segment_sum launch a section) against ``spmv`` of the
    whole batch on the CPU, bit for bit on integer data."""
    from dmlc_tpu_torch.data.row_block import RowBlock
    from dmlc_tpu_torch.device import csr
    from dmlc_tpu_torch.ops.spmv import make_sharded_spmv, spmv

    rng = np.random.RandomState(shards)
    batch, nf = 8192, 1 << 12
    counts = rng.randint(0, 40, batch - 100)
    index = np.concatenate([np.sort(rng.choice(nf, c, replace=False))
                            for c in counts]).astype(np.uint32)
    block = RowBlock(offset=np.concatenate([[0], np.cumsum(counts)]),
                     label=np.zeros(len(counts), np.float32), index=index,
                     value=rng.randint(-3, 4, len(index)).astype(np.float32))
    sharded = csr.pad_to_bucket_sharded(block, batch, shards)
    w = torch.tensor(rng.randint(-2, 3, nf).astype(np.float32))
    rows = torch.from_numpy(np.repeat(np.arange(len(counts)), counts))
    want = spmv(torch.from_numpy(block.value),
                torch.from_numpy(index.astype(np.int32)), rows, w, batch)
    local = make_sharded_spmv(batch // shards)
    kernels.reset_launch_counts()
    got = torch.cat([local(*(torch.from_numpy(sec[k]).to(cuda)
                             for k in ("values", "indices", "offsets")),
                           w.to(cuda))
                     for sec in map(sharded.section, range(shards))])
    assert kernels.KERNELS["coo_segment_sum"].launches == shards
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("cols", FM_SEG_COLS + (SEG_WIDE_COLS,))
@pytest.mark.parametrize("case", ["criteo batch"] + sorted(SEG_EDGE_CASES))
def test_column_coo_segment_sum_matches_plain_and_1d(cuda, case, cols):
    """chip_smoke.py's phase 16 (a): the [E, C] call bit-equal to its plain
    version on integer data, each column bit-equal to the [E] call on it,
    the same bits twice; one counted launch a call."""
    if case == "criteo batch":
        counts = np.full(8192, 39)
        offsets = torch.tensor(np.minimum(np.concatenate(
            [[0], np.cumsum(counts)]), 327_680).astype(np.int32),
            device=cuda)
        ids, rows = expand_row_ids(offsets, 327_680).cpu().numpy(), 8192
    else:
        ids, rows = SEG_EDGE_CASES[case]
    before = kernels.coo_segment_sum.launches
    hold_seg_sum_cols(kernels, cuda, case, ids, rows, cols)
    assert kernels.coo_segment_sum.launches == before + 2 + cols


def test_feature_segment_sum_columns_repeat_their_bits(cuda):
    from dmlc_tpu_torch.ops.spmv import feature_segment_sum

    rng = np.random.RandomState(1)
    entries, nfeat, k = 200_000, 1 << 14, 8
    indices = torch.tensor(rng.randint(0, 256, entries).astype(np.int32),
                           device=cuda)
    contrib = torch.tensor(rng.randn(entries, k).astype(np.float32),
                           device=cuda)
    first = feature_segment_sum(contrib, indices, nfeat)
    torch.use_deterministic_algorithms(True)
    try:
        det = feature_segment_sum(contrib, indices, nfeat)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(first, det)
    for _ in range(3):
        assert torch.equal(first, feature_segment_sum(contrib, indices,
                                                      nfeat))
    np.testing.assert_allclose(
        first.cpu().numpy(),
        feature_segment_sum(contrib.cpu(), indices.cpu(), nfeat).numpy(),
        rtol=1e-5, atol=1e-5)


FEATURE_SUM_CASES = {name: (ids, nf) for name, ids, nf
                     in feature_sum_cases()}


def _fm_scale(rng, entries, cols):
    """Contributions at FM's scale: values in [0, 1) times 0.1 N(0, 1)."""
    return (rng.rand(entries, 1) * 0.1 * rng.randn(entries, cols)).astype(
        np.float32)


def _exact_sum(contrib, ids, num_features):
    """The sums in float64 on the CPU, from float32 contributions."""
    return torch.zeros((num_features,) + tuple(contrib.shape[1:]),
                       dtype=torch.float64).index_add_(
        0, ids.cpu().long(), contrib.cpu().double())


@pytest.mark.parametrize("cols", FEATURE_SUM_COLS)
def test_sorted_segment_sum_at_the_cell_shape(cuda, cols):
    """``sorted_segment_sum``, the route of ``feature_segment_sum``, at one
    step of the criteo-fm cell (638,976 Zipf ids of 1,000,001, the
    commonest holding 1.29 % of the entries), as dv's [E, 8] and as FM's
    packed [E, 9] (gw apart). Integer data: the CPU route's bits, the same
    bits twice and on a second stream, one launch a call. Float data at
    FM's scale: the same bits over three runs; the bits of the kernel's
    order (``sorted_sum_order``) and of the ``index_put_`` route before
    it; the row columns (dv) the CPU route's bits, the vector column (gw)
    within rtol 1e-5 / atol 1e-5 of the float64 sum; +0.0 at every
    untouched feature."""
    ids = cell_feature_ids(3)
    counts = np.bincount(ids, minlength=CELL_FEATURES)
    assert counts.max() >= 0.0128 * len(ids)
    hold_feature_sum(kernels, cuda, "criteo-fm step", ids, CELL_FEATURES,
                     cols)
    apart = cols == FM_PACKED_COLS
    contrib = torch.tensor(_fm_scale(np.random.RandomState(cols), len(ids),
                                     cols), device=cuda)
    ids_t = torch.tensor(ids, device=cuda)
    before = kernels.sorted_segment_sum.launches
    runs = [kernels.sorted_segment_sum(contrib, ids_t, CELL_FEATURES, apart)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert kernels.sorted_segment_sum.launches == before + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert torch.equal(runs[0], index_put_route(contrib, ids_t,
                                                CELL_FEATURES, apart))
    got = runs[0].cpu()
    vc = kernels.vector_columns(contrib, apart)
    assert got.numpy().tobytes() == sorted_sum_order(
        contrib.cpu().numpy(), ids, CELL_FEATURES, vc).tobytes()
    cpu = kernels.sorted_segment_sum_plain(contrib.cpu(), ids_t.cpu(),
                                           CELL_FEATURES)
    assert torch.equal(got[:, vc:], cpu[:, vc:])
    np.testing.assert_allclose(
        got[:, :vc].numpy(),
        _exact_sum(contrib[:, :vc], ids_t, CELL_FEATURES).numpy(),
        rtol=1e-5, atol=1e-5)
    untouched = torch.tensor(counts == 0)
    assert untouched.sum() > 0
    assert not got[untouched].view(torch.int32).any()


def test_sorted_segment_sum_1d_keeps_index_puts_bits(cuda):
    """At the criteo-fm cell's step, as the csr fit's gradient ([E]): the
    bits of ``index_put_`` with ``accumulate=True``, the route before,
    whose order the kernel keeps (the plain reference of the FM cells
    takes w's gradient through it)."""
    ids = torch.tensor(cell_feature_ids(5), device=cuda)
    contrib = torch.tensor(_fm_scale(np.random.RandomState(5), len(ids), 1),
                           device=cuda)[:, 0].contiguous()
    got = kernels.sorted_segment_sum(contrib, ids, CELL_FEATURES)
    assert torch.equal(got, index_put_route(contrib, ids, CELL_FEATURES))


def test_fm_packed_sum_is_the_two_calls(cuda):
    """FM's packed [E, 9] call at the criteo-fm cell's step, gw apart, on
    float data: column 0 bit-equal to the [E] call on it (the csr fit's
    order: gw keeps the linear fit's bits), columns 1..8 to the [E, 8]
    call on them (dv's)."""
    ids = torch.tensor(cell_feature_ids(4), device=cuda)
    contrib = torch.tensor(_fm_scale(np.random.RandomState(4), len(ids), 9),
                           device=cuda)
    got = kernels.sorted_segment_sum(contrib, ids, CELL_FEATURES, True)
    gw = kernels.sorted_segment_sum(contrib[:, 0].contiguous(), ids,
                                    CELL_FEATURES)
    gv = kernels.sorted_segment_sum(contrib[:, 1:].contiguous(), ids,
                                    CELL_FEATURES)
    assert torch.equal(got[:, 0], gw)
    assert torch.equal(got[:, 1:], gv)


@pytest.mark.parametrize("cols", (0,) + FEATURE_SUM_COLS)
@pytest.mark.parametrize("case", sorted(FEATURE_SUM_CASES))
def test_sorted_segment_sum_edge_cases(cuda, case, cols):
    """No entries, one id holding every entry, a run over more than 32
    tiles, ids in no order with untouched features between and after
    them; [E] (``cols`` 0), [E, 8] and [E, 9]: on integer data the CPU
    route's bits, the same bits twice and on a second stream, one launch
    a call."""
    ids, nf = FEATURE_SUM_CASES[case]
    got = hold_feature_sum(kernels, cuda, case, ids, nf, cols)
    untouched = torch.tensor(np.bincount(ids, minlength=nf) == 0,
                             device=cuda)
    assert not got[untouched].view(torch.int32).any()


def test_fm_fit_on_the_card_launches_one_kernel_a_step(cuda, tmp_path):
    from dmlc_tpu_torch.models import (FMLearner, fm_params_from_numpy,
                                       fm_params_to_numpy, init_fm_params)

    path = tmp_path / "d.libfm"
    rng = np.random.RandomState(2)
    path.write_text("".join(
        "%d %s\n" % (i % 2, " ".join(
            "%d:%d:%.3f" % (f, j, rng.rand()) for f, j in enumerate(
                np.sort(rng.choice(np.arange(1, 300), 6, replace=False)))))
        for i in range(1000)))
    start = fm_params_to_numpy(init_fm_params(300, 4, 0.1, device="cpu"))
    fits = {}
    for device in ("cuda", "cpu"):
        learner = FMLearner(device=device, num_features=300, num_factors=4,
                            learning_rate=0.2)
        learner.params = fm_params_from_numpy(start, learner.device)
        feed = DeviceFeed(create_parser(str(path), data_format="libfm",
                                        device=learner.device),
                          BatchSpec(batch_size=128, layout="csr",
                                    num_features=300),
                          device=learner.device)
        kernels.reset_launch_counts()
        try:
            fits[device] = learner.fit_feed(feed, 2)
        finally:
            feed.close()
        if device == "cuda":
            assert kernels.coo_segment_sum.launches == 2 * 8
            assert kernels.sorted_segment_sum.launches == 2 * 8
    np.testing.assert_allclose(fits["cuda"], fits["cpu"], rtol=1e-5)


def test_crash_recover_csr_fit_through_the_launcher(cuda, tmp_path):
    """World 2 through ``python -m dmlc_tpu_torch.tracker.submit``: a clean
    run, then rank 1 crashing as it starts round 2, relaunched, both
    replaying from the checkpoint. ``drive_recovery`` holds each rank's
    ``coo_segment_sum`` launches to its steps and its tokenizer launches
    to 0 (the native route); 39,864 rows give each rank 3 steps a round."""
    path = str(tmp_path / "criteo.svm")
    write_criteo(path, 39_864, seed=12)
    kernels._lib()  # the rank processes load it
    out = drive_recovery(path, str(tmp_path), parts=("clean", "crash"))
    assert out["crash"]["digest"] == out["clean"]["digest"]
    for rep in out["crash"]["ranks"].values():
        assert rep["launches"]["coo_segment_sum"] == rep["steps"] > 0
    assert out["crash"]["ranks"][1]["attempt"] == 1


# ---------------------------------------------------------------------------
# the observability layer on the card
# ---------------------------------------------------------------------------


def test_probed_peaks_are_positive_on_the_card(cuda):
    from dmlc_tpu_torch.obs import xla_cost

    xla_cost.reset()
    # cuBLAS's workspace, which a process keeps from its first matmul on,
    # is made before the reading
    torch.ones(8, 8, device=cuda) @ torch.ones(8, 8, device=cuda)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(cuda)
    try:
        assert xla_cost.probed_peak_flops() > 1e12
        assert xla_cost.probed_hbm_gbps() > 100
    finally:
        xla_cost.reset()
    # the probes' private pool is released: the allocator keeps none of it
    assert torch.cuda.memory_reserved(cuda) == reserved


def test_hbm_gauge_equals_memory_allocated(cuda):
    from dmlc_tpu_torch.obs import device_telemetry
    from dmlc_tpu_torch.obs.metrics import Registry

    keep = torch.empty(1 << 20, device=cuda)
    torch.cuda.synchronize()
    reg = Registry()
    out = device_telemetry.sample(reg)
    label = "cuda:%d" % torch.cuda.current_device()
    assert out["hbm"][label] == torch.cuda.memory_allocated(cuda)
    flat = reg.flat_values()
    assert flat['dmlc_device_hbm_bytes{device="%s"}' % label] == \
        torch.cuda.memory_allocated(cuda)
    assert flat['dmlc_device_hbm_limit_bytes{device="%s"}' % label] == \
        torch.cuda.mem_get_info(cuda)[1]
    assert device_telemetry.peak_hbm_bytes() >= keep.numel() * 4


def test_capture_profile_writes_cuda_kernels(cuda, tmp_path):
    import json

    from dmlc_tpu_torch.obs import device_telemetry

    x = torch.randn(2048, 2048, device=cuda)
    th = device_telemetry.capture_profile(1.0, out_dir=str(tmp_path))
    for _ in range(200):
        x = x @ x * 1e-3
    torch.cuda.synchronize()
    th.join()
    events = json.loads(
        (tmp_path / "profile-rank0-req0" / "trace.json").read_text())
    kernels_seen = [e for e in events.get("traceEvents", [])
                    if e.get("cat") == "kernel"]
    assert kernels_seen


def test_capture_profile_raises_its_error_on_the_card(cuda, tmp_path):
    from dmlc_tpu_torch.obs import device_telemetry

    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    with pytest.raises(OSError):
        device_telemetry.capture_profile(0.1, out_dir=str(blocker))


def test_a_recording_reads_the_peak_and_keeps_the_callers(cuda):
    from dmlc_tpu_torch.obs import device_telemetry, xla_cost
    from dmlc_tpu_torch.obs.metrics import Registry

    xla_cost.reset()
    torch.cuda.synchronize()
    big = torch.empty(1 << 26, device=cuda)  # 256 MiB, then freed
    del big
    high = torch.cuda.max_memory_allocated(cuda)
    x = torch.ones(1 << 20, device=cuda)
    step = device_telemetry.InstrumentedStep(
        lambda t: (t * 2 + 1).sum(), "t.card", reg=Registry())
    step(x)
    rec = xla_cost.per_fn()["t.card"]
    # t * 2 and + 1 are 4 MiB each, alive together for the add
    assert rec["peak_bytes"] >= 2 * x.numel() * 4
    assert torch.cuda.max_memory_allocated(cuda) == high
    xla_cost.reset()


def test_fleet_fed_csr_fit_equals_the_local_card_fit(cuda, tmp_path,
                                                     monkeypatch):
    """A one-worker data-service fleet on the card (the worker parses each
    leased part on the native route; its source cache off, so every epoch
    parses) feeds the csr fit one job an epoch: losses and params equal
    the local card fit's bit for bit, one ``coo_segment_sum`` a step, no
    tokenizer launch."""
    from dmlc_tpu_torch.data import (BlockService, DataDispatcher,
                                     RemoteBlockParser, reset_source_cache)
    from dmlc_tpu_torch.models import params_to_numpy

    monkeypatch.setenv("DMLC_TPU_DATA_CACHE_MB", "0")
    reset_source_cache()
    path = str(tmp_path / "criteo.svm")
    write_criteo(path, 4096, seed=21)
    nf, bs, epochs, nchunks = (1 << 20) + 1, 512, 2, 6
    local = LinearLearner(device=cuda, objective="logistic",
                          learning_rate=0.1)
    want = local.fit_uri(path, batch_size=bs, epochs=epochs, layout="csr",
                         num_features=nf)
    learner = LinearLearner(device=cuda, objective="logistic",
                            learning_rate=0.1)
    history = []
    kernels.reset_launch_counts()
    with DataDispatcher() as disp:
        for e in range(epochs):
            disp.add_job("csr%d" % e, path, nchunks=nchunks)
        with BlockService(dispatcher=disp.address, nthread=2, device=cuda):
            for e in range(epochs):
                feed = DeviceFeed(
                    RemoteBlockParser(disp.address, dispatcher=True,
                                      job="csr%d" % e, device=cuda),
                    BatchSpec(batch_size=bs, layout="csr", num_features=nf),
                    device=cuda)
                history = learner.fit_feed(feed, epochs=e + 1,
                                           start_epoch=e, history=history)
                feed.close()
            assert disp.join(timeout=60), disp.snapshot()
    torch.cuda.synchronize()
    assert history == want
    got, ref = params_to_numpy(learner.params), params_to_numpy(local.params)
    for k in ("w", "b"):
        assert np.array_equal(got[k], ref[k]), k
    assert kernels.coo_segment_sum.launches == epochs * (-(-4096 // bs))
    assert kernels.tokenize_boundaries.launches == 0
    reset_source_cache()


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_the_card_feed_at_every_depth_is_the_cpu_feed(cuda, tmp_path,
                                                      layout):
    """The feed on the card (pinned staging filled by the producer thread,
    copies on the consumer's stream) at depth 0 and 2 and window 1 and 2:
    every batch equal bit for bit to the CPU feed's, staged in C++ on the
    native route (no tokenizer launch), and the pool growing to its
    in-flight depth only."""
    path = str(tmp_path / "c.svm")
    write_criteo(path, 20000, seed=5)
    spec = dict(batch_size=1024, layout=layout,
                num_features=40 if layout == "dense" else (1 << 20) + 1)

    def batches(device, depth, window):
        feed = DeviceFeed(create_parser(path, device=device),
                          BatchSpec(prefetch=window, **spec), device=device,
                          host_prefetch=depth)
        try:
            out = [{k: (v.cpu().numpy().copy() if torch.is_tensor(v)
                        else v) for k, v in b.items()} for b in feed]
            pool = feed.pool.stats() if feed.pool is not None else None
        finally:
            feed.close()
        return out, pool

    want, _ = batches("cpu", 0, 1)
    for depth, window in ((0, 1), (2, 1), (2, 2)):
        kernels.reset_launch_counts()
        got, pool = batches(cuda, depth, window)
        assert kernels.tokenize_boundaries.launches == 0
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                assert np.array_equal(g[k], w[k]), (depth, window, k)
        arrays = 3 if layout == "dense" else 5
        # a set a batch in flight, plus the short last batch's smaller
        # csr entry bucket (its indices and values)
        extra = 0 if layout == "dense" else 2
        assert pool["allocated"] <= arrays * (depth + window + 3) + extra
        assert pool["allocated"] + pool["reused"] == arrays * len(got)


def test_profile_request_on_the_heartbeat_captures_coo_segment_sum(
        cuda, tmp_path, monkeypatch):
    """A status plane's /profile request reaches a publisher on its
    heartbeat ack; the torch.profiler window it starts holds the csr
    step's coo_segment_sum kernel."""
    import json
    import time
    import urllib.request

    from dmlc_tpu_torch.obs import flight, plane
    from dmlc_tpu_torch.tracker.rendezvous import RabitTracker

    monkeypatch.setenv("DMLC_TPU_STATUS_PORT", "0")
    monkeypatch.delenv("DMLC_TASK_ID", raising=False)
    path = _write_svm(tmp_path / "d.svm", 1000)
    flight.configure(str(tmp_path), install=False)
    tracker = RabitTracker("127.0.0.1", 1, port=21990, port_end=22000)
    pub = None
    try:
        tracker.start(1)
        pub = plane.ObsPublisher("127.0.0.1", tracker.port, rank=0)
        url = "http://127.0.0.1:%d/profile?seconds=2" % tracker.status.port
        with urllib.request.urlopen(url, timeout=10) as resp:
            assert json.loads(resp.read())["profile_req"] == 1
        assert pub.publish(epoch=1) is True  # the ack starts the window
        kernels.reset_launch_counts()
        LinearLearner(objective="logistic").fit_uri(
            path, batch_size=128, epochs=2, layout="csr", num_features=30)
        torch.cuda.synchronize()
        assert kernels.KERNELS["coo_segment_sum"].launches == 16
        out = tmp_path / "profile-rank0-req1" / "trace.json"
        deadline = time.time() + 60
        while not out.exists() and time.time() < deadline:
            time.sleep(0.1)
        events = json.loads(out.read_text())["traceEvents"]
    finally:
        if pub is not None:
            pub.close()
        tracker.close()
        flight.reset()
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    assert any("seg_sum_kernel" in n for n in names), sorted(names)[:20]


def test_device_span_reads_the_stream_and_waits_without_a_sync(
        cuda, monkeypatch):
    """A device span's pair of CUDA events: unfinished on the stream it
    stays pending (resolution never synchronizes); once done it reads more
    than 0 ms and no more than the host's wall time around it."""
    import time

    from dmlc_tpu_torch import obs
    from dmlc_tpu_torch.obs import trace

    monkeypatch.delenv("DMLC_TPU_TRACE", raising=False)
    monkeypatch.setattr(trace, "_listeners", [])
    trace.clear()
    trace.add_listener(lambda event: None)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs.device_span("probe", cuda):
            torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream
        assert trace.resolve_device_spans() == 1
        assert trace.device_span_totals() == {}
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        assert trace.resolve_device_spans() == 0
        got = trace.device_span_totals()["probe"]
        assert got["count"] == 1 and 0.0 < got["ms"] <= wall_ms
    finally:
        trace.clear()

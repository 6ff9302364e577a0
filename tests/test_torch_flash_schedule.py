"""The work order of the flash backward kernel
(``dmlc_tpu_torch/ops/csrc/flash_attention_bwd.cu``), simulated on the CPU.

The kernel runs a persistent grid: each CTA takes work items (K/V tile n,
b, KV head) from an int32 counter, in the order n = 0 up to num_n - 1 with
the (b, KV head) pairs interleaved within each n, and walks the item's Q
tiles from the last one down (to the diagonal when causal), each Q tile
for every query head of the group in turn. Each (Q tile, K/V tile) pair
adds a dQ part to an f32 sum; a part waits until the parts of every lower
K/V tile for that Q tile are in. This file reads the tile sizes and the
order from the kernel source, simulates ``SMS`` workers (the H100's 132
SMs, each CTA one tile a step) at the attention path's shape and at every
``chip_smoke.FLASH_CASES`` shape, and asserts that every wait points to an
item taken earlier, that the run ends, that every part is added exactly
once, in ascending K/V-tile order, and that its waits cost no steps
against the mirror image (the highest K/V tile first, walks from the
diagonal up), which never waits when causal but leaves a longer tail: the
longest walks come last.

The forward kernel (``flash_attention_fwd.cu``) runs one CTA per (Q tile,
b, h) in a fixed order, the heaviest causal Q tiles first with all heads
of one Q tile side by side; the last part of this file reads its tile
sizes and that order from the source and simulates the grid on ``SMS``
SMs, one CTA an SM, each SM taking the next CTA when it is free.
"""

import re
from pathlib import Path

import pytest

from chip_smoke import ATTN_DIM, ATTN_HEADS, FLASH_CASES, PATH_T
from dmlc_tpu_torch.ops import kernels

SRC = Path(kernels.__file__).parent / "csrc" / "flash_attention_bwd.cu"
FWD_SRC = Path(kernels.__file__).parent / "csrc" / "flash_attention_fwd.cu"
SMS = 132
PATH_SHAPE = (1, PATH_T, ATTN_HEADS, ATTN_HEADS, ATTN_DIM, True)


def source_constants(src=SRC):
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src.read_text())}


def work_items(b, t, h, hk, causal, mirror=False):
    """[(n, b, hk, [(h, m), ...])] in the order the counter hands them
    out: the kernel's decode of item i and its walk, or (``mirror``) the
    highest K/V tile first, each walk from the diagonal up, head by head."""
    kv, qr = kernels.FLASH_BWD_KV_ROWS, kernels.FLASH_BWD_Q_ROWS
    num_n, num_m, group = -(-t // kv), -(-t // qr), h // hk
    out = []
    for item in range(num_n * b * hk):
        n = num_n - 1 - item // (b * hk) if mirror else item // (b * hk)
        bb, kh = (item % (b * hk)) // hk, item % hk
        m_first = n * kv // qr if causal else 0
        if mirror:
            walk = [(kh * group + g, m) for g in range(group)
                    for m in range(m_first, num_m)]
        else:
            walk = [(kh * group + g, m)
                    for m in range(num_m - 1, m_first - 1, -1)
                    for g in range(group)]
        out.append((n, bb, kh, walk))
    return out


def simulate(b, t, h, hk, causal, workers=SMS, mirror=False):
    """Run the grid one step at a time (each busy worker adds at most one
    part a step, all of a step's parts visible from the next); returns
    (parts in the order added per (b, h, Q tile), steps, waits, the item
    each wait pointed to against the waiting item)."""
    kv, qr = kernels.FLASH_BWD_KV_ROWS, kernels.FLASH_BWD_Q_ROWS
    num_n = -(-t // kv)
    items = work_items(b, t, h, hk, causal, mirror)
    index = {(n, bb, kh): i for i, (n, bb, kh, _) in enumerate(items)}

    def order(m):  # the K/V tiles that touch Q tile m, in adding order
        top = min(num_n - 1, (m * qr + qr - 1) // kv) if causal else num_n - 1
        return list(range(top, -1, -1)) if mirror else list(range(top + 1))

    added, pointers = {}, []
    slots, taken, finished, steps, waits = [None] * workers, 0, 0, 0, 0
    while finished < len(items):
        progressed, done_now = False, []
        for w in range(workers):
            if slots[w] is None:
                if taken == len(items):
                    continue
                slots[w], taken, progressed = [taken, 0], taken + 1, True
            i, pos = slots[w]
            n, bb, kh, tiles = items[i]
            if pos == len(tiles):
                slots[w], finished, progressed = None, finished + 1, True
                continue
            hh, m = tiles[pos]
            parts = added.setdefault((bb, hh, m), [])
            want = order(m)
            before = want[:want.index(n)]
            if before:
                pointers.append((index[(before[-1], bb, kh)], i))
            if parts == before:
                done_now.append((w, parts, n))
            else:
                waits += 1
        for w, parts, n in done_now:
            parts.append(n)
            slots[w][1] += 1
            progressed = True
        assert progressed, "no worker could move: the order deadlocks"
        steps += 1
    return added, steps, waits, pointers


CASES = [PATH_SHAPE] + list(FLASH_CASES)


def test_tile_rows_match_the_kernel_source():
    """kernels.FLASH_BWD_KV_ROWS / FLASH_BWD_Q_ROWS size the wrapper's
    flags and this simulation; the kernel's kKvRows / kQRows are the
    truth."""
    consts = source_constants()
    assert consts["kKvRows"] == kernels.FLASH_BWD_KV_ROWS
    assert consts["kQRows"] == kernels.FLASH_BWD_Q_ROWS
    assert kernels.flash_bwd_sync_ints(2, 1000, 8) == 2 + 2 * 8 * -(
        -1000 // consts["kQRows"])


def test_item_order_is_read_from_the_kernel_source():
    """The simulation's decode of an item index and its walk are the
    kernel's: K/V tile 0 first, (b, KV head) pairs interleaved; each walk
    from the last Q tile down to the diagonal (causal), the group's heads
    inside; parts added from K/V tile 0 up to n_hi."""
    src = " ".join(SRC.read_text().split())
    for line in ("const int n_idx = item / (B * Hkv);",
                 "const int b = (item % (B * Hkv)) / Hkv;",
                 "const int hk = item % Hkv;",
                 "const int m_first = kCausal ? n0 / kQRows : 0;",
                 "const int tiles = group * (num_m - m_first);",
                 "if (++g == group) { g = 0; --m; }",
                 "int g = 0, m = num_m - 1;",
                 "kCausal ? min(num_n - 1, (m0 + kQRows - 1) / kKvRows) "
                 ": num_n - 1;",
                 "const bool first = n_idx == 0;",
                 "const bool last = n_idx == n_hi;",
                 "wait_flag(flag, n_idx);"):
        assert line in src, line


@pytest.mark.parametrize("case", CASES, ids=str)
def test_every_part_added_once_in_ascending_order(case):
    b, t, h, hk, d, causal = case
    added, steps, waits, pointers = simulate(b, t, h, hk, causal)
    kv, qr = kernels.FLASH_BWD_KV_ROWS, kernels.FLASH_BWD_Q_ROWS
    num_n, num_m = -(-t // kv), -(-t // qr)
    assert set(added) == {(bb, hh, m) for bb in range(b) for hh in range(h)
                          for m in range(num_m)}
    for (_, _, m), parts in added.items():
        top = min(num_n - 1, (m * qr + qr - 1) // kv) if causal else num_n - 1
        assert parts == list(range(top + 1)), (m, parts)
    # every wait points to an item the counter handed out earlier
    assert all(dep < i for dep, i in pointers)
    # its waits cost no steps: the mirror order, which never waits when
    # causal, takes at least as many
    _, mirror_steps, mirror_waits, _ = simulate(b, t, h, hk, causal,
                                                mirror=True)
    assert steps <= mirror_steps, (steps, mirror_steps)
    if causal:
        assert mirror_waits == 0


def test_path_shape_tail():
    """At the path's shape the longest walks (K/V tile 0) start first: the
    run takes at most 2 % more steps than its parts spread evenly over the
    workers would, where the mirror order, which never waits, leaves a
    tail of more than 5 %."""
    b, t, h, hk, _, causal = PATH_SHAPE
    added, steps, _, _ = simulate(b, t, h, hk, causal)
    _, mirror_steps, mirror_waits, pointers = simulate(b, t, h, hk, causal,
                                                       mirror=True)
    total = sum(len(p) for p in added.values())
    assert steps <= 1.02 * total / SMS, (steps, total / SMS)
    assert all(dep < i for dep, i in pointers)
    assert mirror_waits == 0 and mirror_steps > 1.05 * total / SMS


# ---------------------------------------------------------------------------
# the forward kernel's grid
# ---------------------------------------------------------------------------


def forward_ctas(b, t, h, causal):
    """[((b, h, Q tile), K/V tiles)] in the kernel's CTA order: CTA x takes
    Q tile num_m - 1 - x // (B·H) and (b, h) = divmod(x % (B·H), H); its
    K/V tiles reach the diagonal when causal, else the end."""
    qr, kv = kernels.FLASH_FWD_Q_ROWS, kernels.FLASH_FWD_KV_ROWS
    num_m, bh = -(-t // qr), b * h
    out = []
    for x in range(num_m * bh):
        m = num_m - 1 - x // bh
        n_end = min(t, m * qr + qr) if causal else t
        out.append(((x % bh // h, x % bh % h, m), -(-n_end // kv)))
    return out


def run_grid(ctas, workers=SMS):
    """The steps a grid takes when each of ``workers`` SMs holds one CTA
    at a time, a CTA takes as many steps as it has K/V tiles, and a free
    SM takes the next CTA in order."""
    free = [0] * workers
    for _, work in ctas:
        i = min(range(workers), key=free.__getitem__)
        free[i] += work
    return max(free)


def test_forward_tile_rows_match_the_kernel_source():
    """kernels.FLASH_FWD_Q_ROWS / FLASH_FWD_KV_ROWS (the CPU model's tile
    and this simulation) are the kernel's kQRows / kKvRows."""
    consts = source_constants(FWD_SRC)
    assert consts["kQRows"] == kernels.FLASH_FWD_Q_ROWS
    assert consts["kKvRows"] == kernels.FLASH_FWD_KV_ROWS


def test_forward_cta_order_is_read_from_the_kernel_source():
    src = " ".join(FWD_SRC.read_text().split())
    for line in ("const int m0 = (num_m - 1 - static_cast<int>(blockIdx.x) "
                 "/ BH) * kQRows;",
                 "const int bh = static_cast<int>(blockIdx.x) % BH;",
                 "const int b = bh / H;", "const int h = bh % H;",
                 "const int n_end = kCausal ? min(T, m0 + kQRows) : T;",
                 "static_cast<int64_t>((T + kQRows - 1) / kQRows) * B * H;"):
        assert line in src, line


@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_grid_covers_every_tile_once(case):
    """Every (b, h, Q tile) is one CTA, and the order (heaviest first) ends
    no later than the lightest-first order would."""
    b, t, h, _, _, causal = case
    ctas = forward_ctas(b, t, h, causal)
    qr = kernels.FLASH_FWD_Q_ROWS
    assert sorted(c for c, _ in ctas) == [
        (bb, hh, m) for bb in range(b) for hh in range(h)
        for m in range(-(-t // qr))]
    assert run_grid(ctas) <= run_grid(ctas[::-1])


def test_forward_path_shape_tail():
    """At the path's shape (1024 CTAs of 4 to 512 K/V tiles on 132 SMs) the
    heaviest-first order ends within 1 % of the work spread evenly, where
    lightest first leaves a tail of more than 10 %."""
    b, t, h, _, _, causal = PATH_SHAPE
    ctas = forward_ctas(b, t, h, causal)
    even = sum(w for _, w in ctas) / SMS
    assert run_grid(ctas) <= 1.01 * even, (run_grid(ctas), even)
    assert run_grid(ctas[::-1]) > 1.10 * even

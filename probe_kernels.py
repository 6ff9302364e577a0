#!/usr/bin/env python3
"""Timing probes of the port's two small kernels on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card and nvcc::

    python3 probe_kernels.py fused-breakdown [--csrc DIR]
    python3 probe_kernels.py seg-times [--tree DIR]
    python3 probe_kernels.py seg-variants [--csrc DIR]
    python3 probe_kernels.py feature-sum

``fused-breakdown`` builds timing-only variants of
``fused_linear_grads.cu`` (from ``DIR``, by default this checkout's
``dmlc_tpu_torch/ops/csrc``), each as its own shared library with nvcc, and
times each one's C entry point at HIGGS's batch ([16384, 29], logistic) in
turns, cold L2, as ``chip_smoke.time_ms`` times a kernel. The variants
live only here, never in the library; those that leave out a stage compute
nothing useful:

- ``base``: the source as it is;
- ``empty``: the same launch (grid, block, arguments), returning at once;
- ``x_only``: the x read and the dot products, then return;
- ``no_objective``: the objective replaced by a product;
- ``no_gw``: no gw (no broadcasts, no in-CTA gw sum), the scalars kept;
- ``no_sum``: the arrival ticket kept, the last CTA's sum left out;
- ``no_tail``: neither the ticket nor the last CTA's sum;
- ``cluster8``: the whole kernel with the cross-CTA sum of clusters of 8
  CTAs over distributed shared memory (one row and one ticket a cluster),
  the design tried against the one-ticket sum;
- ``tile_WxR``: the whole kernel at other tile shapes, W warps of R rows
  (the source's is 8 x 16).

The ``base``, ``cluster8`` and ``tile_WxR`` variants are checked against
the plain version before they are timed.

``seg-variants`` builds variants of this checkout's
``coo_segment_sum.cu`` (``seg_variants``) and times them in turns at the
padded csr batch and at FM's width, padded and full.

``seg-times`` times ``coo_segment_sum`` through the wrapper of the checkout
at ``DIR`` (its ``dmlc_tpu_torch`` first on the path) at the main path's
shapes: the padded Criteo batch (8192 rows of 39 entries in a 327,680-entry
bucket), the full bucket (40 entries a row), and both at FM's 17 columns;
and ``index_add_`` beside each. Run it in two checkouts in turns to compare
their kernels on one card.

``feature-sum`` times the feature-direction sum at one step of the
criteo-fm cell (``chip_smoke.feature_sum_row``: 638,976 Zipf ids of
1,000,001, as [E], [E, 8] and [E, 9]) ``TURNS`` times in turns: the route,
``sorted_segment_sum`` (a stable sort, then one kernel reading each
entry's row through the permutation), beside the sort alone and
``index_put_`` accumulate.

Each mode prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# x [16384, 29]: HIGGS's 28 features and the bias column
FUSED_ROWS, FUSED_FEATURES = 16384, 29
FM_COLS = 17
TURNS = 3


def cut(text: str, start: str, end: str) -> str:
    """``text`` without [start, end): from the first ``start`` up to, not
    including, the first ``end`` after it."""
    i = text.index(start)
    j = text.index(end, i)
    return text[:i] + text[j:]


def replace(text: str, old: str, new: str) -> str:
    assert old in text, "a probe patch no longer applies: %r" % old[:60]
    return text.replace(old, new)


def fused_variants(base: str) -> dict:
    """{name: source} of the timing-only variants of fused_linear_grads.cu
    (the module docstring)."""
    body = "  __shared__ float s_gw[kWarps][32];"
    variants = {"base": base}
    variants["empty"] = replace(base, body, "  if (rows > 0) return;\n" + body)
    variants["x_only"] = replace(
        base, "  // 2. the margin and objective of row lane % kRowsPerWarp",
        "  {\n    float s = 0.0f;\n"
        "    for (int i = 0; i < kRowsPerWarp; ++i) s += dot[i];\n"
        "    if (s == 1234.5f) partials[tile] = s;\n    return;\n  }\n"
        "  // 2. the margin and objective of row lane % kRowsPerWarp")
    variants["no_objective"] = replace(
        base,
        "    objective_loss_grad(objective, margin, my_label, &loss, &grad);",
        "    loss = margin * my_label;\n    grad = margin;")
    gw_start = "  // 3. gw of the tile, a chunk of 32 features at a time"
    variants["no_gw"] = cut(base, gw_start, "  // 4. arrive;").replace(
        "  // 4. arrive;",
        "  float* out = partials + tile * cols;\n  __syncthreads();\n"
        "  if (warp == 0 && lane < 3) {\n"
        "    float sc = s_sc[0][lane];\n"
        "    for (int j = 1; j < kWarps; ++j) sc += s_sc[j][lane];\n"
        "    out[features + lane] = sc;\n  }\n  // 4. arrive;", 1)
    variants["no_sum"] = replace(
        base, "  if (s_ticket != num_tiles - 1) return;",
        "  if (s_ticket != num_tiles - 1 || rows > 0) return;")
    variants["no_tail"] = cut(base, "  // 4. arrive;", "\n}\n\n}  // namespace")
    variants["cluster8"] = cluster8(base)
    # other tile shapes: (kWarps, kRowsPerWarp), rows a tile their product
    for warps, per_warp in ((4, 16), (16, 16), (8, 32), (8, 8)):
        variants[f"tile_{warps}x{per_warp}"] = replace(replace(
            base, "constexpr int kWarps = 8;",
            f"constexpr int kWarps = {warps};"),
            "constexpr int kRowsPerWarp = 16;",
            f"constexpr int kRowsPerWarp = {per_warp};")
    return variants


def warp_copies(text: str) -> str:
    """coo_segment_sum.cu with a bulk copy of each warp's 128 rows against
    its own mbarrier, each warp waiting for its own rows only, in place of
    one copy of the tile: the same bits."""
    text = replace(text, "  __shared__ uint64_t s_bar;",
                   "  __shared__ uint64_t s_bars[kWarps];")
    text = replace(
        text, "    dmlc_flash_hopper::mbar_init(&s_bar, 1);\n"
        "    dmlc_flash_hopper::mbar_init_fence();\n"
        "    const int bytes = kTile * cols * 4;\n"
        "    dmlc_flash_hopper::mbar_arrive_expect_tx(&s_bar, bytes);\n"
        "    dmlc_flash_hopper::bulk_copy(s_slab, contrib + base * cols, "
        "bytes,\n                                 &s_bar);",
        "    for (int w = 0; w < kWarps; ++w) {\n"
        "      dmlc_flash_hopper::mbar_init(&s_bars[w], 1);\n    }\n"
        "    dmlc_flash_hopper::mbar_init_fence();\n"
        "    const int bytes = kWarpEntries * cols * 4;\n"
        "    for (int w = 0; w < kWarps; ++w) {\n"
        "      dmlc_flash_hopper::mbar_arrive_expect_tx(&s_bars[w], bytes);\n"
        "      dmlc_flash_hopper::bulk_copy(\n"
        "          s_slab + w * kWarpEntries * cols,\n"
        "          contrib + (base + w * kWarpEntries) * cols, bytes, "
        "&s_bars[w]);\n    }")
    return replace(text, "mbar_wait(&s_bar, 0);", "mbar_wait(&s_bars[warp], 0);")


def seg_variants(base: str) -> dict:
    """{name: source} of variants of coo_segment_sum.cu's column pass, each
    giving the same bits: ``rotated`` reads a thread's rows 4t + j rotated
    by its lane group (no bank conflicts at an odd stride) and undoes the
    rotation with selects, ``two_stage`` the same in two steps of selects;
    ``planes`` copies the tile into four planes of rows 4t + j with 4-byte
    copies (no bank conflicts, no bulk copy); ``unroll2`` / ``unroll4``
    interleave 2 / 4 columns' scans; ``warp_copies`` copies each warp's
    rows apart, each warp waiting for its own. Timing only, wrong sums: at
    cols > 1
    ``x_no_scan`` runs no column scan, ``x_no_copy`` no slab copy."""
    loop = "    for (int c = 0; c < cc; ++c) {\n      float v[kPerThread];"
    natural = ("#pragma unroll\n"
               "      for (int j = 0; j < kPerThread; ++j) {\n"
               "        v[j] = kColumns ? s_slab[(kPerThread * t + j) * stride "
               "+ c] : v1[j];\n      }")

    def reads(unrotate: str) -> str:
        return replace(base, natural, (
            "      if (kColumns) {\n"
            "      const int g = (lane >> 3) & 3;\n"
            "      float rot[kPerThread];\n"
            "#pragma unroll\n"
            "      for (int j = 0; j < kPerThread; ++j) {\n"
            "        rot[j] = s_slab[(kPerThread * t + ((j + g) & 3)) * stride"
            " + c];\n      }\n" + unrotate + "\n      } else {\n"
            "#pragma unroll\n"
            "        for (int j = 0; j < kPerThread; ++j) v[j] = v1[j];\n"
            "      }"))

    one_step = ("#pragma unroll\n"
                "      for (int j = 0; j < kPerThread; ++j) {\n"
                "        const int m = (j - g) & 3;\n"
                "        v[j] = m == 0 ? rot[0] : m == 1 ? rot[1] : "
                "m == 2 ? rot[2] : rot[3];\n      }")
    two_step = ("      float u[kPerThread];\n"
                "#pragma unroll\n"
                "      for (int j = 0; j < kPerThread; ++j) {\n"
                "        u[j] = (g & 1) ? rot[(j + 3) & 3] : rot[j];\n"
                "      }\n"
                "#pragma unroll\n"
                "      for (int j = 0; j < kPerThread; ++j) {\n"
                "        v[j] = (g & 2) ? u[(j + 2) & 3] : u[j];\n      }")
    planes = replace(replace(replace(
        base, "const bool bulk = kColumns && cols <= kColChunk && whole && "
        "aligned;", "const bool bulk = false;"),
        "        float* dst = s_slab + e * stride + c;",
        "        float* dst = s_slab + ((e & 3) * kThreads + (e >> 2)) * "
        "stride + c;"), natural,
        "#pragma unroll\n"
        "      for (int j = 0; j < kPerThread; ++j) {\n"
        "        v[j] = kColumns ? s_slab[(j * kThreads + t) * stride + c] : "
        "v1[j];\n      }")
    return {
        "base": base,
        "rotated": reads(one_step),
        "two_stage": reads(two_step),
        "planes": planes,
        "unroll2": replace(base, loop, "#pragma unroll 2\n" + loop),
        "unroll4": replace(base, loop, "#pragma unroll 4\n" + loop),
        # timing only (wrong sums): at cols > 1 no column scan, no slab copy
        "x_no_scan": replace(base, loop, loop.replace(
            "c < cc;", "c < (kColumns ? 0 : cc);")),
        "x_no_copy": replace(replace(
            base, "  if (bulk && t == 0) {", "  if (bulk && t < 0) {"),
            "      dmlc_flash_hopper::mbar_wait(&s_bar, 0);", ""),
        "warp_copies": warp_copies(base),
    }


def seg_variant_times(csrc: Path) -> dict:
    import torch

    import chip_smoke as cs
    from dmlc_tpu_torch.ops import kernels

    text = (csrc / "coo_segment_sum.cu").read_text()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        libs = build_all(seg_variants(text), csrc, Path(tmp))
        for lib in libs.values():
            lib.dmlc_coo_segment_sum.argtypes = kernels.SIGNATURES[
                "dmlc_coo_segment_sum"]
        flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)
        out = {}
        for shape, per_row, cols in (("padded", 39, 1), ("padded_fm", 39, 17),
                                     ("full_bucket_fm", 40, 17)):
            ids, values = criteo_ids(dev, per_row)
            c = (values * 0.5)[:, None].repeat(1, cols).contiguous() \
                if cols > 1 else values * 0.5
            want = kernels.coo_segment_sum(c, ids, 8192)
            tiles = kernels.seg_sum_tiles(ids.shape[0])
            edges = torch.empty(tiles * 2 * cols, device=dev)
            res = torch.empty_like(want)
            chains = {name: torch.zeros(tiles, dtype=torch.int64, device=dev)
                      for name in libs}

            def call(name):
                rc = libs[name].dmlc_coo_segment_sum(
                    c.data_ptr(), ids.data_ptr(), ids.shape[0], 8192, cols,
                    kernels.SEG_TILE, edges.data_ptr(),
                    chains[name].data_ptr(), res.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                assert rc == 0, (name, rc)

            for name in libs:
                call(name)
                torch.cuda.synchronize()
                assert name.startswith("x_") or torch.equal(res, want), name
            times = {name: [] for name in libs}
            for _ in range(TURNS):
                for name in libs:
                    times[name].append(cs.time_ms(lambda: call(name), flush))
            out[shape] = times
        return out


# steps 3-4 of the clustered design: the 8 CTAs of a cluster add their
# rows over distributed shared memory in rank order (two cluster barriers
# a 32-feature chunk), one row and one ticket a cluster
CLUSTER_TAIL = """  // 3. gw of the tile, a chunk of 32 features at a time; the cluster's
  //    CTAs add their rows over distributed shared memory in rank order
  float* const out = partials + (tile / kCluster) * cols;
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t k = c * 32 + lane;
    float g = 0.0f;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) g = fmaf(x0[i], wgv[i], g);
    } else {
      float xv[kRowsPerWarp];
      load_chunk(x, warp_row, rows, features, k, xv);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) g = fmaf(xv[i], wgv[i], g);
    }
    s_gw[warp][lane] = g;
    __syncthreads();
    if (warp == 0) {
      float t = s_gw[0][lane];
#pragma unroll
      for (int j = 1; j < kWarps; ++j) t += s_gw[j][lane];
      s_part[lane] = t;
      if (c == 0 && lane < 3) {
        float sc = s_sc[0][lane];
#pragma unroll
        for (int j = 1; j < kWarps; ++j) sc += s_sc[j][lane];
        s_part[32 + lane] = sc;
      }
    }
    cluster.sync();  // every CTA's chunk row is in its shared memory
    if (rank == 0 && warp == 0) {
      float t = s_part[lane];
      float sc = lane < 3 ? s_part[32 + lane] : 0.0f;
#pragma unroll
      for (int r = 1; r < kCluster; ++r) {
        const float* other = cluster.map_shared_rank(s_part, r);
        t += other[lane];
        if (c == 0 && lane < 3) sc += other[32 + lane];
      }
      if (k < features) out[k] = t;
      if (c == 0 && lane < 3) out[features + lane] = sc;
    }
    cluster.sync();  // rank 0 has read them: the rows may change or go
  }

  // 4. rank 0 arrives; the last cluster sums the cluster rows in cluster
  //    order (fixed_order.cuh)
  if (rank != 0) return;
  const unsigned clusters = gridDim.x / kCluster;
  if (threadIdx.x == 0) {  // after the cluster barrier: the row is written
    s_ticket = fixed_order::arrive_ticket(counter, clusters - 1);
  }
  __syncthreads();
  if (s_ticket != clusters - 1) return;
  for (int64_t col = threadIdx.x; col < cols; col += kThreads) {
    const float total = fixed_order::ordered_sum(
        partials + col, partials + cols + col, cols, clusters - 1);
    if (col < features) {
      gw[col] = total;
    } else {
      scalars[col - features] = total;
    }
  }
}

"""


def cluster8(base: str) -> str:
    """fused_linear_grads.cu (one-ticket design) with the cross-CTA sum of
    clusters of 8 CTAs (``CLUSTER_TAIL``): the design tried against it,
    the same contract and C signature."""
    text = cut(base, "  // 3. gw of the tile, a chunk of 32 features",
               "}  // namespace")
    text = replace(text, "}  // namespace", CLUSTER_TAIL + "}  // namespace")
    text = replace(text, "#include <cuda_runtime.h>\n#include <stdint.h>\n",
                   "#include <cooperative_groups.h>\n#include <cuda_runtime.h>"
                   "\n#include <stdint.h>\n\n#include \"fixed_order.cuh\"\n\n"
                   "namespace cg = cooperative_groups;\n")
    text = replace(text, "constexpr int kBatch = 16;",
                   "constexpr int kBatch = 16;\nconstexpr int kCluster = 8;")
    text = replace(text, "  __shared__ float s_red[kWarps][32];\n",
                   "  __shared__ float s_part[32 + 3];\n")
    text = replace(text, "  __shared__ unsigned s_ticket;\n",
                   "  __shared__ unsigned s_ticket;\n"
                   "  cg::cluster_group cluster = cg::this_cluster();\n"
                   "  const unsigned rank = cluster.block_rank();\n")
    text = replace(text, "__global__ void __launch_bounds__(kThreads)\n"
                   "fused_linear_grads_kernel(",
                   "__global__ void __cluster_dims__(kCluster, 1, 1) "
                   "__launch_bounds__(kThreads)\nfused_linear_grads_kernel(")
    text = replace(text, "  const unsigned num_tiles = gridDim.x;\n", "")
    return replace(
        text, "  fused_linear_grads_kernel<<<static_cast<unsigned>(num_tiles),",
        "  const int64_t grid = (num_tiles + kCluster - 1) / kCluster * "
        "kCluster;\n"
        "  fused_linear_grads_kernel<<<static_cast<unsigned>(grid),")


def tile_rows_of(text: str) -> int:
    """kWarps x kRowsPerWarp of a fused_linear_grads.cu source."""
    import re

    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}
    return consts["kWarps"] * consts["kRowsPerWarp"]


def build_dir() -> Path:
    """The kernels' git-ignored build directory, where the variants build."""
    from dmlc_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _build.BUILD_DIR


def build_all(sources: dict, csrc: Path, out: Path) -> dict:
    """Compile each {name: source text} into its own shared library, all
    nvcc processes at once; {name: CDLL}. Prints ptxas's register and
    spill lines of each."""
    from dmlc_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for name, text in sources.items():
        src = out / f"{name}.cu"
        src.write_text(text)
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared",
               "-I", str(csrc), "-o", str(out / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def fused_breakdown(csrc: Path) -> dict:
    import torch

    import chip_smoke as cs
    from dmlc_tpu_torch.ops import kernels

    text = (csrc / "fused_linear_grads.cu").read_text()
    variants = fused_variants(text)
    tile_rows = {name: tile_rows_of(src) for name, src in variants.items()}
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        libs = build_all(variants, csrc, Path(tmp))
        p = ctypes.c_void_p
        for lib in libs.values():
            lib.dmlc_fused_linear_grads.argtypes = [
                p, p, p, p, p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, p, p, p, p, p]
        args = cs.fused_case(kernels, dev, FUSED_ROWS, FUSED_FEATURES,
                             "logistic", False, 2)[1]
        x, label, weight, w, b = args
        tiles = -(-FUSED_ROWS // min(tile_rows.values()))
        partials = torch.empty(tiles * (FUSED_FEATURES + 3), device=dev)
        gw = torch.empty(FUSED_FEATURES, device=dev)
        scalars = torch.empty(3, device=dev)
        counters = {name: torch.zeros(1, dtype=torch.int32, device=dev)
                    for name in libs}

        def call(name):
            rc = libs[name].dmlc_fused_linear_grads(
                x.data_ptr(), label.data_ptr(), weight.data_ptr(),
                w.data_ptr(), b.data_ptr(), FUSED_ROWS, FUSED_FEATURES, 0,
                tile_rows[name], partials.data_ptr(),
                counters[name].data_ptr(),
                gw.data_ptr(), scalars.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, (name, rc)

        want = kernels.fused_linear_grads_plain(*args)
        for name in libs:
            if name in ("base", "cluster8") or name.startswith("tile_"):
                call(name)
                torch.cuda.synchronize()
                assert torch.allclose(gw, want[0], **cs.FUSED_TOL) and \
                    torch.allclose(scalars[0], want[1], **cs.FUSED_TOL), name
        flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)
        times = {name: [] for name in libs}
        for _ in range(TURNS):
            for name in libs:
                times[name].append(cs.time_ms(lambda: call(name), flush))
        times["launch_floor_ms"] = cs.launch_floor_ms(kernels, dev, flush)
        return {"fused_breakdown_ms": times, "shape": [FUSED_ROWS,
                                                       FUSED_FEATURES]}


def criteo_ids(dev, per_row: int):
    """(row ids, values) of a Criteo batch as the feed builds it: 8192 rows
    of ``per_row`` entries in a 327,680-entry bucket, the padded tail
    clamped onto the last row by expand_row_ids."""
    import numpy as np
    import torch

    from dmlc_tpu_torch.data.row_block import RowBlock
    from dmlc_tpu_torch.device.csr import pad_to_bucket
    from dmlc_tpu_torch.ops.spmv import expand_row_ids

    rng = np.random.RandomState(3)
    rows = 8192
    offset = np.concatenate([[0], np.cumsum(np.full(rows, per_row))])
    nnz = int(offset[-1])
    block = RowBlock(offset=offset, label=np.zeros(rows),
                     index=rng.randint(1, 1 << 20, nnz).astype(np.uint32),
                     value=rng.rand(nnz).astype(np.float32))
    batch = pad_to_bucket(block, rows)
    assert batch.values.shape[0] == 327_680, batch.values.shape
    offsets = torch.tensor(batch.offsets, device=dev)
    values = torch.tensor(batch.values, device=dev)
    return expand_row_ids(offsets, values.shape[0]), values


def seg_times() -> dict:
    import torch

    import chip_smoke as cs
    from dmlc_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    out = {}
    for name, per_row in (("padded", 39), ("full_bucket", 40)):
        row_ids, values = criteo_ids(dev, per_row)
        contrib = values * 0.5
        packed = contrib[:, None].repeat(1, FM_COLS).contiguous()
        ids64 = row_ids.long()
        for suffix, c in (("", contrib), ("_fm", packed)):
            got = kernels.coo_segment_sum(c, row_ids, 8192)
            want = kernels.coo_segment_sum_plain(c, row_ids, 8192)
            torch.cuda.synchronize()
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-6), name
            out[name + suffix] = [
                cs.time_ms(lambda: kernels.coo_segment_sum(c, row_ids, 8192),
                           flush) for _ in range(TURNS)]
            out["index_add_" + name + suffix] = cs.time_ms(
                lambda: torch.zeros((8192,) + tuple(c.shape[1:]),
                                    device=dev).index_add_(0, ids64, c),
                flush)
    out["launch_floor_ms"] = cs.launch_floor_ms(kernels, dev, flush)
    return out


def feature_sum_times() -> dict:
    import torch

    import chip_smoke as cs
    from dmlc_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    flush = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    out = {}
    for _ in range(TURNS):
        for cols in (0,) + cs.FEATURE_SUM_COLS:
            out.setdefault(str(max(cols, 1)), []).append(
                cs.feature_sum_row(kernels, dev, flush, cols))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", choices=("fused-breakdown", "seg-times",
                                         "seg-variants", "feature-sum"))
    parser.add_argument("--csrc", type=Path,
                        default=ROOT / "dmlc_tpu_torch" / "ops" / "csrc")
    parser.add_argument("--tree", type=Path, default=ROOT)
    args = parser.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))  # that checkout's package and smoke
    os.chdir(tree)
    import torch

    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dmlc_tpu_torch.utils.device import resolve_device

    resolve_device(None)
    print("card:", cs.card_line(), flush=True)
    if args.mode == "fused-breakdown":
        result = fused_breakdown(args.csrc.resolve())
    elif args.mode == "seg-variants":
        result = {"seg_variants_ms": seg_variant_times(args.csrc.resolve())}
    elif args.mode == "feature-sum":
        result = {"feature_sum_ms": feature_sum_times()}
    else:
        result = {"seg_times_ms": seg_times(), "tree": str(tree)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

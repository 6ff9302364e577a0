// coo_segment_sum: y[r, c] = sum over entries e with row_ids[e] == r of
// contrib[e, c], for r in [0, num_rows) and c in [0, cols): the
// row-direction reduce of the csr margin (ops/spmv.spmv_kernel gathers
// contrib = values * w[indices], cols = 1) and of FM's packed
// [linear | x*v | (x*v)^2] entries (models/fm.py, cols = 2K + 1).
//
// Replaces dmlc_tpu/ops/pallas_kernels.py, coo_segment_sum /
// _seg_sum_kernel (the Pallas TPU kernel of the csr layout), and for FM
// the two jax.ops.segment_sum calls of dmlc_tpu/models/fm.py:76-77.
//
// Precondition: row_ids never decrease. On the main path they come from
// expand_row_ids, a cumsum of row-boundary marks with the padded tail
// clamped to the last row, so they are sorted by construction. Ids outside
// [0, num_rows) contribute nothing: a sorted -1 pad sits before row 0 and
// ids >= num_rows after the last row, where no row's range reaches.
//
// What bounds it on an H100: memory. It reads contrib and row_ids once
// (4 * cols + 4 bytes an entry) and writes y: 2.65 MB for a Criteo batch
// (E = 327,680, num_rows = 8192, cols = 1), 0.79 us at 3.35 TB/s; 24.2 MB
// for FM's (cols = 17), 7.2 us. One add per entry and column is nothing
// beside that; what costs is the latency of finding each row's entries.
//
// Design, two kernels a call, no search: the TPU kernel swept every entry
// tile for every row tile with a one-hot compare, O(rows x entries).
// 1. row_starts_kernel, a thread an entry, reads ids[e-1] and ids[e]
//    (coalesced) and writes starts[r] = e for the rows r with
//    ids[e-1] < r <= ids[e] (ids[-1] = -inf, ids[E] = +inf), clipped to
//    [0, num_rows]: starts[r] = lower_bound(ids, r), each row written by
//    exactly one entry, empty rows included. Once for all columns.
// 2. seg_sum_kernel, one warp per output (row, column), sums that column
//    of contrib over [starts[r], starts[r+1]) lane-strided and adds the
//    lanes with a fixed xor butterfly: the summation order of every
//    earlier version, so column c of a call equals a cols = 1 call on
//    contrib[:, c], bit for bit. Consecutive warps of a block take
//    consecutive columns of one row, so they read the same cache lines.
// Each output is written once by one warp, with no atomics: the same
// inputs give the same bits on every run.
//
// Why not a search (H100 80GB HBM3, 700 W, cold L2, Criteo batch, python3
// chip_smoke.py --times): the first design's two binary searches a warp
// (~38 dependent loads) took 0.0321 ms; a 32-ary warp search (4 rounds,
// every lane probing both bounds, one ballot a round) 0.0234-0.0235 ms;
// these two coalesced passes 0.0224-0.0226 ms, below index_add_'s 0.0275.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
row_starts_kernel(const int* __restrict__ row_ids, int64_t entries,
                  int64_t num_rows, int64_t* __restrict__ starts) {
  const int64_t e =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e > entries) return;
  const int64_t prev = e == 0 ? -1 : max(row_ids[e - 1], -1);
  const int64_t cur =
      e == entries ? num_rows
                   : min(static_cast<int64_t>(row_ids[e]), num_rows);
  for (int64_t r = prev + 1; r <= cur; ++r) starts[r] = e;
}

// kColumns false is the [E] call (cols == 1): no division, no stride.
template <bool kColumns>
__global__ void __launch_bounds__(kThreads)
seg_sum_kernel(const float* __restrict__ contrib,
               const int64_t* __restrict__ starts, int64_t num_rows,
               int64_t cols, float* __restrict__ out) {
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= num_rows * cols) return;  // uniform across the warp
  const int64_t row = kColumns ? warp / cols : warp;
  const int64_t col = warp - row * cols;
  const int64_t hi = starts[row + 1];
  float acc = 0.0f;
  for (int64_t e = starts[row] + lane; e < hi; e += 32) {
    acc += contrib[kColumns ? e * cols + col : e];
  }
  acc = warp_sum(acc);
  if (lane == 0) out[warp] = acc;
}

}  // namespace

// Launches both kernels on `stream`; contrib is [entries, cols] and out
// [num_rows, cols], both row-major; allocates nothing: `starts` is
// num_rows + 1 int64 of scratch. Returns cudaGetLastError().
extern "C" int dmlc_coo_segment_sum(const float* contrib, const int* row_ids,
                                    int64_t entries, int64_t num_rows,
                                    int64_t cols, int64_t* starts,
                                    float* out, void* stream) {
  if (entries < 0 || num_rows <= 0 || num_rows > 0x7ffffffe || cols <= 0 ||
      num_rows * cols > (int64_t{1} << 33)) {  // 2^30 blocks at most
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t mark_blocks = (entries + 1 + kThreads - 1) / kThreads;
  row_starts_kernel<<<static_cast<unsigned>(mark_blocks), kThreads, 0, s>>>(
      row_ids, entries, num_rows, starts);
  const unsigned sum_blocks =
      static_cast<unsigned>((num_rows * cols + kWarps - 1) / kWarps);
  if (cols == 1) {
    seg_sum_kernel<false><<<sum_blocks, kThreads, 0, s>>>(
        contrib, starts, num_rows, cols, out);
  } else {
    seg_sum_kernel<true><<<sum_blocks, kThreads, 0, s>>>(
        contrib, starts, num_rows, cols, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// coo_segment_sum: y[r] = sum over entries e with row_ids[e] == r of
// contrib[e], for r in [0, num_rows): the row-direction reduce of the csr
// margin (ops/spmv.spmv_kernel gathers contrib = values * w[indices]).
//
// Replaces dmlc_tpu/ops/pallas_kernels.py, coo_segment_sum /
// _seg_sum_kernel (the Pallas TPU kernel of the csr layout).
//
// Precondition: row_ids never decrease. On the main path they come from
// expand_row_ids, a cumsum of row-boundary marks with the padded tail
// clamped to the last row, so they are sorted by construction. Ids outside
// [0, num_rows) contribute nothing: a sorted -1 pad sits before row 0 and
// ids >= num_rows after the last row, where no row's range reaches.
//
// What bounds it on an H100: memory. It reads contrib and row_ids once (8
// bytes an entry) and writes y: 2.65 MB for a Criteo batch (E = 327,680,
// num_rows = 8192), 0.79 us at 3.35 TB/s. One add per entry is nothing
// beside that; what costs is the latency of finding each row's entries.
//
// Design, two kernels a call, no search: the TPU kernel swept every entry
// tile for every row tile with a one-hot compare, O(rows x entries).
// 1. row_starts_kernel, a thread an entry, reads ids[e-1] and ids[e]
//    (coalesced) and writes starts[r] = e for the rows r with
//    ids[e-1] < r <= ids[e] (ids[-1] = -inf, ids[E] = +inf), clipped to
//    [0, num_rows]: starts[r] = lower_bound(ids, r), each row written by
//    exactly one entry, empty rows included.
// 2. seg_sum_kernel, one warp per output row, sums contrib over
//    [starts[r], starts[r+1]) lane-strided and adds the lanes with a fixed
//    xor butterfly: the summation order of every earlier version.
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

__global__ void __launch_bounds__(kThreads)
seg_sum_kernel(const float* __restrict__ contrib,
               const int64_t* __restrict__ starts, int64_t num_rows,
               float* __restrict__ out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= num_rows) return;  // uniform across the warp
  const int64_t hi = starts[row + 1];
  float acc = 0.0f;
  for (int64_t e = starts[row] + lane; e < hi; e += 32) acc += contrib[e];
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

}  // namespace

// Launches both kernels on `stream`; allocates nothing: `starts` is
// num_rows + 1 int64 of scratch. Returns cudaGetLastError().
extern "C" int dmlc_coo_segment_sum(const float* contrib, const int* row_ids,
                                    int64_t entries, int64_t num_rows,
                                    int64_t* starts, float* out,
                                    void* stream) {
  if (entries < 0 || num_rows <= 0 || num_rows > 0x7ffffffe) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t mark_blocks = (entries + 1 + kThreads - 1) / kThreads;
  row_starts_kernel<<<static_cast<unsigned>(mark_blocks), kThreads, 0, s>>>(
      row_ids, entries, num_rows, starts);
  const int64_t sum_blocks = (num_rows + kWarps - 1) / kWarps;
  seg_sum_kernel<<<static_cast<unsigned>(sum_blocks), kThreads, 0, s>>>(
      contrib, starts, num_rows, out);
  return static_cast<int>(cudaGetLastError());
}

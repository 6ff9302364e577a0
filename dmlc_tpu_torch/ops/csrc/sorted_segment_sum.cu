// sorted_segment_sum: y[f, c] = sum over entries e with ids[e] == f of
// contrib[e, c], for f in [0, num_rows) and c in [0, cols), from the ids
// stable-sorted by the caller: the feature-direction gradients of the csr
// linear fit (cols = 1) and of FM ([E, 1 + K], gw's column beside dv's K),
// ops/kernels.sorted_segment_sum.
//
// Replaces, for those gradients, torch's index_put_(accumulate=True) on
// the card (the reference sums them with XLA's segment_sum:
// dmlc_tpu/ops/spmv.py, dmlc_tpu/models/fm.py).
//
// Each (feature, column) is summed in the order torch's
// index_put_(accumulate=True) gives the same column after its stable sort,
// so the route keeps the old route's bits:
//   - the first lane_cols columns as a vector (a 1-D index_put_, its
//     stride-1 kernel): over the feature's run of n sorted entries, lane l
//     of 32 adds entries l, l + 32, ... of the first 32 * floor(n / 32) in
//     turn, from 0.0f; a shuffle-down tree (offsets 16, 8, 4, 2, 1) adds
//     the 32 lanes into lane 0; lane 0 adds the last n mod 32 entries in
//     order;
//   - the other columns as the rows of a 2-D index_put_ (its small-stride
//     kernel): the run's entries one at a time in order, from 0.0f;
// and the row is 0.0f plus that sum. The csr fit's [E] call is a vector;
// FM's packed [E, 1 + K] call is gw as a vector and dv as K columns of
// rows, the bits of the two index_put_ calls the step made before. The
// plain reference of the FM cells takes the same two index_put_ orders
// through autograd, so those cells read the old route's gaps; a tile-order
// or an exact sum read up to ~6e-8 in grad_gap there (PERF.md, section 6).
//
// Input: sorted_ids never decrease, and entry i of the sorted order is row
// perm[i] of contrib (int64). Ids outside [0, num_rows) contribute nothing.
//
// Design: one launch; CTA b takes the sorted entries [b * kTile,
// (b + 1) * kTile), whatever the runs' lengths.
//   1. The tile's ids and rows (perm) go to shared memory, with the id
//      before and after the tile.
//   2. Rows with no entries are zeroed by the thread that owns the entry
//      before the gap, each gap with its warp's coalesced stores
//      (coo_segment_sum's scheme): every output row is written once.
//   3. A run belongs to the tile it starts in. The tile's rows of contrib,
//      kColChunk columns a pass, are gathered into shared memory through
//      perm (4-byte cp.async copies, all in flight). A run that ends in the
//      tile is summed by one thread a column, or, a run of 32 entries or
//      more in a vector column, by a warp, lane by lane as above.
//   4. The tile's last run may go on past it. Warp 0 finds its end with a
//      32-way search of the sorted ids; then the CTA gathers the run kTile
//      entries at a time, each warp carrying its vector columns' 32 lane
//      sums, and one thread each row column's sum, from chunk to chunk, to
//      the tree and the tail at the end. So a run of n entries costs a
//      chain of n adds from shared memory at most (the padded tail of a
//      bucket, 16,384 entries at feature 0, is 16 chunks), not n dependent
//      global loads as in index_put_'s walk.
// No float atomics: the same inputs give the same bits on every run and
// stream. Each (feature, column) is its own sum, in its column's order. On
// integer-valued data every order gives the same bits: those of the CPU
// route.
//
// Measured (H100 80GB HBM3, 700.00 W, cold L2): PERF.md, section 6.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // sorted entries a CTA
constexpr int kColChunk = 24;                 // columns a pass
constexpr int kColsPerWarp = kColChunk / kWarps;
static_assert(kColsPerWarp * kWarps == kColChunk, "columns split by warp");
constexpr int kLong = 32;  // vector runs this long are summed by a warp
constexpr int kBatch = 8;  // shared-memory loads ahead of the dependent adds
// ids of the slots past the last entry: >= every num_rows, so out of range
constexpr int kPastEnd = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;
// shared memory, ints: ids [kTile + 8] (slot 3 the entry before the tile,
// slots 4 .. 4 + kTile the tile, slot 4 + kTile the entry after it), the
// tile's rows [kTile], a chunk's rows [kTile], the run starts [kTile + 4],
// the long runs [kTile / kLong + 4]; then the column slab [kTile][stride]
constexpr int kIdsInts = kTile + 8;
constexpr int kLongInts = kTile / kLong + 4;
constexpr int kFixedBytes =
    (kIdsInts + kTile + kTile + (kTile + 4) + kLongInts) * 4;
static_assert(kFixedBytes % 16 == 0, "the slab starts 16-byte aligned");

__device__ __forceinline__ bool in_rows(int r, int num_rows) {
  return r >= 0 && r < num_rows;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Zeroes rows [lo, hi) of y ([*, cols]) with the warp: every lane of the
// warp calls it with the same lo and hi.
__device__ __forceinline__ void zero_rows(float* out, int64_t lo, int64_t hi,
                                          int64_t cols, int lane) {
  for (int64_t x = lo * cols + lane; x < hi * cols; x += 32) out[x] = 0.0f;
}

// 4 bytes from global to shared memory, asynchronously (cp.async.wait_all
// waits for them)
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// s_slab[e * stride + c] = contrib[rows[e] * cols + c0 + c] for e in
// [lo, hi), c in [0, cc), with every thread of the CTA; then waits for its
// own copies (the caller syncs the CTA).
__device__ __forceinline__ void gather_rows(float* s_slab, const int* rows,
                                            const float* __restrict__ contrib,
                                            int lo, int hi, int cols, int c0,
                                            int cc, int stride, int t) {
  const int n = (hi - lo) * cc;
  int e = lo + t / cc;
  int c = t - (t / cc) * cc;
  const int de = kThreads / cc, dc = kThreads - de * cc;
  for (int i = t; i < n; i += kThreads) {
    copy4_async(s_slab + e * stride + c,
                contrib + static_cast<int64_t>(rows[e]) * cols + c0 + c);
    e += de;
    c += dc;
    if (c >= cc) c -= cc, ++e;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc + slab[lo * stride] + ... + slab[(hi - 1) * stride], added one at a
// time in that order, kBatch loads ahead of the adds.
__device__ __forceinline__ float walk(float acc, const float* slab, int lo,
                                      int hi, int stride) {
  int e = lo;
  for (; e + kBatch <= hi; e += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = slab[(e + j) * stride];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc += v[j];
  }
  for (; e < hi; ++e) acc += slab[e * stride];
  return acc;
}

// The 32 lanes' sums added into lane 0, as index_put_'s shuffle-down tree.
__device__ __forceinline__ float lane_tree(float g) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) g += __shfl_down_sync(kFull, g, d);
  return g;
}

// The ids and rows of entries [pos + 4t, pos + 4t + 4) into id / row
// (kPastEnd and 0 past `entries`).
__device__ __forceinline__ void load_entries(const int* __restrict__ ids,
                                             const int64_t* __restrict__ perm,
                                             int64_t pos, int64_t entries,
                                             bool aligned, int t, int* id,
                                             int* row) {
  const int64_t e0 = pos + kPerThread * t;
  if (e0 + kPerThread <= entries && aligned) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(ids + e0));
    id[0] = q.x, id[1] = q.y, id[2] = q.z, id[3] = q.w;
    const longlong2* p = reinterpret_cast<const longlong2*>(perm + e0);
    const longlong2 p0 = __ldg(p), p1 = __ldg(p + 1);
    row[0] = static_cast<int>(p0.x), row[1] = static_cast<int>(p0.y);
    row[2] = static_cast<int>(p1.x), row[3] = static_cast<int>(p1.y);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool real = e0 + j < entries;
      id[j] = real ? ids[e0 + j] : kPastEnd;
      row[j] = real ? static_cast<int>(perm[e0 + j]) : 0;
    }
  }
}

// The first position at or past `lo` whose id is not `r` (or `entries`),
// found by the calling warp with 32 probes a step; ids[lo - 1] == r.
__device__ int64_t run_end(const int* __restrict__ ids, int64_t lo,
                           int64_t entries, int r, int lane) {
  int64_t hi = entries;  // the end lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + step * lane;
    const unsigned eq = __ballot_sync(kFull, p < hi && __ldg(ids + p) == r);
    const int n = __popc(eq);  // the equal ids are a prefix of the probes
    if (n == 0) return lo;
    const int64_t next = lo + step * n;
    lo = lo + step * (n - 1) + 1;
    hi = min64(hi, next);
  }
  const int64_t p = lo + lane;
  return lo + __popc(__ballot_sync(kFull, p < hi && __ldg(ids + p) == r));
}

__global__ void __launch_bounds__(kThreads)
sorted_sum_kernel(const float* __restrict__ contrib,
                  const int* __restrict__ sorted_ids,
                  const int64_t* __restrict__ perm, int64_t entries,
                  int num_rows, int cols, int lane_cols, bool aligned,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* const sid = reinterpret_cast<int*>(smem) + 4;  // sid[-1 .. kTile]
  int* const s_row = reinterpret_cast<int*>(smem) + kIdsInts;
  int* const s_chunk_row = s_row + kTile;
  int* const s_start = s_chunk_row + kTile;  // [kTile + 4]
  int* const s_long = s_start + kTile + 4;   // [kLongInts]
  float* const s_slab = reinterpret_cast<float*>(smem + kFixedBytes);
  __shared__ int s_warp[kWarps];
  __shared__ int s_nlong;
  __shared__ long long s_run_n;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int real = static_cast<int>(min64(kTile, max64(entries - base, 0)));
  const int first = kPerThread * t;

  // ---- 1. the tile's ids and rows ----------------------------------------
  int id[kPerThread], row[kPerThread];
  load_entries(sorted_ids, perm, base, entries, aligned, t, id, row);
  *reinterpret_cast<int4*>(sid + first) = make_int4(id[0], id[1], id[2],
                                                    id[3]);
  *reinterpret_cast<int4*>(s_row + first) =
      make_int4(row[0], row[1], row[2], row[3]);
  if (t == 0) s_nlong = 0;
  __syncthreads();
  // the neighbours: an id different from the tile's own where none exists
  if (t == 0) sid[-1] = tile > 0 ? sorted_ids[base - 1] : sid[0] ^ 1;
  if (t == 32) {
    sid[kTile] = base + kTile < entries ? sorted_ids[base + kTile]
                                        : sid[kTile - 1] ^ 1;
  }
  __syncthreads();
  const int prev_id = sid[first - 1];
  const int next_id = sid[first + kPerThread];

  // ---- 2. the rows with no entries ---------------------------------------
  {
    int64_t lo[kPerThread + 1], hi[kPerThread + 1];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t e = base + first + j;
      const int64_t next =
          e + 1 < entries ? (j + 1 < kPerThread ? id[j + 1] : next_id)
                          : static_cast<int64_t>(num_rows);
      lo[j] = e < entries ? max64(id[j] + int64_t{1}, 0) : 0;
      hi[j] = e < entries ? min64(next, num_rows) : 0;
    }
    lo[kPerThread] = 0;
    hi[kPerThread] = (tile == 0 && t == 0)
                         ? (entries > 0 ? min64(max(id[0], 0), num_rows)
                                        : num_rows)
                         : 0;
#pragma unroll
    for (int j = 0; j <= kPerThread; ++j) {
      unsigned gaps = __ballot_sync(kFull, lo[j] < hi[j]);
      while (gaps) {
        const int src = __ffs(gaps) - 1;
        gaps &= gaps - 1;
        zero_rows(out, __shfl_sync(kFull, lo[j], src),
                  __shfl_sync(kFull, hi[j], src), cols, lane);
      }
    }
  }

  // ---- 3. the runs that start in the tile --------------------------------
  // entry j of this thread starts a run (the first entry of all does too);
  // an exclusive scan of the counts lays the starts out in order
  unsigned starts = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int before = j > 0 ? id[j - 1] : prev_id;
    if (first + j < real && (base + first + j == 0 || id[j] != before)) {
      starts |= 1u << j;
    }
  }
  const int mine = __popc(starts);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int offset = incl - mine, runs = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    offset += w < warp ? s_warp[w] : 0;
    runs += s_warp[w];
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (starts & (1u << j)) s_start[offset++] = first + j;
  }
  if (t == 0) s_start[runs] = real;
  __syncthreads();
  if (runs == 0) return;  // the tile lies inside a run an earlier tile owns
  const int owned = s_start[0];  // entries before it belong to that run
  const int last_lo = s_start[runs - 1];
  const int last_id = sid[last_lo];
  // the tile's last run goes on into the entries after the tile
  const bool goes_on = real == kTile && base + kTile < entries &&
                       sid[kTile] == sid[kTile - 1] &&
                       in_rows(last_id, num_rows);
  // the runs of kLong entries or more that end in the tile: a warp each in
  // a vector column (the list's order does not matter: each run is summed
  // on its own)
  for (int k = t; k < runs - (goes_on ? 1 : 0); k += kThreads) {
    if (s_start[k + 1] - s_start[k] >= kLong &&
        in_rows(sid[s_start[k]], num_rows)) {
      s_long[atomicAdd(&s_nlong, 1)] = k;
    }
  }
  if (goes_on && warp == 0) {
    const int64_t end = run_end(sorted_ids, base + kTile + 1, entries,
                                last_id, lane);
    if (lane == 0) s_run_n = end - (base + last_lo);
  }
  __syncthreads();
  const int nlong = s_nlong;

  for (int c0 = 0; c0 < cols; c0 += kColChunk) {
    const int cc = min(cols - c0, kColChunk);
    const int stride = cc | 1;  // odd: fewer bank conflicts
    gather_rows(s_slab, s_row, contrib, owned, real, cols, c0, cc, stride, t);
    __syncthreads();
    // columns [0, lc) of the pass are vectors, [lc, cc) rows
    const int lc = max(0, min(lane_cols - c0, cc));
    // a thread each (run, column): in entry order from 0, but a vector
    // column's runs of kLong or more
    for (int q = t; q < runs * cc; q += kThreads) {
      const int k = q / cc;
      const int c = q - k * cc;
      const int lo = s_start[k];
      const int hi = s_start[k + 1];
      const int r = sid[lo];
      if ((c < lc && hi - lo >= kLong) || (k == runs - 1 && goes_on) ||
          !in_rows(r, num_rows)) {
        continue;
      }
      const float acc = walk(0.0f, s_slab + c, lo, hi, stride);
      out[static_cast<int64_t>(r) * cols + c0 + c] = 0.0f + acc;
    }
    // a warp each (run of kLong or more, vector column): lane sums, tree,
    // tail
    for (int q = warp; q < nlong * lc; q += kWarps) {
      const int k = s_long[q / lc];
      const int c = q - (q / lc) * lc;
      const int lo = s_start[k];
      const int n = s_start[k + 1] - lo;
      const int whole = n & ~31;
      float g = 0.0f;
      for (int e = lane; e < whole; e += 32) g += s_slab[(lo + e) * stride + c];
      g = lane_tree(g);
      if (lane == 0) {
        g = walk(g, s_slab + c, lo + whole, lo + n, stride);
        out[static_cast<int64_t>(sid[lo]) * cols + c0 + c] = 0.0f + g;
      }
    }
    __syncthreads();  // the slab free again

    // ---- 4. the last run, on past the tile -------------------------------
    if (goes_on) {
      const int64_t run_lo = base + last_lo;
      const int64_t n = s_run_n;
      const int64_t whole = n & ~int64_t{31};
      // the warp's vector columns warp + j * kWarps: 32 lane sums each
      float g[kColsPerWarp];
#pragma unroll
      for (int j = 0; j < kColsPerWarp; ++j) g[j] = 0.0f;
      // this thread's row column, if any: lc + lane * kWarps + warp
      const int row_c = lc + lane * kWarps + warp;
      const bool has_row = lane < kColsPerWarp && row_c < cc;
      float acc = 0.0f;
      for (int64_t k0 = 0; k0 < n; k0 += kTile) {
        const int len = static_cast<int>(min64(kTile, n - k0));
        for (int e = t; e < len; e += kThreads) {
          s_chunk_row[e] = static_cast<int>(
              __ldg(reinterpret_cast<const long long*>(perm) + run_lo + k0 +
                    e));
        }
        __syncthreads();
        gather_rows(s_slab, s_chunk_row, contrib, 0, len, cols, c0, cc,
                    stride, t);
        __syncthreads();
        const bool last = k0 + kTile >= n;
        if (has_row) {
          acc = walk(acc, s_slab + row_c, 0, len, stride);
          if (last) {
            out[static_cast<int64_t>(last_id) * cols + c0 + row_c] =
                0.0f + acc;
          }
        }
        // lane l's entries of the chunk: run offsets l + 32 i below whole
        const int lane_hi = static_cast<int>(min64(len, whole - k0));
#pragma unroll
        for (int j = 0; j < kColsPerWarp; ++j) {
          const int c = warp + j * kWarps;
          if (c >= lc) break;
          for (int e = lane; e < lane_hi; e += 32) {
            g[j] += s_slab[e * stride + c];
          }
          if (last) {  // the tree, the tail
            float sum = lane_tree(g[j]);
            if (lane == 0) {
              sum = walk(sum, s_slab + c, static_cast<int>(whole - k0), len,
                         stride);
              out[static_cast<int64_t>(last_id) * cols + c0 + c] =
                  0.0f + sum;
            }
          }
        }
        __syncthreads();  // the slab and chunk rows free again
      }
    }
  }
}

}  // namespace

// Launches the kernel once on `stream`: contrib is [entries, cols]
// row-major, sorted_ids and perm [entries] (a stable sort of the ids and
// its permutation), out [num_rows, cols]; columns [0, lane_cols) are
// summed as vectors, the rest as rows (the note above). Allocates nothing
// and needs no scratch. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take (at most INT_MAX
// entries).
extern "C" int dmlc_sorted_segment_sum(const float* contrib,
                                       const int* sorted_ids,
                                       const int64_t* perm, int64_t entries,
                                       int64_t num_rows, int64_t cols,
                                       int64_t lane_cols, int tile,
                                       float* out, void* stream) {
  if (tile != kTile || entries < 0 || entries > INT_MAX || num_rows <= 0 ||
      num_rows > 0x7ffffffe || cols <= 0 || cols > 0x7fffffff ||
      lane_cols < 0 || lane_cols > cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t num_tiles = std::max<int64_t>(1, (entries + kTile - 1) / kTile);
  const int stride = static_cast<int>(std::min<int64_t>(cols, kColChunk)) | 1;
  const int bytes = kFixedBytes + kTile * stride * 4;
  // 48 KB of dynamic and static shared memory without opting in
  if (bytes > 47 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sorted_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(sorted_ids) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(perm) % 16 == 0;
  sorted_sum_kernel<<<static_cast<unsigned>(num_tiles), kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      contrib, sorted_ids, perm, entries, static_cast<int>(num_rows),
      static_cast<int>(cols), static_cast<int>(lane_cols), aligned, out);
  return static_cast<int>(cudaGetLastError());
}

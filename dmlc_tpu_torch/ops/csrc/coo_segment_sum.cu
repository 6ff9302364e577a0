// coo_segment_sum: y[r, c] = sum over entries e with row_ids[e] == r of
// contrib[e, c], for r in [0, num_rows) and c in [0, cols): the
// row-direction reduce of the csr margin (ops/spmv.spmv_kernel gathers
// contrib = values * w[indices], cols = 1) and of FM's packed
// [linear | x*v | (x*v)^2] entries (models/fm.py, cols = 2K + 1).
//
// Replaces dmlc_tpu/ops/pallas_kernels.py:221, coo_segment_sum /
// _seg_sum_kernel (the Pallas TPU kernel of the csr layout), and for FM
// the two jax.ops.segment_sum calls of dmlc_tpu/models/fm.py:76-77.
//
// Precondition: row_ids never decrease. On the main path they come from
// expand_row_ids, a cumsum of row-boundary marks with the padded tail
// clamped to the last row, so they are sorted by construction. Ids outside
// [0, num_rows) contribute nothing.
//
// What bounds it on an H100: memory. It reads contrib and row_ids once
// (4 * cols + 4 bytes an entry) and writes y: 2.65 MB for a Criteo batch
// (E = 327,680, num_rows = 8192, cols = 1), 0.79 us at 3.35 TB/s; 24.2 MB
// for FM's (cols = 17), 7.2 us. At the csr shape the time is latency: the
// launch, one cold read, the cross-CTA sums.
//
// Design: one launch; CTA b takes the entries [b * kTile, (b + 1) * kTile),
// so every CTA does the same work whatever the rows' lengths. (The design
// before it gave each output to one warp: the padded tail of a bucket,
// clamped onto the last row, made that row's warp walk 8,231 entries alone
// while the others walked 39.)
//   1. The tile's ids go to shared memory (16-byte loads), with the entry
//      before and after the tile. Thread t owns entries 4t .. 4t + 3. At
//      cols = 1 its values stay in registers (one 16-byte load); at
//      cols > 1 the tile's rows of contrib, kColChunk columns a pass, go to
//      shared memory: one bulk copy (cp.async.bulk, an mbarrier), issued
//      as the kernel starts, when a pass holds every column of a whole,
//      aligned tile (rows at stride cols), else 4-byte cp.async copies,
//      all in flight at once. A warp's read of one column of its threads'
//      rows 4t + j has 4-way bank conflicts at an odd stride; that
//      measured cheaper than undoing a rotation of the rows in registers,
//      or than copying into four planes of rows 4t + j (probe_kernels.py
//      seg-variants).
//   2. For each column, the sums of the runs of equal ids: each thread sums
//      its run pieces in entry order, a Kogge-Stone segmented scan over the
//      warp's 32 threads (xor-free shfl_up, left + right at each step)
//      carries a run from thread to thread, and a run that ends in the
//      warp is written straight to y (complete runs) or as a warp piece to
//      shared memory (runs open at the warp's start or end). Then the warp
//      pieces of each run that spans warps are added in warp order.
//   3. Rows with no entries: the thread that owns an entry zeroes the rows
//      between its id and the next entry's (tile 0 also the rows before the
//      first id; the last entry, the rows after it), each gap zeroed by its
//      warp with coalesced stores, once for all columns.
//   4. Only the first and last run of a tile can go on into a neighbour.
//      Each writes its sum over the tile (the tile piece, [cols]) to the
//      edge scratch, slot 0 for the first run, 1 for the last (both when
//      one run fills the tile). A run over tiles a..b is one chain: every
//      tile of it adds to the chain's u64 counter (chains[a], a counter
//      array kept on the stream), the end tile b adding (b - a + 1) << 32
//      beside its 1, so that the arrival that makes the two halves equal is
//      the last one (fixed_order.cuh). That CTA sums the pieces in tile
//      order, tile a's slot 1 then slot 0 of a + 1 .. b, writes the row
//      and puts the counter back to 0. A tile that a chain enters finds a
//      from the ids that end the 32 tiles before it, loaded with the
//      tile's ids (a run over more tiles reads 32 more a step).
// Every output row is written once: a complete run or its chain's last
// arrival, or a gap's zeroing. The order of every (row, column) sum
// depends on the row's entries and kTile only, never on cols: column c of
// a call equals a cols = 1 call on contrib[:, c], bit for bit. No float
// atomics: the same inputs give the same bits on every run and stream.
//
// Measured (H100 80GB HBM3, 700.00 W, cold L2, python3 chip_smoke.py
// --times): see PERF.md's kernel table, row 2; the design before this one
// (two kernels: each row's first entry, then a warp per output) took
// 0.0226 ms at the Criteo batch and 0.0587 at FM's, index_add_ 0.0276 and
// 0.0650.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "fixed_order.cuh"
#include "flash_hopper.cuh"  // mbarriers and bulk copies

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // entries a CTA
constexpr int kWarpEntries = 32 * kPerThread;
constexpr int kColChunk = 24;  // columns a pass: kWarps * kColChunk <= kThreads
static_assert(kWarps * kColChunk <= kThreads, "one thread a warp-chain column");
// ids of the slots past the last entry: >= every num_rows, so out of range
constexpr int kPastEnd = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;
// shared memory: ids [kTile + 8] (slot 3 the entry before the tile, slots
// 4 .. 4 + kTile the tile, slot 4 + kTile the entry after it), warp pieces
// [kWarps][2][kColChunk], then the column slab
constexpr int kIdsBytes = (kTile + 8) * 4;
constexpr int kPieceFloats = kWarps * 2 * kColChunk;
constexpr int kFixedBytes = kIdsBytes + kPieceFloats * 4;

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
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   dmlc_flash_hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

template <bool kColumns>
__global__ void __launch_bounds__(kThreads)
seg_sum_kernel(const float* __restrict__ contrib,
               const int* __restrict__ row_ids, int64_t entries,
               int num_rows, int cols, bool aligned,
               float* __restrict__ edges,
               unsigned long long* __restrict__ chains,
               float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* const sid = reinterpret_cast<int*>(smem) + 4;  // sid[-1 .. kTile]
  float* const s_piece = reinterpret_cast<float*>(smem + kIdsBytes);
  float* const s_slab = reinterpret_cast<float*>(smem + kFixedBytes);
  __shared__ int s_chain_a;          // the start tile of the first run's chain
  __shared__ int s_back[32];  // the ids ending tiles tile - 1, tile - 2, ...
  __shared__ unsigned long long s_last[2];  // counter values of the arrivals
  __shared__ uint64_t s_bar;  // the bulk copy of the column slab

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int64_t first_entry = base + kPerThread * t;
  const bool whole = base + kTile <= entries;
  // cols > 1: one bulk copy of the tile's rows when a pass holds every
  // column (rows at stride cols), else 4-byte copies (at an odd stride)
  const bool bulk = kColumns && cols <= kColChunk && whole && aligned;
  const int stride = kColumns ? (bulk ? cols : (min(cols, kColChunk) | 1)) : 1;
  if (bulk && t == 0) {
    dmlc_flash_hopper::mbar_init(&s_bar, 1);
    dmlc_flash_hopper::mbar_init_fence();
    const int bytes = kTile * cols * 4;
    dmlc_flash_hopper::mbar_arrive_expect_tx(&s_bar, bytes);
    dmlc_flash_hopper::bulk_copy(s_slab, contrib + base * cols, bytes,
                                 &s_bar);
  }

  // ---- 1. ids (and at cols = 1 the values) -------------------------------
  int id[kPerThread];
  float v1[kPerThread];
  if (whole && aligned) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(row_ids + first_entry));
    id[0] = q.x, id[1] = q.y, id[2] = q.z, id[3] = q.w;
    if (!kColumns) {
      const float4 f =
          __ldg(reinterpret_cast<const float4*>(contrib + first_entry));
      v1[0] = f.x, v1[1] = f.y, v1[2] = f.z, v1[3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool real = first_entry + j < entries;
      id[j] = real ? row_ids[first_entry + j] : kPastEnd;
      if (!kColumns) v1[j] = real ? contrib[first_entry + j] : 0.0f;
    }
  }
  *reinterpret_cast<int4*>(sid + kPerThread * t) =
      make_int4(id[0], id[1], id[2], id[3]);
  // the ids that end tiles tile - 1 - l, read beside the tile's: a chain
  // into this tile starts at the first of those tiles whose id before it
  // differs (or tile 0)
  if (warp == 2) {
    const int64_t k = tile - 1 - lane;
    s_back[lane] = k >= 1 ? row_ids[k * kTile - 1] : 0;
  }
  if (t < 2) s_last[t] = 0;
  __syncthreads();
  // the neighbours: an id different from the tile's own where none exists
  if (t == 0) sid[-1] = tile > 0 ? row_ids[base - 1] : sid[0] ^ 1;
  if (t == 32) {
    sid[kTile] = base + kTile < entries ? row_ids[base + kTile]
                                        : sid[kTile - 1] ^ 1;
  }
  __syncthreads();

  const int w0 = warp * kWarpEntries;
  const int prev_id = sid[kPerThread * t - 1];  // the entry before thread t
  const int next_id = sid[kPerThread * t + kPerThread];
  const bool tile_open_s = tile > 0 && sid[-1] == sid[0];
  const bool tile_open_e = base + kTile < entries &&
                           sid[kTile] == sid[kTile - 1];
  const bool warp_open_s = warp > 0 ? sid[w0 - 1] == sid[w0] : tile_open_s;
  const bool warp_open_e = warp < kWarps - 1
                               ? sid[w0 + kWarpEntries] ==
                                     sid[w0 + kWarpEntries - 1]
                               : tile_open_e;

  // ---- 3. the rows with no entries ---------------------------------------
  {
    int64_t lo[kPerThread + 1], hi[kPerThread + 1];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int64_t e = first_entry + j;
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

  // ---- 2. run sums, column by column -------------------------------------
  // same[j]: entry j continues the run of entry j - 1 in this thread
  bool same[kPerThread];
  same[0] = false;
#pragma unroll
  for (int j = 1; j < kPerThread; ++j) same[j] = id[j] == id[j - 1];
  // Kogge-Stone: at step d, add the sum of the thread d lanes down unless
  // this thread's last run started at or after it
  unsigned add_mask = 0;
  {
    bool head = lane == 0 || id[kPerThread - 1] != prev_id;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int d = 1 << s;
      const bool up = __shfl_up_sync(kFull, head, d);
      if (lane >= d && !head) add_mask |= 1u << s;
      if (lane >= d) head = head || up;
    }
  }
  // where each run end of this thread goes: y's row or a tile piece
  // (edges), whose column c0 + c a pass writes, or a warp piece, whose
  // slot c (in_smem)
  float* dst[kPerThread][2];
  bool in_smem[kPerThread];
  bool cont[kPerThread];  // the run came into this thread from lane - 1
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    cont[j] = lane > 0 && id[j] == prev_id;
    dst[j][0] = dst[j][1] = nullptr;
    in_smem[j] = false;
    const bool warp_end = lane == 31 && j == kPerThread - 1;
    const bool run_end =
        warp_end || id[j] != (j + 1 < kPerThread ? id[j + 1] : next_id);
    if (!run_end || !in_rows(id[j], num_rows)) continue;
    const bool open_s = id[j] == sid[w0] && warp_open_s;
    const bool open_e = warp_end && warp_open_e;
    if (!open_s && !open_e) {
      dst[j][0] = out + static_cast<int64_t>(id[j]) * cols;
    } else if ((open_s && warp > 0) || (open_e && warp < kWarps - 1)) {
      in_smem[j] = true;
      if (open_s) dst[j][0] = s_piece + (warp * 2 + 0) * kColChunk;
      if (open_e) dst[j][1] = s_piece + (warp * 2 + 1) * kColChunk;
    } else {
      if (open_s) dst[j][0] = edges + (tile * 2 + 0) * cols;
      if (open_e) dst[j][1] = edges + (tile * 2 + 1) * cols;
    }
  }
  // warp w's segments: does its last one go on into w + 1, is it one run
  auto link = [&](int w) {
    return sid[(w + 1) * kWarpEntries - 1] == sid[(w + 1) * kWarpEntries];
  };
  auto single = [&](int w) {
    return sid[w * kWarpEntries] == sid[(w + 1) * kWarpEntries - 1];
  };
  for (int c0 = 0; c0 < cols; c0 += kColChunk) {
    const int cc = kColumns ? min(cols - c0, kColChunk) : 1;
    if (kColumns && bulk) {
      dmlc_flash_hopper::mbar_wait(&s_bar, 0);
    } else if (kColumns) {
      // s_slab[e * stride + c] = contrib[base + e, c0 + c]: element i of
      // the pass is entry i / cc, column i % cc; all copies in flight
      const int n = kTile * cc;
      int e = t / cc;
      int c = t - e * cc;
      const int de = kThreads / cc, dc = kThreads - de * cc;
      for (int i = t; i < n; i += kThreads) {
        float* dst = s_slab + e * stride + c;
        if (base + e < entries) {
          copy4_async(dst, contrib + (base + e) * cols + c0 + c);
        } else {
          *dst = 0.0f;
        }
        e += de;
        c += dc;
        if (c >= cc) c -= cc, ++e;
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    for (int c = 0; c < cc; ++c) {
      float v[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        v[j] = kColumns ? s_slab[(kPerThread * t + j) * stride + c] : v1[j];
      }
      // the thread's run pieces in entry order
      float loc[kPerThread];
      loc[0] = v[0];
#pragma unroll
      for (int j = 1; j < kPerThread; ++j) {
        loc[j] = same[j] ? loc[j - 1] + v[j] : v[j];
      }
      // the segmented scan of the threads' last pieces over the warp
      float s = loc[kPerThread - 1];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float up = __shfl_up_sync(kFull, s, 1 << k);
        if (add_mask & (1u << k)) s = up + s;
      }
      const float carry = __shfl_up_sync(kFull, s, 1);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float value = cont[j] ? carry + loc[j] : loc[j];
        const int at = in_smem[j] ? c : c0 + c;
        if (dst[j][0]) dst[j][0][at] = value;
        if (dst[j][1]) dst[j][1][at] = value;
      }
    }
    __syncthreads();
    // the runs over warps a .. w: warp a's last piece, then the first
    // pieces of a + 1 .. w in warp order (a warp that one run fills left
    // its sum in both slots); thread t takes warp a = t / cc, column t % cc
    if (t < kWarps * cc) {
      const int a = t / cc;
      const int c = t - a * cc;
      const int r = sid[(a + 1) * kWarpEntries - 1];
      if (a < kWarps - 1 && link(a) && !(a > 0 && link(a - 1) && single(a)) &&
          in_rows(r, num_rows)) {
        float acc = s_piece[(a * 2 + 1) * kColChunk + c];
        int w = a + 1;
        for (;;) {
          acc += s_piece[(w * 2 + 0) * kColChunk + c];
          if (w < kWarps - 1 && link(w) && single(w)) {
            ++w;
          } else {
            break;
          }
        }
        const bool open_s = a == 0 && single(0) && tile_open_s;
        const bool open_e = w == kWarps - 1 && single(w) && tile_open_e;
        if (!open_s && !open_e) {
          out[static_cast<int64_t>(r) * cols + c0 + c] = acc;
        }
        if (open_s) edges[(tile * 2 + 0) * cols + c0 + c] = acc;
        if (open_e) edges[(tile * 2 + 1) * cols + c0 + c] = acc;
      }
    }
    if (c0 + kColChunk < cols) __syncthreads();  // before the next pass
  }

  // ---- 4. the chains over tiles ------------------------------------------
  // X: the tile's first run, come from the tile before; Y: its last run,
  // going on into the tile after, when that is not X (one run filling the
  // tile is X, a middle tile of its chain)
  const int first = sid[0];
  const int last = sid[kTile - 1];
  const bool has_x = tile_open_s && in_rows(first, num_rows);
  const bool through = tile_open_s && tile_open_e && first == last;
  const bool has_y = tile_open_e && !through && in_rows(last, num_rows);
  if (has_x && warp == 0) {
    // the chain's start: the last tile k <= tile - 1 that the run does not
    // enter from k - 1 (tile 0 at the latest)
    int hi = static_cast<int>(tile) - 1;
    unsigned stop = __ballot_sync(kFull, !(hi - lane >= 1 &&
                                           s_back[lane] == first));
    while (!stop) {  // a run over more than 33 tiles
      hi -= 32;
      const int k = hi - lane;
      stop = __ballot_sync(
          kFull, !(k >= 1 && row_ids[int64_t{k} * kTile - 1] == first));
    }
    if (lane == 0) s_chain_a = hi - (__ffs(stop) - 1);
  }
  __syncthreads();  // every piece of the tile is written
  if ((t == 0 && has_x) || (t == 32 && has_y)) {
    const bool x = t == 0;
    const int a = x ? s_chain_a : static_cast<int>(tile);
    unsigned long long delta = 1;
    if (x && !through) {  // the chain's end
      delta += static_cast<unsigned long long>(tile - a + 1) << 32;
    }
    const unsigned long long now = fixed_order::arrive_add(chains + a, delta);
    s_last[x ? 0 : 1] = (now >> 32) == (now & 0xffffffffu) ? now : 0;
  }
  __syncthreads();
  if (warp < 2 && s_last[warp] != 0) {
    // this CTA arrived last at the chain: its tile pieces, in tile order
    const bool x = warp == 0;
    const int r = x ? first : last;
    const int64_t a = x ? s_chain_a : tile;
    const int64_t n = static_cast<int64_t>(s_last[warp] >> 32);
    for (int c = lane; c < cols; c += 32) {
      out[static_cast<int64_t>(r) * cols + c] = fixed_order::ordered_sum(
          edges + (a * 2 + 1) * cols + c, edges + ((a + 1) * 2 + 0) * cols + c,
          2 * int64_t{cols}, n - 1);
    }
    if (lane == 0) chains[a] = 0;  // for the next call on the stream
  }
}

int smem_bytes(int64_t cols) {
  return kFixedBytes +
         (cols > 1 ? kTile * (static_cast<int>(std::min<int64_t>(
                                  cols, kColChunk)) | 1) * 4
                   : 0);
}

template <bool kColumns>
int launch(const float* contrib, const int* row_ids, int64_t entries,
           int num_rows, int cols, float* edges, unsigned long long* chains,
           float* out, int64_t num_tiles, cudaStream_t s) {
  const int bytes = smem_bytes(cols);
  auto kernel = seg_sum_kernel<kColumns>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(contrib) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(row_ids) % 16 == 0;
  kernel<<<static_cast<unsigned>(num_tiles), kThreads, bytes, s>>>(
      contrib, row_ids, entries, num_rows, cols, aligned, edges, chains, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel once on `stream`; contrib is [entries, cols] and out
// [num_rows, cols], both row-major; allocates nothing. `edges` holds
// max(1, ceil(entries / tile)) * 2 * cols floats of scratch; `chains` as
// many u64 counters, 0 before the first call and shared with no call on
// another stream (each call leaves them at 0). Returns cudaGetLastError(),
// or cudaErrorInvalidValue for what it does not take.
extern "C" int dmlc_coo_segment_sum(const float* contrib, const int* row_ids,
                                    int64_t entries, int64_t num_rows,
                                    int64_t cols, int tile, float* edges,
                                    unsigned long long* chains, float* out,
                                    void* stream) {
  if (tile != kTile || entries < 0 || num_rows <= 0 ||
      num_rows > 0x7ffffffe || cols <= 0 || cols > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t num_tiles = std::max<int64_t>(1, (entries + kTile - 1) / kTile);
  if (num_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = static_cast<int>(num_rows);
  const int c = static_cast<int>(cols);
  return cols == 1 ? launch<false>(contrib, row_ids, entries, rows, c, edges,
                                   chains, out, num_tiles, s)
                   : launch<true>(contrib, row_ids, entries, rows, c, edges,
                                  chains, out, num_tiles, s);
}

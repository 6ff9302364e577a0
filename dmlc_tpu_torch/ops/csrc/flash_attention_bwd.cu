// flash_attention_bwd: dQ, dK and dV of O = softmax(Q K^T / sqrt(D)) V from
// dO, the forward's logsumexp and delta = rowsum(dO * O), in one kernel.
//
// Replaces the backward of the TPU flash-attention kernel behind
// dmlc_tpu/ops/sequence_parallel.py, make_pallas_flash_local (JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq, reached through its
// custom_vjp).
//
// Shapes as in flash_attention_fwd.cu; lse and delta are [B, H, T]. With
// s = q.k / sqrt(D), P = exp(s - lse), dP = dO V^T and dS = P * (dP - delta):
//   dV = P^T dO,   dK = dS^T Q / sqrt(D),   dQ = dS K / sqrt(D).
//
// What bounds it on an H100: tensor-core operations, five T x T x D
// products a query head (S, dP, dV, dK, dQ), half of each when causal, each
// f32 product three TF32 products; the bytes moved are ~10^-4 of that. In
// practice instruction issue and the chain S -> P, dS -> dV, dK, dQ within a
// tile pace it: every A fragment is loaded and split in registers, and the
// tensor cores idle while P and dS are formed.
//
// Design (flash_hopper.cuh for the instructions):
// - A work item is (64-key K/V tile n, b, KV head). Its CTA holds K and V in
//   shared memory and walks the 32-query tiles from the last one down (to
//   the diagonal when causal), each for the G = H / Hkv query heads of the
//   group. For each (K/V tile, Q tile) pair it forms S and dP once and all
//   five products.
// - Every product is wgmma m64nNk8 TF32 with the 3-pass split of each f32
//   operand into big + small TF32 parts (flash_mma.cuh, split): f32 accuracy
//   on the tensor cores. wgmma takes TF32 K-major only, so each product is
//   oriented to keep its contraction index contiguous in its shared-memory
//   operand B, and A comes from registers, whose loads take any pattern:
//     S^T [key][q]  = K Q^T:     A = K (raw, split in registers),
//                                B = Q split, as [q][d];
//     dP^T [key][q] = V dO^T:    A = V (raw, split), B = dO split;
//     dV^T [d][key] += dO^T P:   A = dO^T from dO's split parts,
//                                B = P^T split, as [key][q];
//     dK^T [d][key] += Q^T dS:   A = Q^T from Q's split parts,
//                                B = dS^T split;
//     dQ^T [d][q]   = K^T dS^T:  A = K^T (raw K, split), B = dS split, as
//                                [q][key].
//   Q and dO are split once when their tile arrives, P^T, dS^T and dS once
//   when they are formed: the B operands cost no split on the issue path,
//   and an A split serves a whole row of N columns. No product is left on
//   mma.sync. Tensor-core sums stay short (they round toward zero): S and
//   dP sum 32 head-dim columns before an f32 add, dV and dK one Q tile, a
//   dQ part one K/V tile.
// - Two warpgroups, each holding the 64 keys. Each forms S^T and dP^T for
//   its own 16 of the tile's 32 queries (N = 16), then P and dS for them,
//   so neither waits on the other for P; one barrier publishes P^T, dS^T and
//   dS. Then warpgroup 0 adds dV, warpgroup 1 dK (each kept in registers
//   for the walk), and each forms half of the dQ part (head-dim halves at
//   D = 128, query halves below).
// - Copies: thread 0 streams Q and dO by TMA (4-d tensor maps over
//   [B, T, H, D], [32 queries][32 floats] boxes with the 128-byte swizzle,
//   rows past T as zeros) into one raw stage tracked by an mbarrier, as
//   soon as the split of the previous tile has read it: the copy of tile
//   i + 1 runs while tile i is multiplied (flash_hopper.cuh's box_map,
//   whose encoder comes from the driver: the library links no libcuda).
//   K and V arrive once an item by per-row cp.async.bulk into rows
//   padded to D + 4 floats (fragment loads conflict-free at constant
//   offsets; swizzled boxes cost an address computation a load, which the
//   issue rate felt), rows past T zeroed; lse and delta by plain loads a
//   tile ahead.
// - dQ is summed across CTAs in a fixed order with no float atomics. The
//   K/V tiles that touch Q tile m add their parts in ascending tile order,
//   0 first, n_hi(m) (the diagonal tile when causal) last, through an f32
//   accumulator [B, T, H, D]: the first stores its part, each later one
//   adds its part to the sum and stores, the last writes
//   dq = (sum + part) / sqrt(D) straight into the output. An int32 flag
//   per (b, h, Q tile) counts the parts added; only the flags are atomic.
//   Thread 0 runs one gpu-scope fence a tile: it releases the previous
//   tile's flag (its stores drained under this tile's split) and acquires
//   this tile's, read relaxed a tile ahead; the earlier sum is loaded
//   (L2, .cg) after the P/dS barrier, ahead of its use. The last part
//   resets the flag to 0.
// - Order: no deadlock, few stalls, a short tail. Items come from an int32
//   counter in the order n = 0 up to num_n - 1, the (b, KV head) pairs
//   interleaved within each n. A part of item (n, b, hk) waits only for
//   item (n - 1, b, hk), which a CTA took earlier and holds or has
//   finished: the smallest unfinished item waits on nothing, so the grid
//   (one CTA an SM, however many are resident) always moves. All walks go
//   down from the last Q tile, so the items of one wave reach each Q tile
//   in turn and item n runs a tile behind item n - 1 after its first
//   tiles; the heads sit inside the Q-tile loop so that a GQA walk does not
//   reach a tile ahead of the item it waits for. The longest causal walks
//   (n = 0) start first: in the simulation of
//   tests/test_torch_flash_schedule.py the path's run is 0.7 % over its
//   even share, where the diagonal-first mirror, which never waits, leaves
//   a 6.7 % tail. The counter and a second one that counts finished CTAs
//   are reset by the last CTA, so a call needs no memset.
// - Shared memory at D = 128: the raw Q/dO stage (32 KB), raw K and V
//   (66 KB), Q's and dO's split parts (64 KB), P^T, dS^T and dS split
//   (48 KB): 210 KB, one CTA an SM, from a 1024-byte aligned base. 64-query
//   tiles, or K and V held split, would not fit.
// - A wait (mbarrier or flag) that lasts 20 s traps instead of hanging.

#include "flash_attention.cuh"
#include "flash_hopper.cuh"
#include "flash_mma.cuh"

namespace {

using dmlc_flash::softmax_scale;
using dmlc_flash::valid_shape;
using dmlc_flash_mma::split;
using namespace dmlc_flash_hopper;

constexpr int kKvRows = 64;  // keys of a work item
constexpr int kQRows = 32;   // queries of a streamed tile
constexpr int kBwdThreads = 256;  // two warpgroups
constexpr int kScoreChunk = 4;  // k-steps of S and dP before an f32 add

static_assert(kQRows == 32, "threads 0-31 and 32-63 read a tile's lse, delta");

// named barriers (0 is __syncthreads)
constexpr int kBarTile = 1;  // a tile's operands split
constexpr int kBarPds = 2;   // its P^T, dS^T and dS written
// a warpgroup's queries in the score products
constexpr int kHalfQ = kQRows / 2;

// Shared memory, in floats from a 1024-byte aligned base, then two
// mbarriers and the item. The TMA boxes hold 32 floats a row with the
// 128-byte swizzle (flash_hopper.cuh, swizzled), D / 32 boxes a tensor; K
// and V are plain rows padded to D + 4 floats, so that the fragment loads
// are conflict-free with constant offsets.
template <int D>
struct Layout {
  static constexpr int kRS = D + 4;  // a raw K/V row, padded
  static constexpr int kQr = 0;                       // raw Q, dO of a tile
  static constexpr int kOr = kQr + kQRows * D;
  static constexpr int kK = kOr + kQRows * D;         // raw K, V of the item
  static constexpr int kV = kK + kKvRows * kRS;
  static constexpr int kLc = kV + kKvRows * kRS;      // the tile's lse2,
  static constexpr int kDc = kLc + kQRows;            // delta
  static constexpr int kQb = kDc + kQRows;  // canonical [q][d], big / small
  static constexpr int kQs = kQb + kQRows * D;
  static constexpr int kOb = kQs + kQRows * D;
  static constexpr int kOs = kOb + kQRows * D;
  static constexpr int kPb = kOs + kQRows * D;  // P^T [key][q]
  static constexpr int kPs = kPb + kKvRows * kQRows;
  static constexpr int kSb = kPs + kKvRows * kQRows;  // dS^T [key][q]
  static constexpr int kSs = kSb + kKvRows * kQRows;
  static constexpr int kTb = kSs + kKvRows * kQRows;  // dS [q][key]
  static constexpr int kTs = kTb + kKvRows * kQRows;
  static constexpr int kFloats = kTs + kKvRows * kQRows;
  static constexpr int kBytes = 4 * kFloats + 2 * 8 + 8;
  static_assert(kQb % 32 == 0, "operand tiles 128-byte aligned");
  static_assert(kOr % 256 == 0, "TMA boxes 1024-byte aligned");
};

// 64-row blocks of a head-dim-major product (dV^T, dK^T)
template <int D>
constexpr int kHeadBlocks = (D + 63) / 64;

// A fragments of K or V (raw rows r0 and r0 + 8, from column tig) for
// kScoreChunk k-steps from head-dim column d0, split
template <int D>
__device__ __forceinline__ void raw_rows(uint32_t (&ab)[kScoreChunk][4],
                                         uint32_t (&as)[kScoreChunk][4],
                                         const float* r0, int d0) {
  const float* r1 = r0 + 8 * Layout<D>::kRS;
#pragma unroll
  for (int s = 0; s < kScoreChunk; ++s) {
    const int d = d0 + 8 * s;
    split(r0[d], ab[s][0], as[s][0]);
    split(r1[d], ab[s][1], as[s][1]);
    split(r0[d + 4], ab[s][2], as[s][2]);
    split(r1[d + 4], ab[s][3], as[s][3]);
  }
}

// S^T (from raw K) or dP^T (from raw V) of the 64 keys against N of the
// tile's queries (B: Q's or dO's split parts from the first of them,
// [q][d]), summed kScoreChunk k-steps at a time on the tensor cores, then
// in f32. The fragments of chunk c + 1 are loaded and split while chunk c
// multiplies.
template <int D, int N>
__device__ __forceinline__ void scores(float (&acc)[N / 2], const float* raw,
                                       const float* bbig, const float* bsmall,
                                       int w, int gid, int tig) {
  constexpr int kChunks = D / (8 * kScoreChunk);
  const uint64_t db = canon_desc(bbig, D);
  const uint64_t ds = canon_desc(bsmall, D);
  const float* r0 = raw + (16 * w + gid) * Layout<D>::kRS + tig;
  uint32_t ab[2][kScoreChunk][4], as[2][kScoreChunk][4];
  float part[2][N / 2];
  raw_rows<D>(ab[0], as[0], r0, 0);
  mma3<N, kScoreChunk>(acc, ab[0], as[0], db, ds, false);
  wgmma_commit();
#pragma unroll
  for (int c = 1; c < kChunks; ++c) {
    raw_rows<D>(ab[c & 1], as[c & 1], r0, 8 * kScoreChunk * c);
    const uint64_t off = kDescKStep * kScoreChunk * c;
    mma3<N, kScoreChunk>(part[c & 1], ab[c & 1], as[c & 1], db + off,
                         ds + off, false);
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1 is done
    if (c == 1) {
      fence_operands(acc);
    } else {
      fence_operands(part[(c - 1) & 1]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] += part[(c - 1) & 1][i];
    }
  }
  wgmma_wait<0>();
  if (kChunks == 1) {
    fence_operands(acc);
  } else {
    fence_operands(part[(kChunks - 1) & 1]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += part[(kChunks - 1) & 1][i];
  }
}

// A fragments of X^T (rows: head-dim d0 + gid (+8); k: the tile's queries)
// from X's split parts [q][d]
template <int D>
__device__ __forceinline__ void split_rows_t(uint32_t (&ab)[kQRows / 8][4],
                                             uint32_t (&as)[kQRows / 8][4],
                                             const float* xb, const float* xs,
                                             int d0, int tig) {
#pragma unroll
  for (int s = 0; s < kQRows / 8; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + 8 * (i & 1);
      const int query = 8 * s + tig + 4 * (i >> 1);
      if (D >= 64 || d < D) {
        const int at = canon(query, d, D);
        ab[s][i] = __float_as_uint(xb[at]);
        as[s][i] = __float_as_uint(xs[at]);
      } else {
        ab[s][i] = 0u;
        as[s][i] = 0u;
      }
    }
  }
}

// acc += X^T · Y for the tile: dV^T (X = dO, Y = P^T) or dK^T (X = Q,
// Y = dS^T). A: X's split parts read transposed ([q][d] -> rows d), B: Y's
// split parts [key][q]; one fresh tensor-core sum over the tile's 32
// queries per 64-row block, added in f32.
template <int D>
__device__ __forceinline__ void value_product(
    float (&acc)[kHeadBlocks<D>][kKvRows / 2], const float* xb,
    const float* xs, const float* yb, const float* ys, int w, int gid,
    int tig) {
  constexpr int kSteps = kQRows / 8;
  const uint64_t db = canon_desc(yb, kQRows);
  const uint64_t ds = canon_desc(ys, kQRows);
#pragma unroll
  for (int mb = 0; mb < kHeadBlocks<D>; ++mb) {
    uint32_t ab[kSteps][4], as[kSteps][4];
    split_rows_t<D>(ab, as, xb, xs, 64 * mb + 16 * w + gid, tig);
    float part[kKvRows / 2];
    mma3<kKvRows, kSteps>(part, ab, as, db, ds, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < kKvRows / 2; ++i) acc[mb][i] += part[i];
  }
}

// the warpgroup's half of the dQ part: dQ^T = K^T dS^T over the item's 64
// keys; head-dim rows d_lo .. d_lo+63 (those below D), queries q_lo ..
// q_lo+N-1; one tensor-core sum over the 64 keys
template <int D, int N>
__device__ __forceinline__ void dq_part(float (&part)[N / 2], const float* sK,
                                        const float* tb, const float* ts,
                                        int d_lo, int q_lo, int w, int gid,
                                        int tig) {
  constexpr int kRS = Layout<D>::kRS;
  const uint64_t db = canon_desc(tb + canon(q_lo, 0, kKvRows), kKvRows);
  const uint64_t ds = canon_desc(ts + canon(q_lo, 0, kKvRows), kKvRows);
  uint32_t ab[2][4][4], as[2][4][4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = d_lo + 16 * w + gid + 8 * (i & 1);
        const int key = 32 * c + 8 * s + tig + 4 * (i >> 1);
        split(d < D ? sK[key * kRS + d] : 0.f, ab[c][s][i], as[c][s][i]);
      }
    }
    const uint64_t off = kDescKStep * 4 * c;
    mma3<N, 4>(part, ab[c], as[c], db + off, ds + off, c > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(part);
}

// 2^x in one MUFU op (relative error ~2^-22); arguments here are at most
// ~0, and results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P = exp2(s·scale·log2(e) - lse·log2(e)) and dS = P (dP - delta) for the
// warpgroup's 16 queries of the tile, split into P^T, dS^T ([key][q]) and
// dS ([q][key]); kMask: some key or query is past T or above the diagonal
template <int D, bool kCausal, bool kMask>
__device__ __forceinline__ void p_and_ds(float* sm, const float (&s)[kHalfQ / 2],
                                         const float (&dp)[kHalfQ / 2],
                                         int kb, int wg, int tig, int n0,
                                         int m0, int T, float scale2) {
  using L = Layout<D>;
#pragma unroll
  for (int e = 0; e < kHalfQ / 2; ++e) {
    const int key = kb + 8 * ((e >> 1) & 1);
    const int col = kHalfQ * wg + 8 * (e >> 2) + 2 * tig + (e & 1);
    const int query = m0 + col;
    const bool keep = !kMask || (query < T && n0 + key < T &&
                                 (!kCausal || n0 + key <= query));
    const float p =
        keep ? exp2_approx(fmaf(s[e], scale2, -sm[L::kLc + col])) : 0.f;
    const float ds = keep ? p * (dp[e] - sm[L::kDc + col]) : 0.f;
    uint32_t xb, xs;
    split(p, xb, xs);
    const int at = canon(key, col, kQRows);
    sm[L::kPb + at] = __uint_as_float(xb);
    sm[L::kPs + at] = __uint_as_float(xs);
    split(ds, xb, xs);
    sm[L::kSb + at] = __uint_as_float(xb);
    sm[L::kSs + at] = __uint_as_float(xs);
    const int tt = canon(col, key, kKvRows);
    sm[L::kTb + tt] = __uint_as_float(xb);
    sm[L::kTs + tt] = __uint_as_float(xs);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_o,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* dq_acc, int* sync, int B, int T, int H, int Hkv,
                 float scale) {
  using L = Layout<D>;
  constexpr int kMB = kHeadBlocks<D>;
  // dQ halves: head-dim rows at D = 128, queries below
  constexpr int kDqN = D == 128 ? kQRows : kQRows / 2;
  // the TMA boxes need a 1024-byte aligned base, which the declaration
  // asks for; a base that is not (no room is left to align it) traps
  extern __shared__ __align__(1024) float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  if ((smem_u32(sm) & 1023) != 0) __trap();
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kFloats);
  uint64_t* raw_full = kv_full + 1;
  int* s_item = reinterpret_cast<int*>(kv_full + 2);

  const int tid = static_cast<int>(threadIdx.x);
  const int wg = tid >> 7;  // the warpgroup: 0 adds dV, 1 dK
  const int wt = tid & 127;
  const int w = wt >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int group = H / Hkv;
  const int num_n = (T + kKvRows - 1) / kKvRows;
  const int num_m = (T + kQRows - 1) / kQRows;
  const int items = num_n * B * Hkv;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  int* work = sync;          // items taken
  int* finished = sync + 1;  // CTAs done
  int* flags = sync + 2;     // [B][H][num_m]: dQ parts added

  if (tid == 0) {
    mbar_init(kv_full, 32);
    mbar_init(raw_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  int kv_parity = 0, full_parity = 0;
  int* pending = nullptr;  // thread 0: a flag to release
  int seen = 0;            // ... and a relaxed read of the next tile's flag
  // P = exp(s·scale - lse) = exp2(s·scale·log2(e) - lse·log2(e))
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;
  for (;;) {
    if (tid == 0) *s_item = atomicAdd(work, 1);
    __syncthreads();
    const int item = *s_item;
    if (item >= items) break;
    const int n_idx = item / (B * Hkv);
    const int b = (item % (B * Hkv)) / Hkv;
    const int hk = item % Hkv;
    const int n0 = n_idx * kKvRows;
    const int m_first = kCausal ? n0 / kQRows : 0;
    const int tiles = group * (num_m - m_first);
    const int64_t kv_off = (static_cast<int64_t>(b) * T * Hkv + hk) * D;
    // the walk: Q tile m from the last down to m_first, and for each the
    // query heads h = hk·group + g of the group
    auto next = [&](int& g, int& m) {
      if (++g == group) {
        g = 0;
        --m;
      }
    };
    // thread 0: a tile's Q and dO boxes into the raw stage (TMA)
    auto issue_tile = [&](int g, int m) {
      mbar_arrive_expect_tx(raw_full, 2 * kQRows * D * 4);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        tma_load_4d(sm + L::kQr + c * kQRows * 32, &tm_q, 32 * c,
                    hk * group + g, m * kQRows, b, raw_full);
        tma_load_4d(sm + L::kOr + c * kQRows * 32, &tm_o, 32 * c,
                    hk * group + g, m * kQRows, b, raw_full);
      }
    };
    // a tile's dQ flag: [b][h][Q tile]
    auto flag_of = [&](int g, int m) {
      return flags + (static_cast<int64_t>(b) * H + hk * group + g) * num_m +
             m;
    };
    // threads 0-31: a tile's lse·log2(e); 32-63: its delta (0 past T)
    auto row_input = [&](int g, int m) {
      const int query = m * kQRows + (tid & 31);
      if (query >= T) return 0.f;
      const int64_t row =
          (static_cast<int64_t>(b) * H + hk * group + g) * T + query;
      return tid < 32 ? lse[row] * kLog2e : delta[row];
    };

    if (tid < 32) {
      // K and V of the item, a row a copy; rows past T are zeroed
      const int kv_valid = min(kKvRows, T - n0);
      for (int r = kv_valid + lane; r < kKvRows; r += 32) {
        for (int c = 0; c < D; ++c) {
          sm[L::kK + r * L::kRS + c] = 0.f;
          sm[L::kV + r * L::kRS + c] = 0.f;
        }
      }
      if (lane == 0) mbar_expect_tx(kv_full, 2 * kv_valid * D * 4);
      __syncwarp();
      for (int r = lane; r < kv_valid; r += 32) {
        const int64_t gk = kv_off + (n0 + r) * kv_stride;
        bulk_copy(sm + L::kK + r * L::kRS, k + gk, D * 4, kv_full);
        bulk_copy(sm + L::kV + r * L::kRS, v + gk, D * 4, kv_full);
      }
      mbar_arrive(kv_full);
      if (lane == 0) issue_tile(0, num_m - 1);
    }
    float row_in = tid < 2 * kQRows ? row_input(0, num_m - 1) : 0.f;

    float acc[kMB][kKvRows / 2];  // dV^T (warpgroup 0) or dK^T (1)
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int i = 0; i < kKvRows / 2; ++i) acc[mb][i] = 0.f;
    mbar_wait(kv_full, kv_parity);
    kv_parity ^= 1;

    int g = 0, m = num_m - 1;     // this tile
    int g1 = 0, m1 = num_m - 1;   // the next one
    next(g1, m1);
    for (int it = 0; it < tiles; ++it) {
      const int h = hk * group + g;
      const int m0 = m * kQRows;
      const int n_hi =
          kCausal ? min(num_n - 1, (m0 + kQRows - 1) / kKvRows) : num_n - 1;
      const bool first = n_idx == 0;
      const bool last = n_idx == n_hi;
      const bool more = it + 1 < tiles;
      int* flag = flag_of(g, m);
      mbar_wait(raw_full, full_parity);
      full_parity ^= 1;
      // the previous tile is done, its dQ stores too
      bar_sync(kBarTile, kBwdThreads);
      if (tid == 0) {
        // one fence: releases the previous tile's dQ part (its stores had
        // the previous tile's end to drain) and, after a relaxed read that
        // saw the lower K/V tiles' parts of this one, acquires them
        const bool ready = first || (it > 0 && seen == n_idx);
        if (pending != nullptr || (!first && ready)) fence_gpu();
        if (pending != nullptr) add_relaxed(pending);
        pending = nullptr;
        if (!ready) {
          wait_flag(flag, n_idx);
          fence_gpu();
        }
        if (more) seen = ld_relaxed(flag_of(g1, m1));
      }
      // warps 1-7 split the raw stage into the operand tiles (warp 0's
      // thread 0 has the fence)
      constexpr int kPerTile = kQRows * D / 4;  // float4s of one tensor
      for (int f = tid - 32; f < 2 * kPerTile; f += kBwdThreads - 32) {
        if (f < 0) break;
        const int x = f % kPerTile;
        const int query = 8 * ((x >> 3) / (D / 4)) + (x & 7);
        const int c = 4 * ((x >> 3) % (D / 4));
        const bool is_o = f >= kPerTile;
        const float4 raw = *reinterpret_cast<const float4*>(
            sm + (is_o ? L::kOr : L::kQr) + boxed(kQRows, query, c));
        uint4 big, small;
        split(raw.x, big.x, small.x);
        split(raw.y, big.y, small.y);
        split(raw.z, big.z, small.z);
        split(raw.w, big.w, small.w);
        const int at = canon(query, c, D);
        *reinterpret_cast<uint4*>(sm + (is_o ? L::kOb : L::kQb) + at) = big;
        *reinterpret_cast<uint4*>(sm + (is_o ? L::kOs : L::kQs) + at) = small;
      }
      if (tid < 2 * kQRows) sm[L::kLc + tid] = row_in;  // lse2, then delta
      fence_proxy_async();
      bar_sync(kBarTile, kBwdThreads);
      // the raw stage is free: the next tile's copies run under this one
      if (more) {
        if (tid == 0) issue_tile(g1, m1);
        if (tid < 2 * kQRows) row_in = row_input(g1, m1);
      }

      // this warpgroup's 16 queries: S^T and dP^T, then P and dS for them
      const int kb = 16 * w + gid;  // the thread's key rows kb, kb + 8
      float s[kHalfQ / 2], dp[kHalfQ / 2];
      const int qo = canon(kHalfQ * wg, 0, D);
      scores<D, kHalfQ>(s, sm + L::kK, sm + L::kQb + qo, sm + L::kQs + qo, w,
                        gid, tig);
      scores<D, kHalfQ>(dp, sm + L::kV, sm + L::kOb + qo, sm + L::kOs + qo,
                        w, gid, tig);
      // masks only where a key or query is past T, or the causal diagonal
      // crosses the tile
      if ((kCausal && n0 + kKvRows - 1 > m0) || n0 + kKvRows > T ||
          m0 + kQRows > T) {
        p_and_ds<D, kCausal, true>(sm, s, dp, kb, wg, tig, n0, m0, T,
                                   scale2);
      } else {
        p_and_ds<D, kCausal, false>(sm, s, dp, kb, wg, tig, n0, m0, T,
                                    scale2);
      }
      fence_proxy_async();
      bar_sync(kBarPds, kBwdThreads);

      // this warpgroup's half of the dQ part: head-dim rows d_lo .. at
      // D = 128, queries q_lo .. below
      const int d_lo = D == 128 ? 64 * wg : 0;
      const int q_lo = D == 128 ? 0 : 16 * wg;

      float prev[kDqN / 2];
#pragma unroll
      for (int e = 0; e < kDqN / 2; ++e) {
        const int d = d_lo + 16 * w + gid + 8 * ((e >> 1) & 1);
        const int query = m0 + q_lo + 8 * (e >> 2) + 2 * tig + (e & 1);
        prev[e] = !first && d < D && query < T
                      ? __ldcg(dq_acc + (static_cast<int64_t>(b) * T + query) *
                                            q_stride +
                               static_cast<int64_t>(h) * D + d)
                      : 0.f;
      }
      if (wg == 0) {
        value_product<D>(acc, sm + L::kOb, sm + L::kOs, sm + L::kPb,
                         sm + L::kPs, w, gid, tig);  // dV^T += dO^T P
      } else {
        value_product<D>(acc, sm + L::kQb, sm + L::kQs, sm + L::kSb,
                         sm + L::kSs, w, gid, tig);  // dK^T += Q^T dS
      }

      // the dQ part, added in the fixed order to the lower K/V tiles' sum
      float part[kDqN / 2];
      dq_part<D, kDqN>(part, sm + L::kK, sm + L::kTb, sm + L::kTs, d_lo, q_lo,
                       w, gid, tig);
#pragma unroll
      for (int e = 0; e < kDqN / 2; ++e) {
        const int d = d_lo + 16 * w + gid + 8 * ((e >> 1) & 1);
        const int query = m0 + q_lo + 8 * (e >> 2) + 2 * tig + (e & 1);
        if (d < D && query < T) {
          const int64_t at = (static_cast<int64_t>(b) * T + query) * q_stride +
                             static_cast<int64_t>(h) * D + d;
          const float x = prev[e] + part[e];
          if (last) {
            dq[at] = x * scale;
          } else {
            __stcg(dq_acc + at, x);
          }
        }
      }
      if (tid == 0) {
        if (!last) {
          pending = flag;  // released once every thread's stores are done
        } else if (!first) {
          atomicExch(flag, 0);  // ready for the next call
        }
      }
      g = g1;
      m = m1;
      next(g1, m1);
    }

    float* out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int e = 0; e < kKvRows / 2; ++e) {
        const int d = 64 * mb + 16 * w + gid + 8 * ((e >> 1) & 1);
        const int key = n0 + 8 * (e >> 2) + 2 * tig + (e & 1);
        if (d < D && key < T) {
          out[kv_off + key * kv_stride + d] = acc[mb][e] * mul;
        }
      }
    }
    __syncthreads();  // the item's shared memory is free
  }
  if (tid == 0) {
    if (pending != nullptr) {
      fence_gpu();
      add_relaxed(pending);
    }
    __threadfence();
    if (atomicAdd(finished, 1) == static_cast<int>(gridDim.x) - 1) {
      atomicExch(work, 0);
      atomicExch(finished, 0);
    }
  }
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv, *dq_acc;
  int* sync;
  int B, T, H, Hkv;
  float scale;
  cudaStream_t stream;
};

template <int D, bool kCausal>
int launch(const Args& a) {
  constexpr int kSmem = Layout<D>::kBytes;
  auto kernel = flash_bwd_kernel<D, kCausal>;
  CUtensorMap tm_q, tm_o;
  if (!box_map(&tm_q, a.q, a.B, a.T, a.H, D, kQRows) ||
      !box_map(&tm_o, a.dout, a.B, a.T, a.H, D, kQRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBwdThreads, kSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t items = static_cast<int64_t>((a.T + kKvRows - 1) / kKvRows) *
                        a.B * a.Hkv;
  const int grid = static_cast<int>(
      items < static_cast<int64_t>(sms) * per_sm ? items
                                                 : static_cast<int64_t>(sms) *
                                                       per_sm);
  kernel<<<grid, kBwdThreads, kSmem, a.stream>>>(
      a.k, a.v, tm_q, tm_o, a.lse, a.delta, a.dq, a.dk, a.dv,
      a.dq_acc, a.sync, a.B, a.T, a.H, a.Hkv, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_causal(bool causal, const Args& a) {
  return causal ? launch<D, true>(a) : launch<D, false>(a);
}

}  // namespace

// Launches on `stream` and allocates nothing. dq_acc is f32 scratch of dq's
// shape (its contents need not be set); sync holds 2 + B·H·ceil(T/32)
// int32 that are 0 before the call and 0 again after it. Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int dmlc_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dq, float* dk, float* dv,
    float* dq_acc, int* sync, int B, int T, int H, int Hkv, int D,
    int causal, void* stream) {
  if (!valid_shape(B, T, H, Hkv, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,  k,     v,  dout, lse,        delta,
               dq, dk,    dv, dq_acc, sync,     B,
               T,  H,     Hkv, softmax_scale(D),
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32:
      return dispatch_causal<32>(causal != 0, a);
    case 64:
      return dispatch_causal<64>(causal != 0, a);
    default:
      return dispatch_causal<128>(causal != 0, a);
  }
}

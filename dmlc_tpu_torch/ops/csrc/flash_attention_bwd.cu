// flash_attention_bwd: dQ, dK and dV of O = softmax(Q K^T / sqrt(D)) V from
// dO, the forward's logsumexp and delta = rowsum(dO * O).
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
// What bounds it on an H100: tensor-core operations. The dK/dV kernel does
// four T x T x D products per query head (S, dP, dV, dK) and the dQ kernel
// three (S, dP, dQ), half of each when causal, and every f32 product costs
// three TF32 products; the bytes moved are ~10^-4 of that. It replaces
// kernels whose f32 FMA loops on the CUDA cores were paced by their
// shared-memory operand reads at about half of the f32 peak. These reach
// about a quarter of the TF32 peak: instruction issue paces them, each
// loaded f32 value costing a load and its split beside its three mma.
//
// Design (flash_mma.cuh), two kernels, no atomics (the same inputs give the
// same bits):
// - Every product is mma.sync m16n8k8 TF32 with the 3-pass split of each
//   f32 operand into big + small TF32 parts: f32 accuracy on the tensor
//   cores. Tensor-core sums stay short (they round toward zero): the
//   score products S and dP add 32 head-dim columns on the tensor cores
//   before an f32 add, the value products one tile.
// - Eight warps a CTA in two groups of four; warp w of each group owns rows
//   16w .. 16w+15 of the CTA's 64-row tile, so the two warps of a pair own
//   the same rows and split the products between them, meeting at a
//   barrier of their own. Scores stay in the mma accumulators, where P, the
//   masks (causal, ragged tail) and dS = P (dP - delta) are computed and
//   fed straight back as the A operand of the next product, the k index
//   permuted to the accumulator's layout; a 16-row block crosses to the
//   pair warp through shared memory in fragment order.
// - dK/dV: one CTA per (64-row K/V tile, b, KV head). K and V stay in
//   shared memory, while the CTA walks the G = H / Hkv query heads of its
//   group and, for each, the Q tiles in order, from the diagonal on when
//   causal: the GQA sum over the group happens in one CTA in a fixed order.
//   Q, dO, lse and delta stream through a double buffer of cp.async copies,
//   the copy of tile i+1 in flight while tile i is multiplied. A tile is
//   taken in two halves of 32 queries. The P group forms S^T and P^T,
//   hands P^T to its pair and adds P^T dO to dV; the dS group forms dP^T,
//   dS^T with the pair's P^T and adds dS^T Q to dK. A half wholly above
//   the causal diagonal is skipped by both warps of the pair.
// - dQ: one CTA per (64-row Q tile, b, h), Q and dO in shared memory, K and
//   V streaming through a cp.async double buffer up to the diagonal. One
//   group forms S, the other dP; the first forms dS and hands it back, and
//   each group adds dS K for its half of the head dim.
// Shared memory at D = 128: 208 KB (dQ) and 209 KB (dK/dV), one CTA of
// eight warps an SM; at D = 64 and 32 less than half of that.

#include "flash_attention.cuh"
#include "flash_mma.cuh"

namespace {

using dmlc_flash::softmax_scale;
using dmlc_flash::valid_shape;
using namespace dmlc_flash_mma;

// two resident tiles, a double buffer of two streamed tiles and a 64 x 64
// block exchanged between the two warp groups
template <int D>
constexpr int dq_smem() {
  return static_cast<int>(sizeof(float)) * (6 * kRows * D + kRows * kRows);
}

// ... and the streamed tiles' lse and delta rows; the block exchanged is
// 64 x 32, one for each half of a tile
template <int D>
constexpr int dkv_smem() {
  return static_cast<int>(sizeof(float)) *
         (6 * kRows * D + 4 * kRows + kRows * kRows);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int T, int H, int Hkv,
                     float scale) {
  constexpr int kTile = kRows * D;
  constexpr int kHalf = kRows / 2;  // queries of one half-tile
  constexpr int kNT = kHalf / 8;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile;
  float* sQ = sV + kTile;        // 2 stages
  float* sdO = sQ + 2 * kTile;   // 2 stages
  float* sL = sdO + 2 * kTile;   // 2 stages of kRows
  float* sDelta = sL + 2 * kRows;
  float* sP = sDelta + 2 * kRows;  // [half][warp of a group][kNT][4][32]

  const int n0 = static_cast<int>(blockIdx.x) * kRows;  // causal: heaviest first
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int group = H / Hkv;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * T * Hkv + hk) * D;
  const int lane = threadIdx.x & 31;
  const int w4 = (threadIdx.x >> 5) & 3;
  const bool ds_group = threadIdx.x >= kThreads / 2;
  const int r0 = 16 * w4;  // the pair's rows (keys) of the tile
  const int gid = lane >> 2;
  const int tig = lane & 3;

  // the streamed tiles: (query head g, Q tile m) for g < group, m from
  // m_first, flattened so the copy runs ahead across head boundaries
  const int m_first = kCausal ? n0 : 0;
  const int num_m = (T - m_first + kRows - 1) / kRows;
  const int total = group * num_m;
  auto issue = [&](int it) {
    const int h = hk * group + it / num_m;
    const int m0 = m_first + (it % num_m) * kRows;
    const int st = it & 1;
    const int64_t q_off = (static_cast<int64_t>(b) * T * H + h) * D;
    const int64_t row_off = (static_cast<int64_t>(b) * H + h) * T;
    load_tile_async<D>(sQ + st * kTile, q + q_off, q_stride, m0, T);
    load_tile_async<D>(sdO + st * kTile, dout + q_off, q_stride, m0, T);
    load_rows_async(sL + st * kRows, lse + row_off, m0, T);
    load_rows_async(sDelta + st * kRows, delta + row_off, m0, T);
    cp_async_commit();
  };

  load_tile_async<D>(sK, k + kv_off, kv_stride, n0, T);
  load_tile_async<D>(sV, v + kv_off, kv_stride, n0, T);
  issue(0);  // one group with K and V

  // dV in the P group, dK in the dS group
  float acc[D / 8][4];
#pragma unroll
  for (int e = 0; e < D / 8; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[e][i] = 0.f;

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it is whole in its stage
    const int st = it & 1;
    const int m0 = m_first + (it % num_m) * kRows;
    const float* cQ = sQ + st * kTile;
    const float* cdO = sdO + st * kTile;
    const float* cL = sL + st * kRows;
    const float* cDelta = sDelta + st * kRows;
#pragma unroll 1
    for (int c0 = 0; c0 < kRows; c0 += kHalf) {
      // every query of this half is before every key of the pair: P = 0
      if (kCausal && n0 + r0 > m0 + c0 + kHalf - 1) continue;
      float* pair_p = sP + ((c0 / kHalf) * 4 + w4) * kNT * 4 * 32;
      // transposed blocks: rows are keys n0+r0+.., columns queries m0+c0+..
      float x[kNT][4];
      uint32_t ab[kNT][4], as[kNT][4];
      if (!ds_group) {
        mma_abt<D, kNT>(sK, r0, cQ, c0, x, lane);  // S^T
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = n0 + r0 + gid + 8 * (i >> 1);
            const int col = c0 + 8 * j + 2 * tig + (i & 1);
            const int query = m0 + col;
            const bool keep = query < T && (!kCausal || key <= query);
            x[j][i] = keep ? expf(x[j][i] * scale - cL[col]) : 0.f;
          }
        }
        frag_store<kNT>(pair_p, x, lane);
        pair_sync(w4);  // P^T is in shared memory
        split_a<kNT>(x, ab, as);
        mma_pv<D, kNT, D / 8>(ab, as, cdO, c0, 0, acc, lane);  // dV
      } else {
        mma_abt<D, kNT>(sV, r0, cdO, c0, x, lane);  // dP^T
        pair_sync(w4);
        float p[kNT][4];
        frag_load<kNT>(pair_p, p, lane);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = c0 + 8 * j + 2 * tig + (i & 1);
            x[j][i] = p[j][i] * (x[j][i] - cDelta[col]);
          }
        }
        split_a<kNT>(x, ab, as);
        mma_pv<D, kNT, D / 8>(ab, as, cQ, c0, 0, acc, lane);  // dK
      }
    }
    // stage st and both halves of P^T are read; the next issue and the
    // next tile overwrite them
    __syncthreads();
  }

  if (!ds_group) {
    store_rows<D / 8>(dv + kv_off, kv_stride, n0 + r0, 0, T, acc, 1.f, lane);
  } else {
    store_rows<D / 8>(dk + kv_off, kv_stride, n0 + r0, 0, T, acc, scale,
                      lane);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int T, int H, int Hkv, float scale) {
  constexpr int kTile = kRows * D;
  constexpr int kNT = kRows / 8;
  constexpr int kNE = D / 16;  // each group's half of the head dim
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kTile;
  float* sK = sdO + kTile;      // 2 stages
  float* sV = sK + 2 * kTile;   // 2 stages
  float* sX = sV + 2 * kTile;   // [warp of a group][kNT][4][32]: dP, then dS

  const int num_m = (T + kRows - 1) / kRows;
  const int m0 = (num_m - 1 - static_cast<int>(blockIdx.x)) * kRows;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t q_off = (static_cast<int64_t>(b) * T * H + h) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * T * Hkv + hk) * D;
  const int lane = threadIdx.x & 31;
  const int w4 = (threadIdx.x >> 5) & 3;
  const int grp = threadIdx.x >= kThreads / 2 ? 1 : 0;
  const int r0 = 16 * w4;  // the pair's rows (queries) of the tile
  const int gid = lane >> 2;
  const int tig = lane & 3;
  float* pair_x = sX + w4 * kNT * 4 * 32;

  const int n_end = kCausal ? min(T, m0 + kRows) : T;
  const int num_n = (n_end + kRows - 1) / kRows;
  auto issue = [&](int it) {
    const int st = it & 1;
    load_tile_async<D>(sK + st * kTile, k + kv_off, kv_stride, it * kRows, T);
    load_tile_async<D>(sV + st * kTile, v + kv_off, kv_stride, it * kRows, T);
    cp_async_commit();
  };

  load_tile_async<D>(sQ, q + q_off, q_stride, m0, T);
  load_tile_async<D>(sdO, dout + q_off, q_stride, m0, T);
  issue(0);  // one group with Q and dO

  // lse and delta of the thread's two rows, gid and gid + 8
  float l_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + r0 + gid + 8 * i;
    const int64_t at_row = (static_cast<int64_t>(b) * H + h) * T + row;
    l_r[i] = row < T ? lse[at_row] : 0.f;
    d_r[i] = row < T ? delta[at_row] : 0.f;
  }
  // the group's half of the head dim: columns 8·kNE·grp ..
  float acc[kNE][4];
#pragma unroll
  for (int e = 0; e < kNE; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[e][i] = 0.f;

  for (int it = 0; it < num_n; ++it) {
    if (it + 1 < num_n) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it is whole in its stage
    const int n0 = it * kRows;
    const float* cK = sK + (it & 1) * kTile;
    const float* cV = sV + (it & 1) * kTile;
    float x[kNT][4];
    if (grp == 0) {
      mma_abt<D, kNT>(sQ, r0, cK, 0, x, lane);  // S
      pair_sync(w4);  // dP is in shared memory
      float dp[kNT][4];
      frag_load<kNT>(pair_x, dp, lane);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + r0 + gid + 8 * (i >> 1);
          const int key = n0 + 8 * j + 2 * tig + (i & 1);
          const bool keep = row < T && key < T && (!kCausal || key <= row);
          const float pv = keep ? expf(x[j][i] * scale - l_r[i >> 1]) : 0.f;
          x[j][i] = pv * (dp[j][i] - d_r[i >> 1]);
        }
      }
      frag_store<kNT>(pair_x, x, lane);
      pair_sync(w4);  // dS is in shared memory
    } else {
      mma_abt<D, kNT>(sdO, r0, cV, 0, x, lane);  // dP
      frag_store<kNT>(pair_x, x, lane);
      pair_sync(w4);
      pair_sync(w4);  // dS is in shared memory
      frag_load<kNT>(pair_x, x, lane);
    }
    uint32_t ab[kNT][4], as[kNT][4];
    split_a<kNT>(x, ab, as);
    mma_pv<D, kNT, kNE>(ab, as, cK, 0, kNE * grp, acc, lane);
    __syncthreads();  // stage it & 1 and dS are read; the next overwrite
  }

  store_rows<kNE>(dq + q_off, q_stride, m0 + r0, 8 * kNE * grp, T, acc,
                  scale, lane);
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  float *dq, *dk, *dv;
  int B, T, H, Hkv;
  float scale;
  cudaStream_t stream;
};

template <int D, bool kCausal>
int launch_dkv(const Args& a) {
  constexpr int kSmem = dkv_smem<D>();
  auto kernel = flash_bwd_dkv_kernel<D, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + kRows - 1) / kRows, a.B * a.Hkv);
  kernel<<<grid, kThreads, kSmem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                              a.delta, a.dk, a.dv, a.T, a.H,
                                              a.Hkv, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int launch_dq(const Args& a) {
  constexpr int kSmem = dq_smem<D>();
  auto kernel = flash_bwd_dq_kernel<D, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.T + kRows - 1) / kRows, a.B * a.H);
  kernel<<<grid, kThreads, kSmem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse,
                                              a.delta, a.dq, a.T, a.H, a.Hkv,
                                              a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDkv, int D>
int dispatch_causal(bool causal, const Args& a) {
  if (kDkv) return causal ? launch_dkv<D, true>(a) : launch_dkv<D, false>(a);
  return causal ? launch_dq<D, true>(a) : launch_dq<D, false>(a);
}

template <bool kDkv>
int dispatch(int D, bool causal, const Args& a) {
  if (!valid_shape(a.B, a.T, a.H, a.Hkv, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 32:
      return dispatch_causal<kDkv, 32>(causal, a);
    case 64:
      return dispatch_causal<kDkv, 64>(causal, a);
    default:
      return dispatch_causal<kDkv, 128>(causal, a);
  }
}

}  // namespace

// Both launch on `stream` and allocate nothing. Return cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a shape they do not take.
extern "C" int dmlc_flash_attention_bwd_dkv(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dk, float* dv, int B, int T,
    int H, int Hkv, int D, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
               B, T, H, Hkv, softmax_scale(D),
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(D, causal != 0, a);
}

extern "C" int dmlc_flash_attention_bwd_dq(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, float* dq, int B, int T, int H,
    int Hkv, int D, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
               B, T, H, Hkv, softmax_scale(D),
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(D, causal != 0, a);
}

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
// What bounds it on an H100: operations. The dK/dV kernel does four
// T x T x D products per query head (S, dP, dV, dK) and the dQ kernel three
// (S, dP, dQ), half of each when causal; the bytes moved are ~10^-4 of that.
//
// Design, two kernels, no atomics (the same inputs give the same bits):
// - dK/dV: one CTA per (64-row K/V tile, b, KV head). K and V stay in
//   shared memory and dK, dV in registers, while the CTA loops over the
//   G = H / Hkv query heads of its group and, for each, over the Q tiles
//   in order, from the diagonal on when causal. So the GQA sum over the
//   group happens in one CTA in a fixed order, and nothing of the repeated
//   K/V of the JAX adapter exists. The scores are computed transposed
//   (S^T = K Q^T), so that P^T and dS^T land in shared memory in the layout
//   the dV and dK products read.
// - dQ: one CTA per (64-row Q tile, b, h), Q and dO in shared memory, dQ in
//   registers, looping over the K/V tiles up to the diagonal.
// 150 KB of shared memory at D = 128: one CTA per SM.

#include "flash_attention.cuh"

namespace {

using namespace dmlc_flash;

template <int D>
constexpr int dkv_smem() {
  return static_cast<int>(sizeof(float)) *
         (4 * kBlock * Cols<D>::kLd + kBlock * kPLd + 2 * kBlock);
}

template <int D>
constexpr int dq_smem() {
  return static_cast<int>(sizeof(float)) *
         (4 * kBlock * Cols<D>::kLd + kBlock * kPLd);
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
  using C = Cols<D>;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kBlock * C::kLd;
  float* sQ = sV + kBlock * C::kLd;
  float* sdO = sQ + kBlock * C::kLd;
  float* sP = sdO + kBlock * C::kLd;
  float* sL = sP + kBlock * kPLd;
  float* sDelta = sL + kBlock;

  const int n0 = static_cast<int>(blockIdx.x) * kBlock;  // causal: heaviest first
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int group = H / Hkv;
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * T * Hkv + hk) * D;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<D>(sK, k + kv_off, kv_stride, n0, T);
  load_tile<D>(sV, v + kv_off, kv_stride, n0, T);

  float dk_acc[4][C::kPer], dv_acc[4][C::kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < C::kPer; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t q_off = (static_cast<int64_t>(b) * T * H + h) * D;
    const float* lse_row = lse + (static_cast<int64_t>(b) * H + h) * T;
    const float* delta_row = delta + (static_cast<int64_t>(b) * H + h) * T;
    for (int m0 = kCausal ? n0 : 0; m0 < T; m0 += kBlock) {
      __syncthreads();  // the last tile's reads of Q, dO and P are done
      load_tile<D>(sQ, q + q_off, q_stride, m0, T);
      load_tile<D>(sdO, dout + q_off, q_stride, m0, T);
      if (threadIdx.x < kBlock) {
        const int row = m0 + threadIdx.x;
        sL[threadIdx.x] = row < T ? lse_row[row] : 0.f;
        sDelta[threadIdx.x] = row < T ? delta_row[row] : 0.f;
      }
      __syncthreads();
      // transposed scores: rows are keys 4ty+i, columns queries tx+16j
      float p[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = dp[i][j] = 0.f;
      mm_abt<D>(sK, sQ, p, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = n0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = m0 + tx + 16 * j;
          const bool keep = qc < T && (!kCausal || kr <= qc);
          p[i][j] = keep ? expf(p[i][j] * scale - sL[tx + 16 * j]) : 0.f;
          sP[(4 * ty + i) * kPLd + tx + 16 * j] = p[i][j];
        }
      }
      mm_abt<D>(sV, sdO, dp, ty, tx);
      __syncthreads();  // P^T is whole
      mm_ab<D>(sP, sdO, dv_acc, ty, tx);
      __syncthreads();  // done reading P^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sP[(4 * ty + i) * kPLd + tx + 16 * j] =
              p[i][j] * (dp[i][j] - sDelta[tx + 16 * j]);
        }
      __syncthreads();  // dS^T is whole
      mm_ab<D>(sP, sQ, dk_acc, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + 4 * ty + i;
    if (row < T) {
      store_row<D>(dk + kv_off, kv_stride, row, dk_acc[i], scale, tx);
      store_row<D>(dv + kv_off, kv_stride, row, dv_acc[i], 1.f, tx);
    }
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
  using C = Cols<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kBlock * C::kLd;
  float* sK = sdO + kBlock * C::kLd;
  float* sV = sK + kBlock * C::kLd;
  float* sP = sV + kBlock * C::kLd;

  const int num_m = (T + kBlock - 1) / kBlock;
  const int m0 = (num_m - 1 - static_cast<int>(blockIdx.x)) * kBlock;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t q_off = (static_cast<int64_t>(b) * T * H + h) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * T * Hkv + hk) * D;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<D>(sQ, q + q_off, q_stride, m0, T);
  load_tile<D>(sdO, dout + q_off, q_stride, m0, T);
  float l_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * T + row;
    l_r[i] = row < T ? lse[at] : 0.f;
    d_r[i] = row < T ? delta[at] : 0.f;
  }
  float dq_acc[4][C::kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < C::kPer; ++e) dq_acc[i][e] = 0.f;

  const int n_end = kCausal ? min(T, m0 + kBlock) : T;
  for (int n0 = 0; n0 < n_end; n0 += kBlock) {
    __syncthreads();  // the last tile's reads of K and dS are done
    load_tile<D>(sK, k + kv_off, kv_stride, n0, T);
    load_tile<D>(sV, v + kv_off, kv_stride, n0, T);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_abt<D>(sQ, sK, s, ty, tx);
    mm_abt<D>(sdO, sV, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = m0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = n0 + tx + 16 * j;
        const bool keep = qr < T && kc < T && (!kCausal || kc <= qr);
        const float p = keep ? expf(s[i][j] * scale - l_r[i]) : 0.f;
        sP[(4 * ty + i) * kPLd + tx + 16 * j] = p * (dp[i][j] - d_r[i]);
      }
    }
    __syncthreads();  // dS is whole
    mm_ab<D>(sP, sK, dq_acc, ty, tx);
  }

  float* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row < T) store_row<D>(dqb, q_stride, row, dq_acc[i], scale, tx);
  }
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
  const dim3 grid((a.T + kBlock - 1) / kBlock, a.B * a.Hkv);
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
  const dim3 grid((a.T + kBlock - 1) / kBlock, a.B * a.H);
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

// flash_attention_fwd: O = softmax(Q K^T / sqrt(D) [+ causal mask]) V and the
// per-row logsumexp, without ever holding a T x T score matrix.
//
// Replaces the forward of the TPU flash-attention kernel behind
// dmlc_tpu/ops/sequence_parallel.py, make_pallas_flash_local (JAX's
// jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_impl; its l and m residuals become one logsumexp row).
//
// q [B, T, H, D], k and v [B, T, Hkv, D] f32 contiguous, H % Hkv == 0 (GQA:
// query head h reads KV head h / (H / Hkv), with no repeated K/V in memory);
// o [B, T, H, D]; lse [B, H, T] (natural log of the row's sum of
// exp(score)). D is 32, 64 or 128; any T (a ragged last tile is masked).
//
// What bounds it on an H100: two products of 2*T*T*D flops per head (half
// of that when causal) against reading q, k, v once: at T = 16384, D = 128
// that is ~32,000 flops per byte, far above the card's ratio, so it is
// bound by operations. In f32 on the CUDA cores the peak is 67 TFLOP/s.
//
// Design: one CTA per (64-row Q tile, b, h); heaviest causal tiles launch
// first. The Q tile stays in shared memory; the CTA walks the K tiles in
// order, keeping the online-softmax state (row max m, row sum l, O
// accumulator) in registers. Each K tile: S = Q K^T as 4x4 register tiles,
// mask, running max and sum over the 16 lanes of a row, P to shared memory,
// then V overwrites K in the same buffer and O += P V. Tiles wholly above
// the causal diagonal are never visited, so a row's max is finite from the
// first tile on (key 0 is visible to every query) and exp(-inf - m) is 0,
// never NaN. 85 KB of shared memory at D = 128: two CTAs per SM.

#include "flash_attention.cuh"

namespace {

using namespace dmlc_flash;

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int Hkv,
                 float scale) {
  using C = Cols<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBlock * C::kLd;
  float* sP = sKV + kBlock * C::kLd;

  const int num_m = (T + kBlock - 1) / kBlock;
  const int m0 = (num_m - 1 - static_cast<int>(blockIdx.x)) * kBlock;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const float* qb = q + (static_cast<int64_t>(b) * T * H + h) * D;
  const float* kb = k + (static_cast<int64_t>(b) * T * Hkv + hk) * D;
  const float* vb = v + (static_cast<int64_t>(b) * T * Hkv + hk) * D;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<D>(sQ, qb, q_stride, m0, T);

  float m_i[4], l_i[4], acc[4][C::kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int e = 0; e < C::kPer; ++e) acc[i][e] = 0.f;
  }

  const int n_end = kCausal ? min(T, m0 + kBlock) : T;
  for (int n0 = 0; n0 < n_end; n0 += kBlock) {
    __syncthreads();  // the last tile's reads of V and P are done
    load_tile<D>(sKV, kb, kv_stride, n0, T);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    mm_abt<D>(sQ, sKV, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = m0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = n0 + tx + 16 * j;
        const bool keep = kj < T && (!kCausal || kj <= qi);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(4 * ty + i) * kPLd + tx + 16 * j] = p;
      }
      l_i[i] = l_i[i] * corr + row_sum16(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int e = 0; e < C::kPer; ++e) acc[i][e] *= corr;
    }
    __syncthreads();  // P is whole and nobody reads K any more
    load_tile<D>(sKV, vb, kv_stride, n0, T);
    __syncthreads();
    mm_ab<D>(sP, sKV, acc, ty, tx);
  }

  float* ob = o + (static_cast<int64_t>(b) * T * H + h) * D;
  float* lse_row = lse + (static_cast<int64_t>(b) * H + h) * T;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row < T) {
      store_row<D>(ob, q_stride, row, acc[i], 1.f / l_i[i], tx);
      if (tx == 0) lse_row[row] = m_i[i] + logf(l_i[i]);
    }
  }
}

template <int D, bool kCausal>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int T, int H, int Hkv, cudaStream_t stream) {
  constexpr int kSmem =
      static_cast<int>(sizeof(float)) * (2 * kBlock * Cols<D>::kLd +
                                         kBlock * kPLd);
  auto kernel = flash_fwd_kernel<D, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kBlock - 1) / kBlock, B * H);
  kernel<<<grid, kThreads, kSmem, stream>>>(q, k, v, o, lse, T, H, Hkv,
                                            softmax_scale(D));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(bool causal, const float* q, const float* k, const float* v,
             float* o, float* lse, int B, int T, int H, int Hkv,
             cudaStream_t stream) {
  return causal ? launch<D, true>(q, k, v, o, lse, B, T, H, Hkv, stream)
                : launch<D, false>(q, k, v, o, lse, B, T, H, Hkv, stream);
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int dmlc_flash_attention_fwd(const float* q, const float* k,
                                        const float* v, float* o, float* lse,
                                        int B, int T, int H, int Hkv, int D,
                                        int causal, void* stream) {
  if (!valid_shape(B, T, H, Hkv, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_d<32>(causal != 0, q, k, v, o, lse, B, T, H, Hkv, s);
    case 64:
      return launch_d<64>(causal != 0, q, k, v, o, lse, B, T, H, Hkv, s);
    default:
      return launch_d<128>(causal != 0, q, k, v, o, lse, B, T, H, Hkv, s);
  }
}

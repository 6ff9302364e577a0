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
// What bounds it on an H100: tensor-core operations. Two products of
// 2*T*T*D flops per head (half of that when causal) against reading q, k, v
// once: ~32,000 flops per byte at T = 16384, D = 128. Each f32 product is
// three TF32 products (flash_mma.cuh: big + small split of each operand),
// so the bound is 3 x that work at 495 TFLOP/s.
//
// Design, one CTA per (128-row Q tile, b, h), heaviest causal tiles first,
// eight warps, each owning 16 query rows:
// - Every product is mma.sync m16n8k8 TF32 with the 3-pass split: f32
//   accuracy on the tensor cores. The scores of a K tile stay in the warp's
//   accumulators, where the scale, the masks, the running max and sum
//   (quad shuffles), exp and the rescale of O happen; P goes straight back
//   as the A operand of P V (split_a), with no trip through shared memory.
// - Operands are split once per CTA, not once per warp: Q when the CTA
//   starts, each streamed K and V tile once after its copy lands. The split
//   parts are stored in fragment order (one 16-byte lane load a fragment
//   pair), so the warps' product loops are loads and mma only.
// - K/V stream in 32-row tiles through a cp.async double buffer; the copy
//   of tile i+1 is in flight while tile i is split and multiplied. Shared
//   memory at D = 128 is the reason for the sizes: Q's two parts take 128
//   KB, the two raw stages 64 KB, and each stage's raw K and V are
//   overwritten by their big parts in place (all reads first, one barrier,
//   then the writes), beside one 32 KB buffer of small parts: 224 KB, one
//   CTA an SM. 64-row K/V tiles, or separate big buffers, would not fit.
// - Tensor-core sums stay short (a tensor-core accumulation rounds toward
//   zero): the score product sums 32 head-dim columns (12 mma) on the
//   tensor cores before an f32 add, P V one 32-key tile (12 mma).
// - Tiles wholly above the causal diagonal are never visited (per warp: a
//   warp whose rows end before the tile skips its products), so a row's
//   max is finite from the first tile on (key 0 is visible to every query)
//   and exp(-inf - m) is 0, never NaN. No atomics: the same inputs give the
//   same bits on every run.

#include "flash_attention.cuh"
#include "flash_mma.cuh"

namespace {

using dmlc_flash::softmax_scale;
using dmlc_flash::valid_shape;
using namespace dmlc_flash_mma;

constexpr int kQRows = 16 * kWarps;  // query rows of a CTA: 128
constexpr int kKRows = 32;           // keys of a streamed K/V tile
constexpr int kPartSteps = 4;        // k-steps of 8 summed before an f32 add

// Q's big and small parts, two raw/big K+V stages, K+V small parts
template <int D>
constexpr int fwd_smem() {
  return static_cast<int>(sizeof(float)) *
         (2 * kQRows * D + 4 * kKRows * D + 2 * kKRows * D);
}

__device__ __forceinline__ void split4(float a, float b, float c, float d,
                                       uint4& big, uint4& small) {
  split(a, big.x, small.x);
  split(b, big.y, small.y);
  split(c, big.z, small.z);
  split(d, big.w, small.w);
}

// The swizzled raw Q tile (kQRows x D) into its parts in fragment order:
// uint4 f = (w * D/8 + s) * 32 + lane holds the A fragment (a0..a3) of
// warp w's rows for k-step s.
template <int D>
__device__ __forceinline__ void split_q(const float* raw, uint4* qb,
                                        uint4* qs) {
  constexpr int kN = kQRows * D / 4;
#pragma unroll 4
  for (int f = threadIdx.x; f < kN; f += kThreads) {
    const int lane = f & 31;
    const int s = (f >> 5) % (D / 8);
    const int w = (f >> 5) / (D / 8);
    const int r = 16 * w + (lane >> 2);
    const int c = 8 * s + (lane & 3);
    split4(raw[at<D>(r, c)], raw[at<D>(r + 8, c)], raw[at<D>(r, c + 4)],
           raw[at<D>(r + 8, c + 4)], qb[f], qs[f]);
  }
}

// One stage's raw K and V tiles (kKRows x D each, swizzled, K then V) split
// in place: the big parts overwrite the stage, the small parts go to
// `small` (K's, then V's). Fragment order:
// - K, the B operand of Q K^T: uint4 f = (s * 2 + jp) * 32 + lane holds
//   (b0, b1) of key blocks 2jp and 2jp+1 for k-step s;
// - V, the B operand of P V with P's k-slots permuted as split_a leaves
//   them (k-slot tig is key 2tig, tig+4 is key 2tig+1): uint4
//   f = (j * D/16 + ep) * 32 + lane holds (b0, b1) of column blocks 2ep and
//   2ep+1 for key block j.
// Every read pattern is free of bank conflicts under at<D>'s swizzle.
template <int D>
__device__ __forceinline__ void split_kv(float* stage, uint4* small) {
  constexpr int kN = kKRows * D / 4;  // uint4 of each of K and V
  constexpr int kPer = kN / kThreads;
  static_assert(kN % kThreads == 0, "whole rounds of splits");
  const float* K = stage;
  const float* V = stage + kKRows * D;
  float xk[kPer][4], xv[kPer][4];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int f = static_cast<int>(threadIdx.x) + i * kThreads;
    const int lane = f & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    int r = 16 * ((f >> 5) & 1) + gid;
    int c = 8 * (f >> 6) + tig;
    xk[i][0] = K[at<D>(r, c)];
    xk[i][1] = K[at<D>(r, c + 4)];
    xk[i][2] = K[at<D>(r + 8, c)];
    xk[i][3] = K[at<D>(r + 8, c + 4)];
    r = 8 * ((f >> 5) / (D / 16)) + 2 * tig;
    c = 16 * ((f >> 5) % (D / 16)) + gid;
    xv[i][0] = V[at<D>(r, c)];
    xv[i][1] = V[at<D>(r + 1, c)];
    xv[i][2] = V[at<D>(r, c + 8)];
    xv[i][3] = V[at<D>(r + 1, c + 8)];
  }
  __syncthreads();  // every raw value is read before any is overwritten
  uint4* kb = reinterpret_cast<uint4*>(stage);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int f = static_cast<int>(threadIdx.x) + i * kThreads;
    split4(xk[i][0], xk[i][1], xk[i][2], xk[i][3], kb[f], small[f]);
    split4(xv[i][0], xv[i][1], xv[i][2], xv[i][3], kb[kN + f],
           small[kN + f]);
  }
}

// c[j][.] += the warp's 16 x 32 scores Q K^T over the k-steps st0 ..
// st0+kPart-1, from the split parts (qb/qs point at the warp's fragments).
// The 3 mma of a product go in rounds over the four key blocks, small
// terms first.
template <int kPart>
__device__ __forceinline__ void score_part(const uint4* qb, const uint4* qs,
                                           const uint4* kb, const uint4* ks,
                                           int st0, float (&c)[4][4],
                                           int lane) {
#pragma unroll
  for (int i = 0; i < kPart; ++i) {
    const int st = st0 + i;
    const uint4 a4 = qb[st * 32 + lane];
    const uint4 s4 = qs[st * 32 + lane];
    const uint32_t ab[4] = {a4.x, a4.y, a4.z, a4.w};
    const uint32_t as[4] = {s4.x, s4.y, s4.z, s4.w};
    uint32_t bb[4][2], bs[4][2];
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const uint4 b4 = kb[(st * 2 + jp) * 32 + lane];
      const uint4 t4 = ks[(st * 2 + jp) * 32 + lane];
      bb[2 * jp][0] = b4.x;
      bb[2 * jp][1] = b4.y;
      bb[2 * jp + 1][0] = b4.z;
      bb[2 * jp + 1][1] = b4.w;
      bs[2 * jp][0] = t4.x;
      bs[2 * jp][1] = t4.y;
      bs[2 * jp + 1][0] = t4.z;
      bs[2 * jp + 1][1] = t4.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(c[j], as, bb[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(c[j], ab, bs[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(c[j], ab, bb[j]);
  }
}

// s[j][.] = the warp's 16 x 32 scores Q K^T (unscaled). Each part of
// kPartSteps k-steps is summed on the tensor cores, and the parts with f32
// adds; the first part goes straight into s (from zero, the same value).
template <int D>
__device__ __forceinline__ void scores(const uint4* qb, const uint4* qs,
                                       const uint4* kb, const uint4* ks,
                                       float (&s)[4][4], int lane) {
  constexpr int kSteps = D / 8;
  constexpr int kPart = kSteps < kPartSteps ? kSteps : kPartSteps;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  score_part<kPart>(qb, qs, kb, ks, 0, s, lane);
  // one part at a time: unrolled further, the compiler hoists the next
  // parts' loads and the causal D = 128 variant spills
#pragma unroll 1
  for (int p = kPart; p < kSteps; p += kPart) {
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
    score_part<kPart>(qb, qs, kb, ks, p, part, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] += part[j][i];
  }
}

// acc[e][.] += P V for the tile's 32 keys, P split by split_a; each group of
// four output column blocks is summed on the tensor cores over the tile
// (12 mma) into fresh accumulators and added to acc in f32.
template <int D>
__device__ __forceinline__ void pv(const uint32_t (&pb)[4][4],
                                   const uint32_t (&ps)[4][4],
                                   const uint4* vb, const uint4* vs,
                                   float (&acc)[D / 8][4], int lane) {
  constexpr int kNE = D / 8;
#pragma unroll
  for (int eg = 0; eg < kNE; eg += 4) {
    float part[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[e][i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = (j * (D / 16) + eg / 2 + h) * 32 + lane;
        const uint4 b4 = vb[f];
        const uint4 t4 = vs[f];
        bb[2 * h][0] = b4.x;
        bb[2 * h][1] = b4.y;
        bb[2 * h + 1][0] = b4.z;
        bb[2 * h + 1][1] = b4.w;
        bs[2 * h][0] = t4.x;
        bs[2 * h][1] = t4.y;
        bs[2 * h + 1][0] = t4.z;
        bs[2 * h + 1][1] = t4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) mma_tf32(part[e], ps[j], bb[e]);
#pragma unroll
      for (int e = 0; e < 4; ++e) mma_tf32(part[e], pb[j], bs[e]);
#pragma unroll
      for (int e = 0; e < 4; ++e) mma_tf32(part[e], pb[j], bb[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[eg + e][i] += part[e][i];
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int Hkv,
                 float scale) {
  constexpr int kKV = kKRows * D;  // floats of one K or V tile
  constexpr int kNE = D / 8;       // output column blocks of a warp
  extern __shared__ float4 smem4[];
  uint4* sQb = reinterpret_cast<uint4*>(smem4);
  uint4* sQs = sQb + kQRows * D / 4;
  float* sRaw = reinterpret_cast<float*>(sQs + kQRows * D / 4);  // 2 stages
  uint4* sSmall = reinterpret_cast<uint4*>(sRaw + 4 * kKV);

  const int num_m = (T + kQRows - 1) / kQRows;
  const int m0 = (num_m - 1 - static_cast<int>(blockIdx.x)) * kQRows;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const int64_t q_off = (static_cast<int64_t>(b) * T * H + h) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * T * Hkv + hk) * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int r0 = m0 + 16 * warp;  // the warp's first query row

  // Q through the raw stages (exactly kQRows x D floats), split once
  load_tile_async<D, kQRows>(sRaw, q + q_off, q_stride, m0, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_q<D>(sRaw, sQb, sQs);
  __syncthreads();  // the raw stages are free for K and V

  const int n_end = kCausal ? min(T, m0 + kQRows) : T;
  const int num_n = (n_end + kKRows - 1) / kKRows;
  auto issue = [&](int it) {
    float* st = sRaw + (it & 1) * 2 * kKV;
    load_tile_async<D, kKRows>(st, k + kv_off, kv_stride, it * kKRows, T);
    load_tile_async<D, kKRows>(st + kKV, v + kv_off, kv_stride,
                               it * kKRows, T);
    cp_async_commit();
  };
  issue(0);

  float acc[kNE][4];
#pragma unroll
  for (int e = 0; e < kNE; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[e][i] = 0.f;
  // the thread's rows gid and gid + 8: running max, and its own share of
  // the running sum (the quad adds its four shares at the end)
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  const uint4* qb = sQb + warp * (D / 8) * 32;
  const uint4* qs = sQs + warp * (D / 8) * 32;

  for (int it = 0; it < num_n; ++it) {
    cp_async_wait<0>();
    // tile it has landed; every warp is done with tile it-1's parts, so
    // its stage and the small buffer may be overwritten
    __syncthreads();
    if (it + 1 < num_n) issue(it + 1);
    float* stage = sRaw + (it & 1) * 2 * kKV;
    split_kv<D>(stage, sSmall);
    __syncthreads();  // the tile's parts are whole
    const int n0 = it * kKRows;
    if (kCausal && n0 > r0 + 15) continue;  // every key after every row

    const uint4* kb = reinterpret_cast<const uint4*>(stage);
    float s[4][4];
    scores<D>(qb, qs, kb, sSmall, s, lane);

    const bool edge =
        (kCausal && n0 + kKRows - 1 > r0) || n0 + kKRows > T;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[j][i] * scale;
        if (edge) {
          const int key = n0 + 8 * j + 2 * tig + (i & 1);
          const int row = r0 + gid + 8 * (i >> 1);
          const bool keep = key < T && (!kCausal || key <= row);
          x = keep ? x : -INFINITY;
        }
        s[j][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
      corr[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[j][i] - m_r[i >> 1]);
        s[j][i] = p;
        l_r[i >> 1] += p;
      }
    }
#pragma unroll
    for (int e = 0; e < kNE; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[e][i] *= corr[i >> 1];

    uint32_t pb[4][4], ps[4][4];
    split_a<4>(s, pb, ps);
    pv<D>(pb, ps, kb + kKV / 4, sSmall + kKV / 4, acc, lane);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] = quad_sum(l_r[r]);
    inv[r] = 1.f / l_r[r];
  }
#pragma unroll
  for (int e = 0; e < kNE; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[e][i] *= inv[i >> 1];
  store_rows<kNE>(o + q_off, q_stride, r0, 0, T, acc, 1.f, lane);
  if (tig == 0) {
    float* lse_row = lse + (static_cast<int64_t>(b) * H + h) * T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + gid + 8 * r;
      if (row < T) lse_row[row] = m_r[r] + logf(l_r[r]);
    }
  }
}

template <int D, bool kCausal>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int T, int H, int Hkv, cudaStream_t stream) {
  constexpr int kSmem = fwd_smem<D>();
  auto kernel = flash_fwd_kernel<D, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kQRows - 1) / kQRows, B * H);
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

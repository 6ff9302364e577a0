// Tiles and tile products shared by flash_attention_fwd.cu and
// flash_attention_bwd.cu.
//
// A CTA of kThreads = 256 threads is a 16 x 16 grid: ty = tid / 16 owns
// the tile rows 4*ty .. 4*ty+3, and tx = tid % 16 owns the score columns
// tx, tx+16, tx+32, tx+48 and a slice of the head dim (see Cols). Every
// product is f32 FMA on the CUDA cores: no tensor cores, so no TF32.
//
// Tiles of 64 rows x D live in shared memory row-major with a leading dim
// of D + 4 floats: the float4 reads of rows tx, tx+16, ... then fall on
// distinct banks (D + 4 = 4 mod 32), and every row stays 16-byte aligned.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dmlc_flash {

constexpr int kBlock = 64;               // rows of a Q tile and of a K tile
constexpr int kThreads = 256;
constexpr int kPLd = kBlock + 4;         // leading dim of a 64 x 64 tile

template <int D>
struct Cols {
  // head-dim columns owned by thread tx: j*16*kVec + tx*kVec + e
  static constexpr int kLd = D + 4;
  static constexpr int kVec = D >= 64 ? 4 : 2;
  static constexpr int kChunks = D / (16 * kVec);
  static constexpr int kPer = D / 16;    // kChunks * kVec
  static __device__ __forceinline__ int col(int j, int tx) {
    return j * 16 * kVec + tx * kVec;
  }
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows row0 .. row0+63 of one head of a [B, T, heads, D] tensor into a
// [64][D+4] tile; rows at or past T are zeros. `g` points at (b, t=0, head),
// `row_stride` = heads * D.
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g,
                                          int64_t row_stride, int row0,
                                          int T) {
  constexpr int kLd = D + 4;
  constexpr int kPerRow = D / 4;
  for (int f = threadIdx.x; f < kBlock * kPerRow; f += kThreads) {
    const int r = f / kPerRow;
    const int c = (f % kPerRow) * 4;
    const int row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < T) {
      v = *reinterpret_cast<const float4*>(g + row * row_stride + c);
    }
    *reinterpret_cast<float4*>(s + r * kLd + c) = v;
  }
}

// acc[i][j] += A[4ty+i, :] . B[tx+16j, :] for two [64][D+4] tiles.
template <int D>
__device__ __forceinline__ void mm_abt(const float* A, const float* B,
                                       float (&acc)[4][4], int ty, int tx) {
  constexpr int kLd = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * kLd + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kLd + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][*] += sum_c P[4ty+i, c] * M[c, cols of tx] for a [64][64+4] tile P
// and a [64][D+4] tile M, c in order 0..63.
template <int D>
__device__ __forceinline__ void mm_ab(const float* P, const float* M,
                                      float (&acc)[4][D / 16], int ty,
                                      int tx) {
  using C = Cols<D>;
#pragma unroll 2
  for (int c = 0; c < kBlock; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kPLd + c);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float* row = M + (c + cc) * C::kLd;
      float m[C::kPer];
#pragma unroll
      for (int j = 0; j < C::kChunks; ++j) {
        if constexpr (C::kVec == 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(row + C::col(j, tx));
          m[4 * j] = t.x;
          m[4 * j + 1] = t.y;
          m[4 * j + 2] = t.z;
          m[4 * j + 3] = t.w;
        } else {
          const float2 t =
              *reinterpret_cast<const float2*>(row + C::col(j, tx));
          m[2 * j] = t.x;
          m[2 * j + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = comp(p[i], cc);
#pragma unroll
        for (int e = 0; e < C::kPer; ++e) acc[i][e] = fmaf(pv, m[e], acc[i][e]);
      }
    }
  }
}

// Row `row` of a [B, T, heads, D] output (pointer at (b, t=0, head)) from
// the thread's accumulator slice, times `mul`.
template <int D>
__device__ __forceinline__ void store_row(float* __restrict__ g,
                                          int64_t row_stride, int row,
                                          const float (&acc)[D / 16], float mul,
                                          int tx) {
  using C = Cols<D>;
  float* out = g + row * row_stride;
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j) {
    if constexpr (C::kVec == 4) {
      *reinterpret_cast<float4*>(out + C::col(j, tx)) =
          make_float4(acc[4 * j] * mul, acc[4 * j + 1] * mul,
                      acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    } else {
      *reinterpret_cast<float2*>(out + C::col(j, tx)) =
          make_float2(acc[2 * j] * mul, acc[2 * j + 1] * mul);
    }
  }
}

// Sum (or max) over the 16 lanes that share a ty: xor offsets below 16
// stay inside the half-warp, and every lane ends with the same bits.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The softmax scale 1/sqrt(D), rounded to f32 once from double.
inline float softmax_scale(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

inline bool valid_shape(int B, int T, int H, int Hkv, int D) {
  return B > 0 && T > 0 && Hkv > 0 && H > 0 && H % Hkv == 0 &&
         (D == 32 || D == 64 || D == 128) &&
         static_cast<int64_t>(B) * H <= 65535;
}

}  // namespace dmlc_flash

// Tensor-core tiles for flash_attention_fwd.cu and flash_attention_bwd.cu:
// f32-accurate products as three TF32 mma.sync products, and tiles copied
// with cp.async.
//
// A CTA of kThreads = 256 threads is eight warps. In the backward they form
// two groups of four; warp w of a group owns the rows 16w .. 16w+15 of its
// 64-row tile, and the two warps of a pair share those rows and meet at a
// barrier of their own (pair_sync). Products are
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 accumulating in f32
// registers. Each f32 operand x is split as big = rna.tf32(x) and
// small = rna.tf32(x - big) (round to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds), and a product is small·big + big·small +
// big·big (the scheme of CUTLASS's OpMultiplyAddFastF32): the dropped
// small·small term and the rounding of `small` are ~2^-21 of |x·y|, so the
// result keeps f32 accuracy where one TF32 pass keeps ~3 digits.
//
// m16n8k8 fragments, with gid = lane >> 2 and tig = lane & 3:
//   A (16 x 8): a0 (gid, tig), a1 (gid+8, tig), a2 (gid, tig+4),
//               a3 (gid+8, tig+4);
//   B (8 x 8):  b0 (k tig, n gid), b1 (k tig+4, n gid);
//   C (16 x 8): c0 (gid, 2tig), c1 (gid, 2tig+1), c2 (gid+8, 2tig),
//               c3 (gid+8, 2tig+1).
// A score accumulator is fed back as the A operand of the next product
// with no trip through shared memory: its column 2tig goes into k-slot tig
// and 2tig+1 into k-slot tig+4, and the B rows are read in that same order.
//
// Tiles of rows x D (D a multiple of 32) sit in shared memory row-major
// with no padding; element (r, c) is at r*D + (c ^ ((r & 7) << 2)). That
// XOR keeps every 4-float group whole (16-byte cp.async stores), and both
// read patterns are free of bank conflicts: (row gid, col tig) and
// (row 2tig or 2tig+1, col gid).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dmlc_flash_mma {

constexpr int kRows = 64;  // rows of the backward's tiles
constexpr int kWarps = 8;  // warps of a CTA
constexpr int kThreads = 32 * kWarps;

template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * D + (c ^ ((r & 7) << 2));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the two warps that own rows 16w .. 16w+15 (w < 4), and only they, wait
// here for each other (named barrier 1 + w; 0 is __syncthreads)
__device__ __forceinline__ void pair_sync(int w) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + w) : "memory");
}

// A warp's 16 x 8NT accumulator block in shared memory, in fragment order:
// the pair warp, whose lanes own the same elements, reads it back
// conflict-free.
template <int NT>
__device__ __forceinline__ void frag_store(float* s, const float (&x)[NT][4],
                                           int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[(4 * j + i) * 32 + lane] = x[j][i];
}

template <int NT>
__device__ __forceinline__ void frag_load(const float* s, float (&x)[NT][4],
                                          int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[j][i] = s[(4 * j + i) * 32 + lane];
}

// 16 bytes from global to shared, or 16 zero bytes when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0+R-1 of one head of a [B, T, heads, D] tensor into a
// swizzled tile; rows at or past T are zeros. `g` points at (b, t=0, head),
// `row_stride` = heads * D.
template <int D, int R = kRows>
__device__ __forceinline__ void load_tile_async(float* s,
                                                const float* __restrict__ g,
                                                int64_t row_stride, int row0,
                                                int T) {
  constexpr int kPerRow = D / 4;
  static_assert(R * kPerRow % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < R * kPerRow / kThreads; ++i) {
    const int f = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = f / kPerRow;
    const int c = (f % kPerRow) * 4;
    const int row = row0 + r;
    const bool valid = row < T;
    cp_async16(s + at<D>(r, c), g + (valid ? row : 0) * row_stride + c,
               valid);
  }
}

// g[row0 .. row0+63] into s[0 .. 63]; zeros at or past T.
__device__ __forceinline__ void load_rows_async(float* s,
                                                const float* __restrict__ g,
                                                int row0, int T) {
  if (threadIdx.x < kRows) {
    const int row = row0 + static_cast<int>(threadIdx.x);
    const bool valid = row < T;
    cp_async4(s + threadIdx.x, g + (valid ? row : 0), valid);
  }
}

// x as a TF32 operand rounded to nearest, ties away from zero: half a
// TF32 ulp added to the bits, whose low 13 the tensor cores drop (CUTLASS's
// round_half_ulp_truncate). The same value as cvt.rna.tf32.f32, formed on
// the full-rate integer pipe instead of the conversion unit, whose rate
// would pace the splits.
__device__ __forceinline__ uint32_t tf32_operand(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// big + small = x to ~2^-22 |x|: big with its low 13 bits cleared, so that
// x - big is exact
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_operand(x) & 0xffffe000u;
  small = tf32_operand(x - __uint_as_float(big));
}

// Four 8x8 blocks of 16-bit pairs, i.e. four 8 x 4 f32 blocks, with one
// ldmatrix.x4 (each lane names one 16-byte row), split into TF32 parts.
// Lane gid·4 + tig gets row gid, column tig of each block: the A fragment
// of m16n8k8 (rows 0-7/8-15 x columns 0-3/4-7) or the B fragments of two
// column blocks.
__device__ __forceinline__ void ldmatrix_split(const float* row,
                                               uint32_t (&big)[4],
                                               uint32_t (&small)[4]) {
  uint32_t r[4];
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), big[i], small[i]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[j][.] += X[r0 .. r0+15, d0 .. d0+31] · Y[c0+8j .. c0+8j+7, d0 ..
// d0+31]^T for j < NT: one 32-column part of mma_abt, 12 mma a block. Each
// k-step issues its 3·NT mma in three rounds over j, the small terms first,
// so that NT independent products stand between two that share an
// accumulator.
template <int D, int NT>
__device__ __forceinline__ void mma_abt_part(const float* X, int r0,
                                             const float* Y, int c0, int d0,
                                             float (&c)[NT][4], int lane) {
  static_assert(NT % 2 == 0, "ldmatrix.x4 takes two column blocks");
  // ldmatrix row addresses: lane l names row l & 7 of 8x8 b16 matrix l >> 3
  const int mi = lane >> 3;
  const int rr = lane & 7;
  const int a_row = r0 + rr + 8 * (mi & 1);
  const int a_col = 4 * (mi >> 1);
  const int b_row = c0 + rr + 8 * (mi >> 1);
  const int b_col = 4 * (mi & 1);
#pragma unroll 2
  for (int d = d0; d < d0 + 32; d += 8) {
    uint32_t ab[4], as[4];
    ldmatrix_split(X + at<D>(a_row, d + a_col), ab, as);
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b4[4], s4[4];
      ldmatrix_split(Y + at<D>(b_row + 8 * j, d + b_col), b4, s4);
      bb[j][0] = b4[0];
      bb[j][1] = b4[1];
      bb[j + 1][0] = b4[2];
      bb[j + 1][1] = b4[3];
      bs[j][0] = s4[0];
      bs[j][1] = s4[1];
      bs[j + 1][0] = s4[2];
      bs[j + 1][1] = s4[3];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[j], as, bb[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[j], ab, bs[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[j], ab, bb[j]);
  }
}

// acc[j][.] = X[r0 .. r0+15, :] · Y[c0+8j .. c0+8j+7, :]^T over the head
// dim, for j < NT: a 16 x 8NT score block of the warp (X, Y swizzled
// tiles). Each 32 head-dim columns are summed on the tensor cores and the
// parts added in f32: a tensor-core accumulation rounds toward zero. The
// first part goes straight into acc (from zero, the same value).
template <int D, int NT>
__device__ __forceinline__ void mma_abt(const float* X, int r0,
                                        const float* Y, int c0,
                                        float (&acc)[NT][4], int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  mma_abt_part<D, NT>(X, r0, Y, c0, 0, acc, lane);
#pragma unroll
  for (int d0 = 32; d0 < D; d0 += 32) {
    float part[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
    mma_abt_part<D, NT>(X, r0, Y, c0, d0, part, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
  }
}

// The warp's 16 x 8NT block p, in the C fragments of mma_abt, as the A
// operand of mma_pv, split: within each group of 8 columns, k-slot tig is
// column 2tig and k-slot tig+4 column 2tig+1.
template <int NT>
__device__ __forceinline__ void split_a(const float (&p)[NT][4],
                                        uint32_t (&big)[NT][4],
                                        uint32_t (&small)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split(p[j][0], big[j][0], small[j][0]);
    split(p[j][2], big[j][1], small[j][1]);
    split(p[j][1], big[j][2], small[j][2]);
    split(p[j][3], big[j][3], small[j][3]);
  }
}

// acc[e][.] += P · Z[c0 .. c0+8NT-1, 8(e0+e) .. 8(e0+e)+7] for e < NE, with
// P split by split_a. Each tile's product is summed on the tensor cores
// into fresh accumulators (3·NT mma long) and added to acc with f32 adds:
// a tensor-core accumulation rounds toward zero, and a chain over the
// whole sequence would pile that bias up. Four output column blocks are
// taken at a time, their mma issued in rounds as in mma_abt.
template <int D, int NT, int NE>
__device__ __forceinline__ void mma_pv(const uint32_t (&pb)[NT][4],
                                       const uint32_t (&ps)[NT][4],
                                       const float* Z, int c0, int e0,
                                       float (&acc)[NE][4], int lane) {
  constexpr int kG = NE < 4 ? NE : 4;
  static_assert(NE % kG == 0, "whole groups of column blocks");
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int eg = 0; eg < NE; eg += kG) {
    float part[kG][4];
#pragma unroll
    for (int e = 0; e < kG; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[e][i] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = c0 + 8 * j + 2 * tig;
      uint32_t bb[kG][2], bs[kG][2];
#pragma unroll
      for (int e = 0; e < kG; ++e) {
        const int c = 8 * (e0 + eg + e) + gid;
        split(Z[at<D>(r, c)], bb[e][0], bs[e][0]);
        split(Z[at<D>(r + 1, c)], bb[e][1], bs[e][1]);
      }
#pragma unroll
      for (int e = 0; e < kG; ++e) mma_tf32(part[e], ps[j], bb[e]);
#pragma unroll
      for (int e = 0; e < kG; ++e) mma_tf32(part[e], pb[j], bs[e]);
#pragma unroll
      for (int e = 0; e < kG; ++e) mma_tf32(part[e], pb[j], bb[e]);
    }
#pragma unroll
    for (int e = 0; e < kG; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[eg + e][i] += part[e][i];
  }
}

// The warp's rows row0 .. row0+15, columns col0 .. col0+8NE-1, of a
// [B, T, heads, D] output (pointer at (b, t=0, head)) from its
// accumulator, times `mul`; rows at or past T are not written.
template <int NE>
__device__ __forceinline__ void store_rows(float* __restrict__ g,
                                           int64_t row_stride, int row0,
                                           int col0, int T,
                                           const float (&acc)[NE][4],
                                           float mul, int lane) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + gid + 8 * half;
    if (row < T) {
      float* out = g + row * row_stride + col0 + 2 * tig;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        *reinterpret_cast<float2*>(out + 8 * e) =
            make_float2(acc[e][2 * half] * mul, acc[e][2 * half + 1] * mul);
      }
    }
  }
}

}  // namespace dmlc_flash_mma

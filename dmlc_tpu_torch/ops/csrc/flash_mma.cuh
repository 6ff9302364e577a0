// Tensor-core tiles for flash_attention_fwd.cu: f32-accurate products as
// three TF32 mma.sync products, and tiles copied with cp.async; the split
// (`split`) is flash_attention_bwd.cu's too.
//
// A CTA of kThreads = 256 threads is eight warps. Products are
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

constexpr int kWarps = 8;  // warps of a CTA
constexpr int kThreads = 32 * kWarps;

template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * D + (c ^ ((r & 7) << 2));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
template <int D, int R>
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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp's 16 x 8NT block p, in the C fragments of an m16n8k8 product,
// as the A operand of the next product, split: within each group of 8 columns, k-slot tig is
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

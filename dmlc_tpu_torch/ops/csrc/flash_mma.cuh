// The f32-accurate split of the flash kernels' tensor-core operands
// (flash_attention_fwd.cu and flash_attention_bwd.cu).
//
// Each f32 operand x is split as big = rna.tf32(x) and small =
// rna.tf32(x - big) (round to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds), and a product is small·big + big·small +
// big·big, summed in f32 on the tensor cores (the scheme of CUTLASS's
// OpMultiplyAddFastF32): the dropped small·small term and the rounding of
// `small` are ~2^-21 of |x·y|, so the result keeps f32 accuracy where one
// TF32 pass keeps ~3 digits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dmlc_flash_mma {

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

}  // namespace dmlc_flash_mma

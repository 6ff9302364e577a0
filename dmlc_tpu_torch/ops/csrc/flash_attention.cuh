// Host-side helpers shared by flash_attention_fwd.cu and
// flash_attention_bwd.cu: the softmax scale and the shapes the kernels take.

#pragma once

#include <math.h>
#include <stdint.h>

namespace dmlc_flash {

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

// fixed_order.cuh: the cross-CTA sums of coo_segment_sum.cu and
// fused_linear_grads.cu, in an order that does not depend on which CTA
// arrives first, with no float atomics.
//
// A CTA writes its partial sums to device memory, then arrives: one thread
// adds to an integer counter with an acq_rel atomic at gpu scope, after a
// barrier of the CTA (release: the CTA's writes are visible before its
// arrival; acquire: the thread that sees the last arrival then sees every
// other CTA's writes). The CTA that arrives last reads the partial sums
// back from L2 (`ld.global.cg`: no stale L1 line) and adds them in a fixed
// order, so the bits depend only on the inputs. No CTA waits on another:
// every one finishes whatever the others do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fixed_order {

// atom.inc: returns the old value and wraps the counter to 0 after `last`,
// so that a counter that `last + 1` CTAs arrive at is 0 again for the next
// call on the stream.
__device__ __forceinline__ unsigned arrive_ticket(unsigned* counter,
                                                  unsigned last) {
  unsigned ticket;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
               : "=r"(ticket) : "l"(counter), "r"(last) : "memory");
  return ticket;
}

// Adds `delta` and returns the counter's new value.
__device__ __forceinline__ unsigned long long arrive_add(
    unsigned long long* counter, unsigned long long delta) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;\n"
               : "=l"(old) : "l"(counter), "l"(delta) : "memory");
  return old + delta;
}

// first[0] + rest[0] + rest[stride] + ... + rest[(n - 1) * stride], added
// one at a time in that order, read from L2 with kBatch loads in flight
// (the first beside the first batch).
template <int kBatch = 16>
__device__ __forceinline__ float ordered_sum(const float* first,
                                             const float* rest,
                                             int64_t stride, int64_t n) {
  float acc = __ldcg(first);
  for (int64_t k0 = 0; k0 < n; k0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      v[j] = k0 + j < n ? __ldcg(rest + (k0 + j) * stride) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (k0 + j < n) acc += v[j];
    }
  }
  return acc;
}

}  // namespace fixed_order

// tokenize_boundaries: the per-byte start and end masks of libsvm tokens
// over a chunk of n bytes. A byte is a separator when it is a space, a tab,
// ':', '\n' or '\r';
//   starts[i] = !sep(a[i]) && sep(a[i - 1]),
//   ends[i]   = !sep(a[i]) && sep(a[i + 1]),
// where the byte before a[0] and the byte after a[n - 1] count as
// separators. Outputs are bool bytes (0 or 1), as torch.bool stores them.
//
// Replaces dmlc_tpu/ops/pallas_kernels.py, tokenize_boundaries /
// _tokenize_call / _tokenize_kernel (the Pallas TPU kernel, which read
// host-made prev/cur/next copies of the chunk padded with 0x20 to 256 x 128
// byte tiles).
//
// What bounds it on an H100: memory. It reads n bytes and writes 2n: an
// 8 MiB InputSplit chunk is 25.2 MB, 7.5 us at 3.35 TB/s. The five compares
// a byte are nothing beside that.
//
// Design: one thread per 16-byte group. Groups are aligned to the input's
// address, so a whole group is one 16-byte load; the two neighbour bytes
// come from two 1-byte loads (L1/L2 hits: the neighbouring threads read
// those lines). The separator flags of the 16 bytes are a 16-bit mask in a
// register; shifted by one either way, with the neighbours' flags shifted
// in, it gives both masks at once, written back as two 16-byte stores when
// the outputs share the input's alignment (the wrapper allocates them so).
// The first and the last group may be partial (any n, any base address):
// their threads work one byte at a time. No host-made neighbour copies and
// no padding: the chunk is read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kGroup = 16;

__device__ __forceinline__ uint32_t is_sep(uint32_t c) {
  return static_cast<uint32_t>(c == 0x20u || c == 0x09u || c == 0x3Au ||
                               c == 0x0Au || c == 0x0Du);
}

// Separator flag of a[i]; positions outside [0, n) are separators.
__device__ __forceinline__ uint32_t sep_at(const uint8_t* __restrict__ a,
                                           int64_t n, int64_t i) {
  return (i < 0 || i >= n) ? 1u : is_sep(a[i]);
}

// Bits 0..3 of `bits` as the four bytes (0 or 1) of a little-endian word.
__device__ __forceinline__ uint32_t spread4(uint32_t bits) {
  return (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14) |
         ((bits & 8u) << 21);
}

__global__ void __launch_bounds__(kThreads)
tokenize_kernel(const uint8_t* __restrict__ a, int64_t n, int64_t shift,
                bool vector_store, uint8_t* __restrict__ starts,
                uint8_t* __restrict__ ends) {
  const int64_t group =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // this group covers input positions [lo, lo + 16); shift is a's
  // misalignment, so a + lo is 16-byte aligned for every lo >= 0
  const int64_t lo = group * kGroup - shift;
  if (lo >= n) return;
  if (lo < 0 || lo + kGroup > n) {
    // a partial group at either end of the chunk: byte by byte
    const int64_t hi = lo + kGroup < n ? lo + kGroup : n;
    for (int64_t i = lo < 0 ? 0 : lo; i < hi; ++i) {
      const uint32_t tok = 1u - sep_at(a, n, i);  // 1 = inside a token
      starts[i] = static_cast<uint8_t>(tok & sep_at(a, n, i - 1));
      ends[i] = static_cast<uint8_t>(tok & sep_at(a, n, i + 1));
    }
    return;
  }
  const uint4 v = *reinterpret_cast<const uint4*>(a + lo);
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t sep = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    sep |= is_sep((words[k >> 2] >> (8 * (k & 3))) & 0xFFu) << k;
  }
  const uint32_t tok = ~sep & 0xFFFFu;
  const uint32_t prev_sep = (sep << 1) | sep_at(a, n, lo - 1);
  const uint32_t next_sep = (sep >> 1) | (sep_at(a, n, lo + kGroup) << 15);
  const uint32_t s = tok & prev_sep;
  const uint32_t e = tok & next_sep;
  if (vector_store) {
    *reinterpret_cast<uint4*>(starts + lo) = make_uint4(
        spread4(s), spread4(s >> 4), spread4(s >> 8), spread4(s >> 12));
    *reinterpret_cast<uint4*>(ends + lo) = make_uint4(
        spread4(e), spread4(e >> 4), spread4(e >> 8), spread4(e >> 12));
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      starts[lo + k] = static_cast<uint8_t>((s >> k) & 1u);
      ends[lo + k] = static_cast<uint8_t>((e >> k) & 1u);
    }
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
extern "C" int dmlc_tokenize_boundaries(const uint8_t* a, int64_t n,
                                        uint8_t* starts, uint8_t* ends,
                                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t shift = static_cast<int64_t>(reinterpret_cast<uintptr_t>(a) &
                                             (kGroup - 1));
  const bool vector_store =
      (reinterpret_cast<uintptr_t>(starts) & (kGroup - 1)) ==
          static_cast<uintptr_t>(shift) &&
      (reinterpret_cast<uintptr_t>(ends) & (kGroup - 1)) ==
          static_cast<uintptr_t>(shift);
  const int64_t groups = (n + shift + kGroup - 1) / kGroup;
  const int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  tokenize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      a, n, shift, vector_store, starts, ends);
  return static_cast<int>(cudaGetLastError());
}

// Hopper (sm_90a) building blocks of flash_attention_fwd.cu and
// flash_attention_bwd.cu: warpgroup products (wgmma) on TF32 operands, TMA
// and bulk copies into shared memory tracked by mbarriers, the tensor maps
// the copies read through, named barriers, and the integer flags of a
// fixed-order sum across CTAs.
//
// wgmma.mma_async m64nNk8 .f32.tf32.tf32 takes both operands K-major (the
// transpose bits exist only for 16-bit types). A comes from registers, four
// .b32 a thread, in mma.sync's m16n8k8 A layout for each warp's 16 rows
// (warp w of the warpgroup owns rows 16w .. 16w+15; gid = lane >> 2,
// tig = lane & 3): a0 (gid, tig), a1 (gid+8, tig), a2 (gid, tig+4),
// a3 (gid+8, tig+4). The accumulator of an N-column product is N/2 floats a
// thread, c[4j + i] for each 8-column block j in mma.sync's C layout:
// (gid, 8j+2tig), (gid, 8j+2tig+1), (gid+8, 8j+2tig), (gid+8, 8j+2tig+1).
// B comes from shared memory through a descriptor, in the no-swizzle
// canonical layout: a tile of R rows (N) by K columns (K a multiple of 8) is
// made of 8-row x 4-column core matrices of 128 contiguous bytes, the K-wise
// neighbours of one 8-row group next to each other; element (r, c) is at
// canon(r, c, K). The descriptor's leading byte offset is then 128 (the next
// core matrix along K) and its stride byte offset K/4 x 128 (the next
// 8-row group); one k-step of 8 columns is 256 bytes further on.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the
                   // driver at run time)
#include <cuda_runtime.h>
#include <stdint.h>

namespace dmlc_flash_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// float offset of element (r, c) of a canonical tile with K columns
__device__ __forceinline__ int canon(int r, int c, int K) {
  return (((r >> 3) * (K >> 2) + (c >> 2)) << 5) + ((r & 7) << 2) + (c & 3);
}

// the descriptor of a canonical tile with K columns whose row 0, column 0
// is at `tile`; + 16 moves it one k-step (256 bytes) along K
__device__ __forceinline__ uint64_t canon_desc(const float* tile, int K) {
  const uint64_t lbo = 128 >> 4;
  const uint64_t sbo = static_cast<uint64_t>(K >> 2) * 128 >> 4;
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (lbo << 16) | (sbo << 32);
}
constexpr uint64_t kDescKStep = 256 >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keeps the compiler from touching an accumulator across a wgmma in flight
template <int M>
__device__ __forceinline__ void fence_operands(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A · B^T for one k-step of 8: A a thread's four registers, B the
// descriptor; accumulate = 0 starts d from zero.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// An m64n32k8 product whose B descriptor is moved by a compile-time offset
// in its 16-byte units inside the instruction's own registers: a k-step
// loop then keeps one descriptor of each tile live, not one a k-step. A
// from registers, a0..a3 as in wgmma_tf32.
template <int kOffB>
__device__ __forceinline__ void wgmma_n32_rs(float (&d)[16], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "add.s64 db, %20, %22;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, db, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate),
        "n"(kOffB));
}

// keeps the compiler from reusing the registers of an A operand that a
// wgmma in flight may still read: call it after the wait that ends it
template <int M>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
template <int S, int M>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[S][M]) {
#pragma unroll
  for (int s = 0; s < S; ++s) fence_operands(a[s]);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A · B^T over KS k-steps as three TF32 products a k-step, the small
// terms first (A_small·B_big, A_big·B_small, A_big·B_big), all summed on the
// tensor cores: 3·KS wgmma, issued and not waited for (the caller commits
// and waits). bb and bs describe B's big and small tiles at k-step 0.
template <int N, int KS>
__device__ __forceinline__ void mma3(float (&d)[N / 2],
                                     const uint32_t (&ab)[KS][4],
                                     const uint32_t (&as)[KS][4],
                                     uint64_t bb, uint64_t bs,
                                     bool accumulate) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const uint64_t step = kDescKStep * s;
    wgmma_tf32<N>(d, as[s], bb + step, (accumulate || s > 0) ? 1 : 0);
    wgmma_tf32<N>(d, ab[s], bs + step, 1);
    wgmma_tf32<N>(d, ab[s], bb + step, 1);
  }
}

// ---- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also adds `bytes` to the transactions the current phase
// waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes)
      : "memory");
}

// adds `bytes` to the transactions the current phase waits for (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// one arrival (release: this thread's earlier shared-memory writes are
// visible to the threads its phase releases)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_timer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// a wait that cannot hang the card: after this long the kernel traps (an
// error at the next synchronize) instead of spinning on
constexpr uint64_t kWaitLimitNs = 20ull * 1000 * 1000 * 1000;

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0) t0 = global_timer_ns();
    if ((i & 1023) == 1023 && global_timer_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing that many transactions on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing its bytes on `bar`; rows past the tensor's end arrive
// as zeros
__device__ __forceinline__ void tma_load_4d(float* dst, const void* tmap,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// float offset of element (r, c) of a [rows][32] f32 box written by TMA
// with the 128-byte swizzle: the 16-byte chunk c / 4 of row r sits at chunk
// (c / 4) ^ (r % 8), so eight rows' same chunk fall in eight bank groups
__device__ __forceinline__ int swizzled(int r, int c) {
  return (r << 5) + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// element (r, c) of a [rows][D] tile held as D / 32 such boxes, one after
// the other (box_map's boxes of one tile)
__device__ __forceinline__ int boxed(int rows, int r, int c) {
  return (c >> 5) * rows * 32 + swizzled(r, c & 31);
}

// shared-memory writes by this thread become visible to the async proxy
// (wgmma's operand reads) after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- named barriers (0 is __syncthreads) -----------------------------------

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// counts this warp's threads toward barrier `id` without waiting on it
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- integer flags across CTAs ---------------------------------------------

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// orders this thread's (and, through a barrier, its CTA's) earlier memory
// operations before its later ones at gpu scope: after a relaxed read that
// saw a released flag it acquires, before a relaxed write it releases
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// waits until *p == want with relaxed reads (one thread; fence_gpu and a
// barrier then order the others' reads after it)
__device__ __forceinline__ void wait_flag(const int* p, int want) {
  const uint64_t t0 = global_timer_ns();
  while (ld_relaxed(p) != want) {
    __nanosleep(64);
    if (global_timer_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// *p += 1, after fence_gpu: a release of every write ordered before it
__device__ __forceinline__ void add_relaxed(int* p) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

// ---- tensor maps (host) ----------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, T, heads, D] f32 as a 4-d map (d, head, t, b) of [rows][32] boxes with
// the 128-byte swizzle; rows past T read as zeros
inline bool box_map(CUtensorMap* map, const float* x, int B, int T,
                    int heads, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 4, static_cast<cuuint64_t>(heads) * D * 4,
      static_cast<cuuint64_t>(T) * heads * D * 4};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<float*>(x), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace dmlc_flash_hopper

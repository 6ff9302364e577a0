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
// Design (flash_hopper.cuh for the instructions): one CTA per (128-row Q
// tile, b, h), the heaviest causal Q tiles first and all heads of one Q
// tile side by side; two warpgroups of 64 query rows each, 256 threads.
// - Every product runs on wgmma m64n32k8 TF32 with the 3-pass split (small
//   terms first). S = Q K^T: A = Q, B = K as [key][d]. O += P V: A = P,
//   split in registers straight from S's accumulators, B = V^T as
//   [d][key]. TF32 wgmma reads B K-major only, so V is transposed on its
//   way into shared memory, its keys permuted within each 8 (slot tig holds
//   key 2tig, slot tig + 4 key 2tig + 1) as the accumulator layout leaves
//   P's columns. No mma.sync is left.
// - Q: each thread's A fragments (four floats a k-step) are written raw to
//   its own 16-byte slots in shared memory when the CTA starts and split
//   as each part of S needs them. Held split in registers they would take
//   128 a thread at D = 128 beside O's 64, and the kernel spilled.
// - K and V stream in 32-key tiles by TMA (4-d tensor maps over
//   [B, T, Hkv, D], [32 keys][32 floats] boxes with the 128-byte swizzle,
//   rows past T as zeros) into a ring of two raw slots, one for K and one
//   for V, tracked by mbarriers. Warpgroup 0 splits every K tile, 1 every
//   V tile, into big and small TF32 parts in the canonical layouts: two K
//   stages and two V^T stages, handed over by mbarriers (full: the
//   splitting warpgroup; empty: both, a K stage once S has read it, a V
//   stage once the P V parts have). Thread 0 of the splitter issues the
//   slot's next copy as soon as its split has read it, so each copy has two
//   turns to land. The key loop holds no __syncthreads.
// - The warpgroups take turns on the tensor cores (named barriers
//   kBarTurn + c): turn i issues the P V of tile i - 1 and then S of tile
//   i, 12 wgmma a part, and passes the turn on once its last part is
//   issued. The softmax of tile i (scale, masks, running max and sum by
//   quad shuffles, 2^x, the split of P) and the split of tile i + 1 then
//   run under the other warpgroup's products.
// - Tensor-core sums stay short (a tensor-core accumulation rounds toward
//   zero): S sums 32 head-dim columns (12 wgmma) before an f32 add, a P V
//   part one 32-key tile for 32 output columns, added to the rescaled O in
//   f32. Each part goes to an accumulator of its own, the next issued
//   before the previous is waited for, so the tensor cores always hold the
//   next one.
// - Shared memory at D = 128: the two raw slots (32 KB), Q's fragments for
//   128 rows (64 KB), two K stages and two V^T stages of big + small parts
//   (128 KB): 224 KB, one CTA an SM; registers ~240 a thread, no spills.
//   Shared-memory traffic (B operands, Q fragments, splits, copies) is of
//   the order of its bandwidth over the tensor cores' time: it, the
//   softmax and the splits pace the kernel as much as the products do.
// - A CTA's keys end at its last row when causal. Every turn of the key
//   loop is the same for both warpgroups (the first and the last are
//   peeled): warpgroup 0 also multiplies the CTA's last two tiles, wholly
//   above its diagonal, with every score masked (P is 0 there), which costs
//   ~1 % and keeps one path in the loop. A row's max is finite from the
//   first tile on (key 0 is visible to every query), so 2^(-inf - m) is 0,
//   never NaN. No atomics: the same inputs give the same bits on every
//   run. A wait that lasts 20 s traps.

#include <type_traits>
#include <utility>

#include "flash_attention.cuh"
#include "flash_hopper.cuh"
#include "flash_mma.cuh"

namespace {

using dmlc_flash::softmax_scale;
using dmlc_flash::valid_shape;
using dmlc_flash_mma::split;
using namespace dmlc_flash_hopper;

constexpr int kQRows = 128;  // query rows of a CTA, 64 a warpgroup
constexpr int kKvRows = 32;  // keys of a streamed K/V tile
constexpr int kChunk = 32;   // head-dim columns of one tensor-core sum of S
constexpr int kPvCols = 32;  // output columns of one P V part
constexpr int kFwdThreads = 256;  // two warpgroups

constexpr int kSRegs = kKvRows / 2;   // a thread's floats of 64 x 32 scores
constexpr int kORegs = kPvCols / 2;   // ... of a 64 x 32 P V part
static_assert(kPvCols == 32 && kChunk == 32, "parts are m64n32k8 products");
constexpr int kKSteps = kKvRows / 8;  // k-steps of P V over a tile
constexpr int kQSteps = kChunk / 8;   // k-steps of one part of S

// named barriers (0 is __syncthreads)
constexpr int kBarTurn = 1;   // + c: warpgroup c's turn on the tensor cores
constexpr int kBarSplit = 3;  // + c: warpgroup c has read its raw slot

// mbarriers, two of each (raw: slot 0 K, slot 1 V; the rest: tile i's
// stage, i % 2)
constexpr int kRawFull = 0;
constexpr int kKFull = 2;
constexpr int kKEmpty = 4;
constexpr int kVFull = 6;
constexpr int kVEmpty = 8;
constexpr int kBars = 10;

// Shared memory in floats from a 1024-byte aligned base, then the
// mbarriers. A stage holds a tile's big parts, then its small parts.
template <int D>
struct Layout {
  static constexpr int kTile = kKvRows * D;     // floats of a K or V tile
  static constexpr int kRaw = 0;                // raw K slot, raw V slot
  static constexpr int kQ = kRaw + 2 * kTile;   // Q, each thread's fragments
  static constexpr int kK = kQ + kQRows * D;    // K stages, [key][d]
  static constexpr int kV = kK + 4 * kTile;     // V^T stages, [d][key]
  static constexpr int kFloats = kV + 4 * kTile;
  static constexpr int kBytes = 4 * kFloats + 8 * kBars;
  static_assert(kTile % 256 == 0, "TMA boxes 1024-byte aligned");
};

// The raw K slot's tile (D / 32 swizzled boxes) into its canonical big and
// small parts [key][d]: eight threads read one 16-byte chunk of eight
// rows (the swizzle puts them in eight bank groups) and write 128
// contiguous bytes.
template <int D>
__device__ __forceinline__ void split_k(const float* raw, float* kb,
                                        float* ks, int wt) {
#pragma unroll
  for (int it = 0; it < kKvRows * D / 4 / 128; ++it) {
    const int f = wt + 128 * it;
    const int r = 8 * ((f >> 3) / (D / 4)) + (f & 7);
    const int c = 4 * ((f >> 3) % (D / 4));
    const float4 x =
        *reinterpret_cast<const float4*>(raw + boxed(kKvRows, r, c));
    uint4 big, small;
    split(x.x, big.x, small.x);
    split(x.y, big.y, small.y);
    split(x.z, big.z, small.z);
    split(x.w, big.w, small.w);
    const int at = canon(r, c, D);
    *reinterpret_cast<uint4*>(kb + at) = big;
    *reinterpret_cast<uint4*>(ks + at) = small;
  }
}

// The raw V slot's tile into the canonical big and small parts of V^T
// [d][slot], where slot 4g + j (j < 4) of each 8 holds key 8(g / 2) +
// 2j + g % 2: a warp reads one row's 32 columns (a swizzled box row, 32
// banks) for four keys and writes four slots of 32 rows.
template <int D>
__device__ __forceinline__ void split_v(const float* raw, float* vb,
                                        float* vs, int wt) {
#pragma unroll
  for (int it = 0; it < D * kKvRows / 4 / 128; ++it) {
    const int f = wt + 128 * it;
    const int d = (f & 31) + 32 * ((f >> 5) % (D / 32));
    const int g = (f >> 5) / (D / 32);
    const int key = 8 * (g >> 1) + (g & 1);
    uint4 big, small;
    split(raw[boxed(kKvRows, key, d)], big.x, small.x);
    split(raw[boxed(kKvRows, key + 2, d)], big.y, small.y);
    split(raw[boxed(kKvRows, key + 4, d)], big.z, small.z);
    split(raw[boxed(kKvRows, key + 6, d)], big.w, small.w);
    const int at = canon(d, 4 * g, kKvRows);
    *reinterpret_cast<uint4*>(vb + at) = big;
    *reinterpret_cast<uint4*>(vs + at) = small;
  }
}

// The split duty of warpgroup kWhich (0: K, 1: V) for tile j. run() waits
// for the raw tile (thread 0 of the warpgroup issues tile 0's copy when the
// CTA starts, issue(0)) and for the stage's previous tile (j - 2) to be
// released, splits the tile into the stage, hands the raw slot to tile
// j + 1's copy and the stage to both warpgroups.
template <int D, int kWhich>
struct SplitDuty {
  using L = Layout<D>;
  static_assert(kKvRows * D / 4 % 128 == 0, "whole rounds of splits");
  float* sm;
  uint64_t* bar;
  const CUtensorMap* map;
  int j, num_n, b, hk, wt;

  // thread 0: tile t into the raw slot
  __device__ __forceinline__ void issue(int t) const {
    float* raw = sm + L::kRaw + kWhich * L::kTile;
    uint64_t* full = bar + kRawFull + kWhich;
    mbar_arrive_expect_tx(full, L::kTile * 4);
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      tma_load_4d(raw + c * kKvRows * 32, map, 32 * c, hk, t * kKvRows, b,
                  full);
    }
  }
  __device__ __forceinline__ void run() const {
    const float* raw = sm + L::kRaw + kWhich * L::kTile;
    float* stage =
        sm + (kWhich == 0 ? L::kK : L::kV) + (j & 1) * 2 * L::kTile;
    mbar_wait(bar + kRawFull + kWhich, j & 1);
    if (j >= 2) {
      mbar_wait(bar + (kWhich == 0 ? kKEmpty : kVEmpty) + (j & 1),
                ((j >> 1) - 1) & 1);
    }
    if constexpr (kWhich == 0) {
      split_k<D>(raw, stage, stage + L::kTile, wt);
    } else {
      split_v<D>(raw, stage, stage + L::kTile, wt);
    }
    fence_proxy_async();
    bar_sync(kBarSplit + kWhich, 128);  // the raw slot is read
    if (wt == 0 && j + 1 < num_n) issue(j + 1);
    mbar_arrive(bar + (kWhich == 0 ? kKFull : kVFull) + (j & 1));
  }
};

// descriptor units (16 bytes) from one 32-row part of a V^T stage to the
// next
constexpr int kVPartUnits = (kPvCols / 8) * (kKvRows / 4) * 128 / 16;

// Q's A fragments for the k-steps of part P of S, split: the thread's four
// raw values of each k-step (one 16-byte load from its own slots, written
// when the CTA starts) into big and small TF32 parts
template <int P>
__device__ __forceinline__ void load_q(uint32_t (&qf)[2][kQSteps][4],
                                       const uint4* q_frag) {
#pragma unroll
  for (int s = 0; s < kQSteps; ++s) {
    const uint4 x = q_frag[(kQSteps * P + s) * 128];
    split(__uint_as_float(x.x), qf[0][s][0], qf[1][s][0]);
    split(__uint_as_float(x.y), qf[0][s][1], qf[1][s][1]);
    split(__uint_as_float(x.z), qf[0][s][2], qf[1][s][2]);
    split(__uint_as_float(x.w), qf[0][s][3], qf[1][s][3]);
  }
}

// k-step St of S (head-dim columns 8St .. 8St + 7; s = St % 4 in the part):
// Qs·Kb, Qb·Ks, Qb·Kb, small terms first; the first k-step of a part
// starts its sum
template <int St>
__device__ __forceinline__ void s_step(float (&d)[kSRegs],
                                       const uint32_t (&qf)[2][kQSteps][4],
                                       uint64_t dkb, uint64_t dks) {
  constexpr int kOff = 16 * St;
  constexpr int s = St % kQSteps;
  const uint32_t(&b)[4] = qf[0][s];
  const uint32_t(&t)[4] = qf[1][s];
  wgmma_n32_rs<kOff>(d, t[0], t[1], t[2], t[3], dkb, s == 0 ? 0 : 1);
  wgmma_n32_rs<kOff>(d, b[0], b[1], b[2], b[3], dks, 1);
  wgmma_n32_rs<kOff>(d, b[0], b[1], b[2], b[3], dkb, 1);
}

// part P of S: head-dim columns 32P .. 32P + 31, 12 wgmma
template <int P, int... S>
__device__ __forceinline__ void s_part(std::integer_sequence<int, S...>,
                                       float (&d)[kSRegs],
                                       const uint32_t (&qf)[2][kQSteps][4],
                                       uint64_t dkb, uint64_t dks) {
  wgmma_fence();
  (s_step<kQSteps * P + S>(d, qf, dkb, dks), ...);
}

// k-step S (keys 8S .. 8S + 7) of part P of P V: Ps·Vb, Pb·Vs, Pb·Vb; P's
// big parts in pp[0], small in pp[1], four a k-step
template <int P, int S>
__device__ __forceinline__ void pv_step(float (&d)[kORegs],
                                        const uint32_t (&pp)[2][kSRegs],
                                        uint64_t dvb, uint64_t dvs) {
  constexpr int kOff = kVPartUnits * P + 16 * S;
  constexpr int a = 4 * S;
  const uint32_t* b = pp[0];
  const uint32_t* t = pp[1];
  wgmma_n32_rs<kOff>(d, t[a], t[a + 1], t[a + 2], t[a + 3], dvb,
                     S == 0 ? 0 : 1);
  wgmma_n32_rs<kOff>(d, b[a], b[a + 1], b[a + 2], b[a + 3], dvs, 1);
  wgmma_n32_rs<kOff>(d, b[a], b[a + 1], b[a + 2], b[a + 3], dvb, 1);
}

// part P of P V: output columns 32P .. 32P + 31 over the tile, 12 wgmma
template <int P, int... S>
__device__ __forceinline__ void pv_part(std::integer_sequence<int, S...>,
                                        float (&d)[kORegs],
                                        const uint32_t (&pp)[2][kSRegs],
                                        uint64_t dvb, uint64_t dvs) {
  wgmma_fence();
  (pv_step<P, S>(d, pp, dvb, dvs), ...);
}

// Step J of a turn (see gemm_turn): issue part J, then wait for part J - 1,
// add it in f32, and load Q's fragments for the next part of S. P V parts
// alternate between pvb[0] and pvb[1]; S's first part goes straight into
// sacc and its others alternate between sb[0] and sb[1]; part c of S reads
// Q's fragments from qf[c % 2]. The part issued is never one in flight.
template <int D, bool kPV, bool kS, int J>
__device__ __forceinline__ void turn_step(
    float (&pvb)[2][kORegs], float (&sb)[2][kSRegs],
    uint32_t (&qf)[2][2][kQSteps][4], float (&o)[D / kPvCols][kORegs],
    float (&sacc)[kSRegs], uint32_t (&pp)[2][kSRegs], const uint4* q_frag,
    uint64_t dkb, uint64_t dks, uint64_t dvb, uint64_t dvs,
    const float (&corr)[2], int pass, uint64_t* v_free) {
  constexpr int kPVParts = kPV ? D / kPvCols : 0;
  constexpr int kSParts = kS ? D / kChunk : 0;
  constexpr int kParts = kPVParts + kSParts;
  constexpr auto kSeq = std::make_integer_sequence<int, kQSteps>();
  if constexpr (J < kParts) {
    constexpr int c = J - kPVParts;  // the part of S, if it is one
    if constexpr (J < kPVParts) {
      pv_part<J>(std::make_integer_sequence<int, kKSteps>(), pvb[J & 1], pp,
                 dvb, dvs);
    } else if constexpr (c == 0) {
      s_part<0>(kSeq, sacc, qf[0], dkb, dks);
    } else {
      s_part<c>(kSeq, sb[(c - 1) & 1], qf[c & 1], dkb, dks);
    }
    wgmma_commit();
    if (J == kParts - 1 && pass >= 0) bar_arrive(pass, 256);
  }
  if constexpr (J > 0) {
    if constexpr (J < kParts) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    constexpr int kDone = J - 1;
    constexpr int c = kDone - kPVParts;
    if constexpr (kDone < kPVParts) {
      float(&d)[kORegs] = pvb[kDone & 1];
      fence_operands(d);
#pragma unroll
      for (int x = 0; x < kORegs; ++x) {
        o[kDone][x] = o[kDone][x] * corr[(x >> 1) & 1] + d[x];
      }
      if constexpr (kDone == kPVParts - 1) {  // P and V are read no more
        fence_operands(pp[0]);
        fence_operands(pp[1]);
        mbar_arrive(v_free);
      }
    } else {
      fence_operands(qf[c & 1][0]);  // this part's Q fragments are read no more
      fence_operands(qf[c & 1][1]);
      if constexpr (c == 0) {
        fence_operands(sacc);
      } else {
        float(&d)[kSRegs] = sb[(c - 1) & 1];
        fence_operands(d);
#pragma unroll
        for (int x = 0; x < kSRegs; ++x) sacc[x] += d[x];
      }
    }
  }
  // part J + 1 of the turn, if it is S's part c1 > 0, reads qf[c1 % 2]: part
  // c1 - 2, its last reader, is done
  constexpr int c1 = J + 1 - kPVParts;
  if constexpr (J + 1 < kParts && c1 > 0) {
    load_q<c1>(qf[c1 & 1], q_frag);
  }
}

template <int D, bool kPV, bool kS, int... J>
__device__ __forceinline__ void turn_steps(
    std::integer_sequence<int, J...>, float (&o)[D / kPvCols][kORegs],
    float (&sacc)[kSRegs], uint32_t (&pp)[2][kSRegs], const uint4* q_frag,
    uint64_t dkb, uint64_t dks, uint64_t dvb, uint64_t dvs,
    const float (&corr)[2], int pass, uint64_t* v_free) {
  float pvb[2][kORegs];
  float sb[2][kSRegs];
  uint32_t qf[2][2][kQSteps][4];
  if constexpr (kS) load_q<0>(qf[0], q_frag);
  (turn_step<D, kPV, kS, J>(pvb, sb, qf, o, sacc, pp, q_frag, dkb, dks, dvb,
                            dvs, corr, pass, v_free),
   ...);
}

// One turn of a warpgroup on the tensor cores: the P V of the previous tile
// (kPV: D / 32 parts of 32 output columns, each added to the rescaled O),
// then S of this tile (kS: D / 32 parts of 32 head-dim columns, summed in
// f32 into sacc). Each part is 12 wgmma into an accumulator of its own;
// part j + 1 is issued before part j is waited for and added. Once the
// last part is issued the turn passes to the other warpgroup (`pass`; -1:
// none); once the P V parts are done the V stage is released (v_free).
template <int D, bool kPV, bool kS>
__device__ __forceinline__ void gemm_turn(
    float (&o)[D / kPvCols][kORegs], float (&sacc)[kSRegs],
    uint32_t (&pp)[2][kSRegs], const uint4* q_frag, const float* kst,
    const float* vst, const float (&corr)[2], int pass, uint64_t* v_free) {
  using L = Layout<D>;
  constexpr int kParts = (kPV ? D / kPvCols : 0) + (kS ? D / kChunk : 0);
  turn_steps<D, kPV, kS>(std::make_integer_sequence<int, kParts + 1>(), o,
                         sacc, pp, q_frag, canon_desc(kst, D),
                         canon_desc(kst + L::kTile, D),
                         canon_desc(vst, kKvRows),
                         canon_desc(vst + L::kTile, kKvRows), corr, pass,
                         v_free);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x in one MUFU op (relative error ~2^-22); arguments here are at most
// 0, and results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The softmax of the tile at key n0 for the thread's rows row0 and
// row0 + 8 (the warp's first row rw), in base 2: scale the scores in sacc
// by scale2 = log2(e) / sqrt(D) and mask them, update the running max m_r
// and sum share l_r, set the rescale corr of O, and split
// P = 2^(s - m) into the A operand of the next P V (k-slot tig of each 8
// keys is key 2tig, k-slot tig + 4 key 2tig + 1).
template <bool kCausal>
__device__ __forceinline__ void softmax_tile(
    float (&sacc)[kSRegs], float (&m_r)[2], float (&l_r)[2],
    float (&corr)[2], uint32_t (&pp)[2][kSRegs], int n0, int rw, int row0,
    int tig, int T, float scale2) {
  const bool edge = (kCausal && n0 + kKvRows - 1 > rw) || n0 + kKvRows > T;
  // the thread's keys are n0 + 2tig + 8(x / 4) + x % 2; each row keeps
  // those up to lim (its own position when causal, T - 1)
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lim[r] = (kCausal ? min(row0 + 8 * r, T - 1) : T - 1) - n0 - 2 * tig;
  }
#pragma unroll
  for (int x = 0; x < kSRegs; ++x) {
    float v = sacc[x] * scale2;
    if (edge && 8 * (x >> 2) + (x & 1) > lim[(x >> 1) & 1]) v = -INFINITY;
    sacc[x] = v;
  }
  // a row's values: x = 4q + 2r + e (q < 4, e < 2) for row r; max and sum
  // as trees, for a short chain
  auto row_tree = [&](int r, auto op) {
    float t[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      t[q] = op(sacc[4 * q + 2 * r], sacc[4 * q + 2 * r + 1]);
    }
    return op(op(t[0], t[1]), op(t[2], t[3]));
  };
  auto fmax2 = [](float a, float b) { return fmaxf(a, b); };
  auto add2 = [](float a, float b) { return a + b; };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_r[r], quad_max(row_tree(r, fmax2)));
    corr[r] = exp2_approx(m_r[r] - m_new);
    m_r[r] = m_new;
  }
#pragma unroll
  for (int x = 0; x < kSRegs; ++x) {
    sacc[x] = exp2_approx(sacc[x] - m_r[(x >> 1) & 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + row_tree(r, add2);
#pragma unroll
  for (int j = 0; j < kKSteps; ++j) {
    split(sacc[4 * j], pp[0][4 * j], pp[1][4 * j]);
    split(sacc[4 * j + 2], pp[0][4 * j + 1], pp[1][4 * j + 1]);
    split(sacc[4 * j + 1], pp[0][4 * j + 2], pp[1][4 * j + 2]);
    split(sacc[4 * j + 3], pp[0][4 * j + 3], pp[1][4 * j + 3]);
  }
}

// Warpgroups 0 and 1: 64 query rows each, over every K/V tile of the CTA.
// Turn 0 forms S of tile 0, turn i (0 < i < num_n) the P V of tile i - 1
// and S of tile i, turn num_n the last P V. After its turn i a warpgroup
// runs the softmax of tile i, then its split duty for tile i + 1 (0: K,
// 1: V), both under the other warpgroup's products; tile 0's splits come
// first. A warpgroup's rows that lie wholly above a tile's causal diagonal
// (the last two tiles of warpgroup 0) are multiplied all the same, with
// every score masked: P is 0 there.
template <int D, bool kCausal>
__device__ __forceinline__ void warpgroup_main(
    float* sm, uint64_t* bar, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const float* __restrict__ q,
    float* __restrict__ o, float* __restrict__ lse, int T, int H, int hk,
    int b, int h, int m0, int num_n, float scale2) {
  using L = Layout<D>;
  constexpr int kParts = D / kPvCols;
  const int cw = static_cast<int>(threadIdx.x) >> 7;  // the warpgroup
  const int wt = static_cast<int>(threadIdx.x) & 127;
  const int w = wt >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rw = m0 + 64 * cw + 16 * w;  // the warp's first row
  const int row0 = rw + gid;             // the thread's rows row0, row0 + 8
  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t q_off = (static_cast<int64_t>(b) * T * H + h) * D;
  // warpgroup kWhich's split duty for tile j
  auto duty = [&](auto which, int j) {
    return SplitDuty<D, decltype(which)::value>{
        sm, bar, which.value == 0 ? tm_k : tm_v, j, num_n, b, hk, wt};
  };
  using K = std::integral_constant<int, 0>;
  using V = std::integral_constant<int, 1>;
  if (wt == 0) {  // tile 0's copy, under Q's loads
    if (cw == 0) {
      duty(K{}, 0).issue(0);
    } else {
      duty(V{}, 0).issue(0);
    }
  }

  // Q's A fragments, raw, in the thread's own 16-byte slots (one a
  // k-step; only this thread reads them, split as each part of S needs
  // them): registers would not hold them beside O
  uint4* q_frag =
      reinterpret_cast<uint4*>(sm + L::kQ) + cw * (D / 8) * 128 + wt;
#pragma unroll 4
  for (int st = 0; st < D / 8; ++st) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i & 1);
      const int c = 8 * st + tig + 4 * (i >> 1);
      x[i] = row < T ? __ldg(q + q_off + row * q_stride + c) : 0.f;
    }
    q_frag[st * 128] = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                                  __float_as_uint(x[2]),
                                  __float_as_uint(x[3]));
  }

  float acc[kParts][kORegs];
#pragma unroll
  for (int p = 0; p < kParts; ++p)
#pragma unroll
    for (int x = 0; x < kORegs; ++x) acc[p][x] = 0.f;
  // the thread's rows: running max, and its own share of the running sum
  // (the quad adds its four shares at the end)
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float corr[2];
  uint32_t pp[2][kSRegs];  // P of the previous tile, big and small

  // this warpgroup's split duty for tile j
  auto split_duty = [&](int j) {
    if (j >= num_n) return;
    if (cw == 0) {
      duty(K{}, j).run();
    } else {
      duty(V{}, j).run();
    }
  };
  const int other = kBarTurn + 1 - cw;
  auto k_stage = [&](int i) { return sm + L::kK + (i & 1) * 2 * L::kTile; };
  auto v_stage = [&](int i) { return sm + L::kV + (i & 1) * 2 * L::kTile; };
  if (cw == 1) bar_arrive(kBarTurn, 256);  // warpgroup 0 takes the first turn
  split_duty(0);
  {
    mbar_wait(bar + kKFull, 0);
    bar_sync(kBarTurn + cw, 256);
    float sacc[kSRegs];
    gemm_turn<D, false, true>(acc, sacc, pp, q_frag, k_stage(0), v_stage(0),
                              corr, other, nullptr);
    mbar_arrive(bar + kKEmpty);
    softmax_tile<kCausal>(sacc, m_r, l_r, corr, pp, 0, rw, row0, tig, T,
                          scale2);
    split_duty(1);
  }
  // turn i: P V of tile i - 1 and S of tile i, then the softmax of tile i
  // and the split of tile i + 1
  for (int i = 1; i < num_n; ++i) {
    const int s = i & 1;
    mbar_wait(bar + kVFull + (s ^ 1), ((i - 1) >> 1) & 1);
    mbar_wait(bar + kKFull + s, (i >> 1) & 1);
    bar_sync(kBarTurn + cw, 256);
    float sacc[kSRegs];
    gemm_turn<D, true, true>(acc, sacc, pp, q_frag, k_stage(i),
                             v_stage(i - 1), corr, other,
                             bar + kVEmpty + (s ^ 1));
    mbar_arrive(bar + kKEmpty + s);
    softmax_tile<kCausal>(sacc, m_r, l_r, corr, pp, i * kKvRows, rw, row0,
                          tig, T, scale2);
    split_duty(i + 1);
  }
  {
    const int last = num_n - 1;
    mbar_wait(bar + kVFull + (last & 1), (last >> 1) & 1);
    bar_sync(kBarTurn + cw, 256);
    float sacc[kSRegs];
    // warpgroup 1's last turn passes to no one
    gemm_turn<D, true, false>(acc, sacc, pp, q_frag, k_stage(last),
                              v_stage(last), corr, cw == 0 ? other : -1,
                              bar + kVEmpty + (last & 1));
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] = quad_sum(l_r[r]);
    inv[r] = 1.f / l_r[r];
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row < T) {
      float* out = o + q_off + row * q_stride + 2 * tig;
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
#pragma unroll
        for (int jb = 0; jb < kPvCols / 8; ++jb) {
          const int x = 4 * jb + 2 * half;
          *reinterpret_cast<float2*>(out + kPvCols * p + 8 * jb) =
              make_float2(acc[p][x] * inv[half], acc[p][x + 1] * inv[half]);
        }
      }
      if (tig == 0) {
        lse[(static_cast<int64_t>(b) * H + h) * T + row] =
            (m_r[half] + log2f(l_r[half])) * 0.6931471805599453f;
      }
    }
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const float* __restrict__ q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 float* __restrict__ o, float* __restrict__ lse, int T,
                 int H, int Hkv, int BH, float scale) {
  using L = Layout<D>;
  // the TMA boxes need a 1024-byte aligned base, which the declaration
  // asks for; a base that is not (no room is left to align it) traps
  extern __shared__ __align__(1024) float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  if ((smem_u32(sm) & 1023) != 0) __trap();
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kFloats);

  // CTA x: Q tile num_m - 1 - x / BH (the longest causal walks first),
  // (b, h) = x % BH
  const int num_m = (T + kQRows - 1) / kQRows;
  const int m0 = (num_m - 1 - static_cast<int>(blockIdx.x) / BH) * kQRows;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H;
  const int h = bh % H;
  const int n_end = kCausal ? min(T, m0 + kQRows) : T;
  const int num_n = (n_end + kKvRows - 1) / kKvRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar + kRawFull + s, 1);
      mbar_init(bar + kKFull + s, 128);
      mbar_init(bar + kVFull + s, 128);
      mbar_init(bar + kKEmpty + s, 256);
      mbar_init(bar + kVEmpty + s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();
  warpgroup_main<D, kCausal>(sm, bar, &tm_k, &tm_v, q, o, lse, T, H,
                             h / (H / Hkv), b, h, m0, num_n,
                             scale * 1.4426950408889634f);
}

template <int D, bool kCausal>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int T, int H, int Hkv, cudaStream_t stream) {
  constexpr int kSmem = Layout<D>::kBytes;
  const int64_t ctas =
      static_cast<int64_t>((T + kQRows - 1) / kQRows) * B * H;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_k, tm_v;
  if (!box_map(&tm_k, k, B, T, Hkv, D, kKvRows) ||
      !box_map(&tm_v, v, B, T, Hkv, D, kKvRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_kernel<D, kCausal>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kFwdThreads, kSmem, stream>>>(
      q, tm_k, tm_v, o, lse, T, H, Hkv, B * H, softmax_scale(D));
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

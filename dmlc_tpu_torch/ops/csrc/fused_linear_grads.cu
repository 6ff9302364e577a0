// fused_linear_grads: the whole dense local step of the linear learner.
//
// Replaces dmlc_tpu/ops/pallas_kernels.py, fused_linear_grads /
// _fused_step_kernel (the Pallas TPU kernel of the dense layout).
//
// For x [B, F] f32 row-major, label and weight [B], w [F] and a scalar b:
//   margin[r]        = x[r, :] . w + b
//   (loss[r], g[r])  = objective(margin[r], label[r])
//   wg[r]            = weight[r] * g[r]
//   gw = sum_r x[r, :] * wg[r],  gb = sum_r wg[r],
//   loss_sum = sum_r weight[r] * loss[r],  weight_sum = sum_r weight[r]
//
// What bounds it on an H100: a matvec and its transpose, 2 flops per byte
// of x each, far below the card's ratio of compute to bandwidth, so it is
// bound by memory: one read of x plus the [B] vectors, 2.03 MB for a HIGGS
// batch (B = 16384, F = 29), 0.61 us at 3.35 TB/s. At that size the time is
// latency (the launch, one cold read of x, the cross-CTA sum), not bytes.
//
// Design: one launch, one CTA per tile of kTileRows rows (128: the HIGGS
// batch is 128 CTAs, one wave on 132 SMs), x read from device memory once.
//   1. Each warp owns kRowsPerWarp rows. Lane l loads x[r, l + 32c] of its
//      rows for feature chunk c, all rows' loads in flight together, and
//      keeps chunk 0 in registers (wider F is read again, chunk by chunk,
//      in step 3). Its products with w add up per row over the chunks.
//   2. A reduce-scatter butterfly (kRowsPerWarp - 1 shuffles, then one xor
//      step per remaining lane bit) leaves lane l with the margin of row
//      l % kRowsPerWarp; the objective runs there, one row per lane.
//   3. Each lane sums x[r, k] * wg[r] over the warp's rows in row order
//      from the registers of step 1 (wg[r] broadcast from its lane), and
//      the warps' sums add in warp order in shared memory. gb, loss and
//      weight come from a butterfly over the warp's rows, then warp order.
//      The CTA writes one partial row [gw(F), gb, loss_sum, weight_sum].
//   4. The CTA takes a ticket from an arrival counter with one acq_rel
//      atomic increment (release: its row is visible before its ticket;
//      acquire: the CTA with the last ticket then sees every row). That
//      CTA sums all partial rows in tile order (warp j takes tiles j,
//      j + kWarps, ..., kBatch loads in flight, then warp order) into gw
//      and the scalars. The increment wraps the counter back to 0 for the
//      next call on the stream. The sum reads the partial rows from
//      memory, so its bits do not depend on which CTA arrived last.
// No float atomics: the same inputs give the same bits on every run. Any
// rows >= 1 and F >= 1: nothing of size F lives in shared memory or
// registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 16;  // a power of two, at most 32
constexpr int kTileRows = kWarps * kRowsPerWarp;
static_assert(kRowsPerWarp >= 1 && kRowsPerWarp <= 32 &&
                  (kRowsPerWarp & (kRowsPerWarp - 1)) == 0,
              "kRowsPerWarp must be a power of two up to 32");

constexpr unsigned kFull = 0xffffffffu;
// partial rows a thread of the last CTA loads at once
constexpr int kBatch = 16;

// The three objectives of dmlc_tpu_torch/ops/objectives.py, by code:
// 0 logistic (stable softplus), 1 squared, 2 hinge (labels 0/1 -> -1/+1).
__device__ __forceinline__ void objective_loss_grad(int objective, float m,
                                                    float y, float* loss,
                                                    float* grad) {
  if (objective == 0) {
    *loss = fmaxf(m, 0.0f) - m * y + log1pf(expf(-fabsf(m)));
    *grad = 1.0f / (1.0f + expf(-m)) - y;
  } else if (objective == 1) {
    const float d = m - y;
    *loss = 0.5f * d * d;
    *grad = d;
  } else {
    const float s = 2.0f * y - 1.0f;
    const float t = s * m;
    *loss = fmaxf(0.0f, 1.0f - t);
    *grad = (t < 1.0f) ? -s : 0.0f;
  }
}

// x[row, k] of the warp's rows for lane l's feature k = chunk * 32 + l
// (0 past the last row or feature): all loads issued before any is used.
__device__ __forceinline__ void load_chunk(const float* __restrict__ x,
                                           int64_t row, int64_t rows,
                                           int64_t features, int64_t k,
                                           float (&xv)[kRowsPerWarp]) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t r = row + i;
    xv[i] = (r < rows && k < features) ? x[r * features + k] : 0.0f;
  }
}

// One halving step of reduce_scatter: lanes with bit S set keep rows
// [S, 2S) of v[0, 2S) and send rows [0, S) to the lane across bit S, which
// keeps those; v[i] then holds the kept row i (+ S) summed over both.
template <int S>
__device__ __forceinline__ void halve(float (&v)[kRowsPerWarp], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float send = upper ? v[i] : v[i + S];
    const float keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, S);
  }
  if constexpr (S > 1) halve<S / 2>(v, lane);
}

// v[i] of every lane, summed over the warp's 32 lanes: lane l ends with the
// sum for i = l % kRowsPerWarp. The halving steps take kRowsPerWarp - 1
// shuffles; the xor steps after them add lanes that hold the same row,
// where lane a adds v_a + v_b and lane b adds v_b + v_a, so every copy of a
// row's sum has the same bits.
__device__ __forceinline__ float reduce_scatter(float (&v)[kRowsPerWarp],
                                                int lane) {
  if constexpr (kRowsPerWarp > 1) halve<kRowsPerWarp / 2>(v, lane);
  float out = v[0];
#pragma unroll
  for (int off = kRowsPerWarp; off < 32; off <<= 1) {
    out += __shfl_xor_sync(kFull, out, off);
  }
  return out;
}

// v summed over the kRowsPerWarp lanes of each aligned group (a butterfly:
// every lane of a group ends with the same bits).
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kRowsPerWarp / 2; off >= 1; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
fused_linear_grads_kernel(const float* __restrict__ x,
                          const float* __restrict__ label,
                          const float* __restrict__ weight,
                          const float* __restrict__ w,
                          const float* __restrict__ b, int64_t rows,
                          int64_t features, int objective,
                          float* __restrict__ partials,
                          unsigned* __restrict__ counter,
                          float* __restrict__ gw, float* __restrict__ scalars) {
  __shared__ float s_gw[kWarps][32];
  __shared__ float s_sc[kWarps][3];
  __shared__ float s_red[kWarps][32];
  __shared__ unsigned s_ticket;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned num_tiles = gridDim.x;
  const int64_t cols = features + 3;
  const int64_t tile = blockIdx.x;
  const int64_t warp_row = tile * kTileRows + warp * kRowsPerWarp;
  const int64_t nchunks = (features + 31) / 32;

  // this lane's row for the objective, loaded beside x
  const int64_t my_row = warp_row + (lane & (kRowsPerWarp - 1));
  const bool my_valid = my_row < rows;
  const float my_label = my_valid ? label[my_row] : 0.0f;
  const float my_weight = my_valid ? weight[my_row] : 0.0f;
  const float bias = *b;

  // 1. chunk 0 stays in registers; later chunks only add to the dot
  float x0[kRowsPerWarp];
  float dot[kRowsPerWarp];
  load_chunk(x, warp_row, rows, features, lane, x0);
  {
    const float wk = lane < features ? w[lane] : 0.0f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dot[i] = x0[i] * wk;
  }
  for (int64_t c = 1; c < nchunks; ++c) {
    const int64_t k = c * 32 + lane;
    float xv[kRowsPerWarp];
    load_chunk(x, warp_row, rows, features, k, xv);
    const float wk = k < features ? w[k] : 0.0f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dot[i] = fmaf(xv[i], wk, dot[i]);
  }

  // 2. the margin and objective of row lane % kRowsPerWarp
  const float margin = reduce_scatter(dot, lane) + bias;
  float wg = 0.0f, wl = 0.0f;
  if (my_valid) {
    float loss, grad;
    objective_loss_grad(objective, margin, my_label, &loss, &grad);
    wg = my_weight * grad;
    wl = my_weight * loss;
  }
  float wgv[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    wgv[i] = __shfl_sync(kFull, wg, i);
  }
  const float sum_wg = group_sum(wg);
  const float sum_wl = group_sum(wl);
  const float sum_wt = group_sum(my_weight);
  if (lane == 0) {
    s_sc[warp][0] = sum_wg;
    s_sc[warp][1] = sum_wl;
    s_sc[warp][2] = sum_wt;
  }

  // 3. gw of the tile, a chunk of 32 features at a time
  float* out = partials + tile * cols;
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t k = c * 32 + lane;
    float g = 0.0f;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) g = fmaf(x0[i], wgv[i], g);
    } else {
      float xv[kRowsPerWarp];
      load_chunk(x, warp_row, rows, features, k, xv);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) g = fmaf(xv[i], wgv[i], g);
    }
    s_gw[warp][lane] = g;
    __syncthreads();
    if (warp == 0) {
      float t = s_gw[0][lane];
#pragma unroll
      for (int j = 1; j < kWarps; ++j) t += s_gw[j][lane];
      if (k < features) out[k] = t;
      if (c == 0 && lane < 3) {
        float sc = s_sc[0][lane];
#pragma unroll
        for (int j = 1; j < kWarps; ++j) sc += s_sc[j][lane];
        out[features + lane] = sc;
      }
    }
    if (c + 1 < nchunks) __syncthreads();
  }

  // 4. arrive; the last CTA sums the partial rows in tile order
  if (warp == 0) {
    __syncwarp();  // warp 0's stores of the row, before lane 0's release
    if (lane == 0) {
      unsigned ticket;
      asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
                   : "=r"(ticket) : "l"(counter), "r"(num_tiles - 1)
                   : "memory");
      s_ticket = ticket;
    }
  }
  __syncthreads();
  if (s_ticket != num_tiles - 1) return;
  const int tiles = static_cast<int>(num_tiles);
  for (int64_t c0 = 0; c0 < cols; c0 += 32) {
    const int64_t col = c0 + lane;
    float acc = 0.0f;
    for (int t0 = warp; t0 < tiles; t0 += kWarps * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int t = t0 + j * kWarps;
        v[j] = (col < cols && t < tiles) ? __ldcg(partials + t * cols + col)
                                         : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (t0 + j * kWarps < tiles) acc += v[j];
      }
    }
    s_red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && col < cols) {
      float total = s_red[0][lane];
#pragma unroll
      for (int j = 1; j < kWarps; ++j) total += s_red[j][lane];
      if (col < features) {
        gw[col] = total;
      } else {
        scalars[col - features] = total;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the kernel once on `stream`; allocates nothing. `partials` holds
// ceil(rows / tile_rows) * (features + 3) floats, `counter` one unsigned
// int that is 0 before the first call and that no call on another stream
// shares (each call leaves it at 0), `scalars` 3 floats (gb, loss_sum,
// weight_sum). Returns cudaGetLastError() (0 = launched).
extern "C" int dmlc_fused_linear_grads(
    const float* x, const float* label, const float* weight, const float* w,
    const float* b, int64_t rows, int64_t features, int objective,
    int tile_rows, float* partials, unsigned* counter, float* gw,
    float* scalars, void* stream) {
  if (tile_rows != kTileRows || objective < 0 || objective > 2 || rows <= 0 ||
      features <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t num_tiles = (rows + kTileRows - 1) / kTileRows;
  if (num_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_linear_grads_kernel<<<static_cast<unsigned>(num_tiles), kThreads, 0,
                              s>>>(x, label, weight, w, b, rows, features,
                                   objective, partials, counter, gw, scalars);
  return static_cast<int>(cudaGetLastError());
}

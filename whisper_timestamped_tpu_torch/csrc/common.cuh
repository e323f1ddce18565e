// Shared device helpers for the decode and alignment kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wtt {

constexpr int kThreads = 256;  // every kernel here except dtw_codes uses 256 threads
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;   // the only head width the attention kernels take

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions for blockDim.x == nthreads (a multiple of 32, at
// most 1024). ``red`` is shared scratch of at least 32 floats. Every thread
// returns the result; the trailing barrier lets the caller reuse ``red``.
template <int kOp>  // 0 = max, 1 = min, 2 = sum
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float ident = kOp == 0 ? -INFINITY : (kOp == 1 ? INFINITY : 0.f);
  v = kOp == 0 ? warp_max(v) : (kOp == 1 ? warp_min(v) : warp_sum(v));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red[lane] : ident;
    v = kOp == 0 ? warp_max(v) : (kOp == 1 ? warp_min(v) : warp_sum(v));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// 8 bf16 (one 16-byte load) to f32.
__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// Single-query attention of one head over the rows [lo, hi] of a bf16 K/V
// slab (row r at base + r * row_stride elements, head width 64), in f32.
// Scores are q·k·scale; when ``scores`` is given, row r's score lands at
// scores[r]. The softmax weights live in ``p`` (shared, hi - lo + 1 floats).
// Writes the bf16 context vector (64 values) to ``out``. 256 threads.
__device__ __forceinline__ void attend_one_head(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k_base,
                                const __nv_bfloat16* __restrict__ v_base,
                                long row_stride, int lo, int hi, float scale,
                                float* __restrict__ scores,
                                __nv_bfloat16* __restrict__ out, float* p) {
  __shared__ float red[32];
  __shared__ float part[32][kHeadDim];  // per-row-group partial sums of p·V
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int sub = lane >> 3;    // which of the warp's 4 rows
  const int chunk = lane & 7;   // which 8 of the 64 dims

  float qf[8];
  bf16x8_to_f32(*reinterpret_cast<const uint4*>(q + chunk * 8), qf);

  // 1. scores: 8 lanes per row, 16 bytes each, so a warp reads 4 whole rows
  for (int t0 = lo + warp * 4; t0 <= hi; t0 += kWarps * 4) {
    const int t = t0 + sub;
    float s = 0.f;
    if (t <= hi) {
      float kf[8];
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(k_base + t * row_stride + chunk * 8), kf);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += qf[j] * kf[j];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (chunk == 0 && t <= hi) {
      s *= scale;
      p[t - lo] = s;
      if (scores != nullptr) scores[t] = s;
    }
  }
  __syncthreads();

  // 2. softmax over the rows, in shared memory
  const int n = hi - lo + 1;
  float m = -INFINITY;
  for (int r = tid; r < n; r += kThreads) m = fmaxf(m, p[r]);
  m = block_reduce<0>(m, red);
  float l = 0.f;
  for (int r = tid; r < n; r += kThreads) {
    const float e = expf(p[r] - m);
    p[r] = e;
    l += e;
  }
  l = block_reduce<2>(l, red);  // its barriers also publish p

  // 3. out = sum_r p[r] v[r] / l: 32 row groups x 8 lanes of 8 dims
  const int grp = tid >> 3;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int t = lo + grp; t <= hi; t += kThreads / 8) {
    float vf[8];
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(v_base + t * row_stride + chunk * 8), vf);
    const float w = p[t - lo];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += w * vf[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) part[grp][chunk * 8 + j] = acc[j];
  __syncthreads();
  if (tid < kHeadDim) {
    float o = 0.f;
    for (int g = 0; g < kThreads / 8; ++g) o += part[g][tid];
    out[tid] = __float2bfloat16(o / l);
  }
}

}  // namespace wtt

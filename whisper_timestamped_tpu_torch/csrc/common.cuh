// Shared device helpers of the port's kernels (sm_90a): the median-of-9
// network and the block reductions of the alignment and front-end kernels
// (blocks of kThreads), and the bf16 widening of the decode attentions,
// whose pipeline is decode_attn.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wtt {

constexpr int kThreads = 256;  // the block size of the kernels that take it
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 64;   // the only head width the attention kernels take

__device__ __forceinline__ void cx(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// Median of w[0..8] (Paeth's 19-exchange network, the one the TPU kernels
// use): a selection, so it equals the 5th smallest value exactly.
__device__ __forceinline__ float median9(const float* w) {
  float v0 = w[0], v1 = w[1], v2 = w[2], v3 = w[3], v4 = w[4], v5 = w[5],
        v6 = w[6], v7 = w[7], v8 = w[8];
  cx(v1, v2); cx(v4, v5); cx(v7, v8);
  cx(v0, v1); cx(v3, v4); cx(v6, v7);
  cx(v1, v2); cx(v4, v5); cx(v7, v8);
  cx(v0, v3); cx(v5, v8); cx(v4, v7);
  cx(v3, v6); cx(v1, v4); cx(v2, v5);
  cx(v4, v7); cx(v4, v2); cx(v6, v4);
  cx(v4, v2);
  return v4;
}

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

}  // namespace wtt

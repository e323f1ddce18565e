// Shared device helpers for the decode and alignment kernels (sm_90a).
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

// 8 int8 codes (one 8-byte load) to f32, exactly.
__device__ __forceinline__ void s8x8_to_f32(const uint2& u, float* f) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = (float)c[j];
}

// Row sources for attend_one_head, the one-block-per-(head, row) design
// that xattn_decode_int4 and self_attn_decode_int8 still use (the other
// decode attentions run decode_attn.cuh's pipeline). ``load(r, chunk, f)``
// widens the 8 values of row r at the head's columns chunk*8 .. chunk*8+7
// to f32; ``scale(r)`` is row r's dequantization scale, folded into the
// score of a K row and into the softmax weight of a V row.

// int8 rows with one f32 scale per row. Row ``own`` takes ``own_scale``
// instead of scales[own] (a row this launch wrote itself, whose scale
// another block may not have stored yet); own = -1 for none. Read without
// the read-only cache: the kernel writes these rows.
struct Int8Rows {
  const int8_t* base;
  long stride;  // bytes between rows
  const float* scales;
  int own;
  float own_scale;
  __device__ __forceinline__ void load(int r, int chunk, float* f) const {
    s8x8_to_f32(*reinterpret_cast<const uint2*>(base + r * stride + chunk * 8), f);
  }
  __device__ __forceinline__ float scale(int r) const {
    return r == own ? own_scale : scales[r];
  }
};

// int4 frames nibble-packed along T: frame t sits in packed row t/2, in
// the low nibble for even t and the high nibble for odd t (each
// sign-extended); scales are parity-major, the even frames' (T/2 of them)
// before the odd frames'.
struct Int4Rows {
  const int8_t* base;
  long stride;  // bytes between packed rows
  const float* scales;
  int half;     // T / 2
  __device__ __forceinline__ void load(int t, int chunk, float* f) const {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(base + (t >> 1) * stride + chunk * 8));
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
    const int shift = (t & 1) ? 24 : 28;
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (float)((int)((unsigned)c[j] << shift) >> 28);
  }
  __device__ __forceinline__ float scale(int t) const {
    return __ldg(scales + (t & 1) * half + (t >> 1));
  }
};

// Single-query attention of one head over the rows [lo, hi] of a K/V slab,
// head width 64, in f32. Scores are (q·k)·kscale·scale; when ``scores`` is
// given, row r's score lands at scores[r]. The softmax weights live in
// ``p`` (shared, hi - lo + 1 floats); each is multiplied by its V row's
// scale before the V product. Writes the bf16 context vector (64 values) to
// ``out``. 256 threads.
template <class KRows, class VRows>
__device__ __forceinline__ void attend_one_head(const __nv_bfloat16* __restrict__ q,
                                const KRows& krows, const VRows& vrows,
                                int lo, int hi, float scale,
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
      krows.load(t, chunk, kf);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += qf[j] * kf[j];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (chunk == 0 && t <= hi) {
      s = (s * krows.scale(t)) * scale;
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
    vrows.load(t, chunk, vf);
    const float w = p[t - lo] * vrows.scale(t);
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

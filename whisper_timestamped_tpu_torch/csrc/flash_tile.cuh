// The 64 x 64 f32 tile arithmetic of the training flash kernels
// (flash_attn_fwd_lse.cu, flash_attn_bwd.cu): tiles staged in shared memory
// as f32, whatever the inputs' type, and products on the CUDA cores with
// f32 FMAs (no TF32, no bf16 rounding of an intermediate).
//
// A block is 256 threads, 16 x 16: thread (ty, tx) holds the 4 x 4 strided
// micro-tile rows ty + 16 i, columns tx + 16 j of a 64 x 64 result, so a
// row's 16 threads are one half-warp and a row reduction is four shuffles.
// Tiles are stored with a row stride of 65 floats: a walk down a column
// (the transposed operand) then touches 16 banks, a walk along a row is
// consecutive, and the A operand is a two-address broadcast: no bank
// conflicts in any product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wtt {
namespace ftile {

constexpr int kT = 64;                 // rows of a tile, and the head width
constexpr int kLd = kT + 1;            // shared-memory row stride (floats)
constexpr int kTileFloats = kT * kLd;  // one staged tile
constexpr int kBlock = 256;            // threads a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows r0 .. r0 + 63 of head h's 64 columns of one batch row's (S, D)
// matrix into t[r][c] as f32; rows at or past S are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* t, const T* __restrict__ src, int r0, int S,
                                          int D, int h) {
  for (int i = threadIdx.x; i < kT * kT; i += kBlock) {
    const int r = i >> 6, c = i & 63, row = r0 + r;
    t[r * kLd + c] = row < S ? to_f32(src[(long)row * D + h * kT + c]) : 0.f;
  }
}

// acc[i][j] += sum over k < 64 of A[ty + 16 i][k] * B(k, tx + 16 j), where
// B(k, c) is Bm[k][c], or Bm[c][k] with kBT (a product with a transpose).
template <bool kBT>
__device__ __forceinline__ void mma64(float (&acc)[4][4], const float* A, const float* Bm,
                                      int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kT; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * kLd + k];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = kBT ? Bm[(tx + 16 * j) * kLd + k] : Bm[k * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc into t[ty + 16 i][tx + 16 j]
__device__ __forceinline__ void put(float* t, const float (&acc)[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[(ty + 16 * i) * kLd + tx + 16 * j] = acc[i][j];
}

// sum and max over a row's 16 threads (a half-warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc * scale into rows r0 + ty + 16 i (< S) of head h's columns of one
// batch row's (S, D) matrix
template <typename T>
__device__ __forceinline__ void write_tile(T* __restrict__ dst, const float (&acc)[4][4],
                                           float scale, int r0, int S, int D, int h, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row < S) {
#pragma unroll
      for (int j = 0; j < 4; ++j) store(dst + (long)row * D + h * kT + tx + 16 * j, acc[i][j] * scale);
    }
  }
}

// Set every launch's dynamic shared-memory limit (per device, so on every
// call) and check the grid; cudaErrorInvalidValue for what is not taken.
template <typename K>
__host__ inline cudaError_t prepare(K kernel, size_t smem, int B, int S, int D, int H) {
  if (D != H * kT || B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace ftile
}  // namespace wtt

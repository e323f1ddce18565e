// 3xTF32 on tf32 wgmma: the f32 products of the training flash kernels
// (flash_attn_fwd_lse.cu, flash_attn_bwd.cu), so that they cannot drift
// apart.
//
// Each f32 operand x is split into hi = x with its low 13 mantissa bits
// cleared (exactly a tf32) and lo = x - hi (exact in f32), and each product
// is hi·hi + hi·lo + lo·hi on tf32 wgmma (m64nNk8), summed in f32 at three
// tf32 products' cost. The tensor cores add each k-step's sum to the
// accumulator rounded toward zero.
//
// PTX takes tf32 operands in shared memory K-major only, so a tile is kept
// as K-major hi and lo copies with the 128-byte swizzle, a 64-float K range
// as two 32-float halves (``kmajor``). The tf32 register A fragment takes
// columns t and t + 4 of each 8 where the accumulator holds 2t and 2t + 1,
// so the B operand of a register-A product (a transposed copy) stores each
// 8 of its K in the order 0 2 4 6 1 3 5 7 and the fragments take the
// accumulator's registers as they are (``to_frag``).
#pragma once

#include "hopper.cuh"

namespace wtt {
namespace tf32 {

using namespace wtt::hopper;

constexpr int kHead = 64;  // the head width: the K range of S = Q·Kᵀ

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// float offset of (r, c) in a K-major [2][R][32] tile: a 64-float K range
// as two 32-float halves, each 128-byte rows with the 128-byte swizzle
template <int R>
__device__ __forceinline__ int kmajor(int r, int c) {
  return (c >> 5) * R * 32 + r * 32 + ((((c >> 2) & 7) ^ (r & 7)) << 2);
}

// wgmma descriptor of k-step kk (8 floats) of such a tile
template <int R>
__device__ __forceinline__ uint64_t kstep(const float* tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * R * 32) + 2 * (kk & 3);
}

// rows [0, R) of a row-major (R, 64) f32 tile into K-major hi and lo tiles,
// one float4 a thread and step
template <int R>
__device__ __forceinline__ void split_rows(float* hi, float* lo, const float* src, int tid,
                                           int nthreads) {
  for (int i = tid; i < R * 16; i += nthreads) {
    const int r = i >> 4, c = (i & 15) << 2;
    const float4 x = *reinterpret_cast<const float4*>(src + r * kHead + c);
    const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
    *reinterpret_cast<float4*>(hi + kmajor<R>(r, c)) = h;
    *reinterpret_cast<float4*>(lo + kmajor<R>(r, c)) =
        make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
  }
}

// the transpose of a row-major (32, 64) f32 tile into hi and lo tiles
// [64][32] (K-major for a B operand whose K is the tile's 32 rows), each 8
// rows stored in the order 0 2 4 6 1 3 5 7 that the tf32 register A
// fragments take (to_frag)
__device__ __forceinline__ void split_cols(float* hi, float* lo, const float* src, int tid,
                                           int nthreads) {
  for (int i = tid; i < kHead * 8; i += nthreads) {
    const int n = i & 63, c = i >> 6;        // output row n, its 4-float chunk c
    const int q0 = 8 * (c >> 1) + (c & 1);  // source rows q0, q0 + 2, q0 + 4, q0 + 6
    float x[4], h[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      x[m] = src[(q0 + 2 * m) * kHead + n];
      h[m] = tf32_hi(x[m]);
    }
    const int off = n * 32 + ((c ^ (n & 7)) << 2);
    *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + off) =
        make_float4(x[0] - h[0], x[1] - h[1], x[2] - h[2], x[3] - h[3]);
  }
}

// a 64 x N accumulator operand as tf32 hi and lo A fragments, 8 columns a
// k-step
template <int N>
struct Frag {
  uint32_t hi[N / 8][4], lo[N / 8][4];
};

// column group j (8 columns) is k-step j: a[0] / a[2] take the
// accumulator's columns 2t / 2t + 1 of row g, a[1] / a[3] those of g + 8
// (the transposed copies' column order makes that the product's order)
template <int N>
__device__ __forceinline__ void to_frag(const float (&v)[N / 2], Frag<N>& f) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float x[4] = {v[4 * j], v[4 * j + 2], v[4 * j + 1], v[4 * j + 3]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float h = tf32_hi(x[r]);
      f.hi[j][r] = __float_as_uint(h);
      f.lo[j][r] = __float_as_uint(x[r] - h);
    }
  }
}

template <int N>
__device__ __forceinline__ void fence_frag(Frag<N>& f) {
  fence_regs(f.hi);
  fence_regs(f.lo);
}

// d (64 x N) (+)= A·Bᵀ over the head width: A a warpgroup's 64 rows as
// K-major [2][64][32] hi / lo tiles, B N rows as K-major [2][N][32] tiles;
// hi·hi, then hi·lo, then lo·hi, one k-step a wgmma (no commit)
template <int N>
__device__ __forceinline__ void issue_ss3(float (&d)[N / 2], const float* ah, const float* al,
                                          const float* bh, const float* bl) {
#pragma unroll
  for (int kk = 0; kk < kHead / 8; ++kk)
    wgmma_ss_tf32(d, kstep<64>(ah, kk), kstep<N>(bh, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < kHead / 8; ++kk) wgmma_ss_tf32(d, kstep<64>(ah, kk), kstep<N>(bl, kk), 1);
#pragma unroll
  for (int kk = 0; kk < kHead / 8; ++kk) wgmma_ss_tf32(d, kstep<64>(al, kk), kstep<N>(bh, kk), 1);
}

// acc (64 x 64) += F · B, B (N x 64) given as its transpose split into thi /
// tlo, K-major [N / 32][64][32] with split_cols' column order (no commit)
template <int N>
__device__ __forceinline__ void issue_rs3(float (&acc)[32], const Frag<N>& f, const float* thi,
                                          const float* tlo) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_rs_tf32(acc, f.hi[kk], kstep<64>(thi, kk), 1);
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_rs_tf32(acc, f.hi[kk], kstep<64>(tlo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_rs_tf32(acc, f.lo[kk], kstep<64>(thi, kk), 1);
}

}  // namespace tf32
}  // namespace wtt

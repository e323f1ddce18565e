// xattn_decode_int4: single-query cross-attention of one decode step over
// one layer of the stacked int4 encoder K/V (two frames nibble-packed per
// byte along T) with per-frame f32 scales, and optional pre-softmax scores.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:1876
//   cross_attention_stacked_int4_pallas (kernels _xattn_stacked_int4_v2_kernel
//   :1573 and the s8 variant :1725). The same function as xattn_decode_int8
//   over the unpacked codes: frame t lives in packed row t/2, low nibble for
//   even t, high nibble for odd t, sign-extended; the scales are
//   parity-major (frame t's at t/2 for even t, at T/2 + t/2 for odd t).
//   Scores come out in frame order, (B, H, T).
//
// What bounds it on the H100: bytes. A call streams one layer's packed K
// and V, B_kv * T/2 * D bytes each, a quarter of the bf16 kernel's, plus 8
// bytes of scales per frame (large-v3, B=40: 77 MB, 23 us at 3.35 TB/s).
//
// Design: xattn_decode's (common.cuh) with nibble rows: the two frames of
// one packed row are read by neighbouring lane groups of one warp, so each
// packed byte comes from device memory once; the nibbles widen to f32 in
// registers. Rows and scales are read at b / beam_group.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(wtt::kThreads)
xattn_decode_int4_kernel(const __nv_bfloat16* __restrict__ q,  // (B, D)
                         const int8_t* __restrict__ xk,        // (L, B_kv, T/2, D)
                         const float* __restrict__ xk_scale,   // (L, B_kv, T)
                         const int8_t* __restrict__ xv,
                         const float* __restrict__ xv_scale,
                         __nv_bfloat16* __restrict__ out,      // (B, D)
                         float* __restrict__ scores,           // (B, H, T) or null
                         int layer, int b_kv_rows, int T, int D, int H,
                         int beam_group, float scale) {
  extern __shared__ float p[];
  const int h = blockIdx.x, b = blockIdx.y;
  const long slab = (long)layer * b_kv_rows + b / beam_group;
  const long packed = slab * (T / 2) * D + (long)h * wtt::kHeadDim;
  wtt::attend_one_head(q + (long)b * D + h * wtt::kHeadDim,
                       wtt::Int4Rows{xk + packed, D, xk_scale + slab * T, T / 2},
                       wtt::Int4Rows{xv + packed, D, xv_scale + slab * T, T / 2},
                       0, T - 1, scale,
                       scores ? scores + ((long)b * H + h) * T : nullptr,
                       out + (long)b * D + h * wtt::kHeadDim, p);
}

}  // namespace

extern "C" int wtt_xattn_decode_int4(const void* q, const void* xk, const void* xk_scale,
                                     const void* xv, const void* xv_scale, void* out,
                                     void* scores, int layer, int B, int b_kv_rows, int T,
                                     int D, int H, int beam_group, float scale,
                                     void* stream) {
  dim3 grid(H, B);
  xattn_decode_int4_kernel<<<grid, wtt::kThreads, (size_t)T * sizeof(float),
                             (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)xk, (const float*)xk_scale,
      (const int8_t*)xv, (const float*)xv_scale, (__nv_bfloat16*)out, (float*)scores,
      layer, b_kv_rows, T, D, H, beam_group, scale);
  return (int)cudaGetLastError();
}

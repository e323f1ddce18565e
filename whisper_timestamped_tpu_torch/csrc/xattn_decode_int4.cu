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
// bytes of scales per frame (large-v3, B=40: 82 MB with the scores, 25 us at
// 3.35 TB/s), and does 4 flops per K/V code pair.
//
// Design: xattn_decode_int8's (decode_attn.cuh, the grid (n_split, H, B)
// from ops.kernels) with nibble rows: the split runs over the T/2 packed
// rows, in blocks of 4 warps at every batch, since a tile here carries
// twice the frames a byte and more warps an SM hide their work (large-v3
// B=1 -> 6 splits of 128 packed rows; B=8 -> 3 splits of 256; B=40 ->
// none, 800 blocks). Four lanes read one 64-byte packed head row, 16 bytes each,
// so one 16-byte cp.async brings 16 columns of two frames and each packed
// byte comes from device memory once; a warp's 16 packed rows of a tile are
// 32 frames. The nibbles widen to f32 exactly in registers (a mask and an
// xor a word, then a byte permute and an add a code); each read of a K row
// gives both frames' scores, each read of a V row feeds both frames'
// weights. The even and odd scale ranges of a tile are each contiguous and
// copied as int8's scales are. Scores go out in frame order, 32 frames a
// warp store. Rows and scales are read at b / beam_group.

#include "decode_attn.cuh"

namespace {

using Rows = wtt::decode::Int4Rows;

template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
xattn_decode_int4_kernel(const __nv_bfloat16* __restrict__ q,  // (B, D)
                         const int8_t* __restrict__ xk,        // (L, B_kv, T/2, D)
                         const float* __restrict__ xk_scale,   // (L, B_kv, T), parity-major
                         const int8_t* __restrict__ xv,
                         const float* __restrict__ xv_scale,
                         __nv_bfloat16* __restrict__ out,      // (B, D)
                         float* __restrict__ scores,           // (B, H, T) or null
                         int layer, int b_kv_rows, int T, int D, int H,
                         int beam_group, int rows_per_split, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int half = T / 2, lo = split * rows_per_split;
  const long slab = (long)layer * b_kv_rows + b / beam_group;
  const long packed = slab * half * D + (long)h * wtt::kHeadDim;  // packed row 0, head h
  const long col = (long)b * D + h * wtt::kHeadDim;
  const Rows rows{xk + packed, xv + packed, D, xk_scale + slab * T, xv_scale + slab * T, half};
  wtt::decode::attend<kWarps>(rows, q + col, lo, min(half, lo + rows_per_split), scale,
                              scores ? scores + ((long)b * H + h) * T : nullptr, out + col,
                              gridDim.x);
}

}  // namespace

extern "C" int wtt_xattn_decode_int4(const void* q, const void* xk, const void* xk_scale,
                                     const void* xv, const void* xv_scale, void* out,
                                     void* scores, int layer, int B, int b_kv_rows, int T, int D,
                                     int H, int beam_group, int n_split, int rows_per_split,
                                     int warps, float scale, void* stream) {
  return (int)wtt::decode::launch<Rows>(
      warps, xattn_decode_int4_kernel<2>, xattn_decode_int4_kernel<4>, dim3(n_split, H, B),
      (cudaStream_t)stream, (const __nv_bfloat16*)q, (const int8_t*)xk, (const float*)xk_scale,
      (const int8_t*)xv, (const float*)xv_scale, (__nv_bfloat16*)out, (float*)scores, layer,
      b_kv_rows, T, D, H, beam_group, rows_per_split, scale);
}

// xattn_decode_int8: single-query cross-attention of one decode step over
// one layer of the stacked int8 encoder K/V, with per-frame f32 scales and
// optional pre-softmax scores.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py
//   cross_attention_stacked_int8_pallas_v2 :1051 (kernel :947), and v1 :687,
//   v3 :1249, v4 :1471 (the TPU default), cross_attention_int8_pallas :2572,
//   cross_attention_int8_rowmajor :2531: one function. It computes v2's:
//   scores (q·k)·ks·dh^-0.5 with q in bf16 and the int8 codes widened
//   exactly, f32 sums; out = softmax · vs · V. (v4 also rounds q and the
//   weights to 8 bits on the TPU's s8 units; it emits its scores on v2's
//   path, and this kernel does not round.)
//
// What bounds it on the H100: bytes. A call streams one layer's int8 K and
// V, B_kv * T * D bytes each, half of the bf16 kernel's, plus 8 bytes of
// scales per frame (large-v3, B=40: 2 * 40 * 1500 * 1280 = 154 MB, 46 us at
// 3.35 TB/s), and does 4 flops per K/V element pair.
//
// Design: xattn_decode's (decode_attn.cuh, split over T, the same grid
// (n_split, H, B) and warps a block from ops.kernels: large-v3 B=1 -> 8
// splits, B=8 -> 5, B=40 -> none, in blocks of 2 warps, so that all 800
// are resident at once) with int8 rows: a warp's 16 frames of a tile are
// 1 KB of K codes, 1 KB of V codes and 2 x 64 B of scales, copied by
// 16-byte cp.async two tiles ahead; four lanes read one 64-byte head row,
// 16 codes each, which widen to f32 exactly in registers (a byte permute
// and an add a code), so a dequantized K/V never exists in memory. K's
// scale multiplies the row's dot product, V's scale the row's softmax
// weight (kept in f32); the splits merge within their block cluster. Rows
// of K/V and their scales are read at b / beam_group. Tensor cores bring
// nothing here: with beam_group 1 each query row has its own K/V, and the
// work is 4 flops a code pair.

#include "decode_attn.cuh"

namespace {

using Rows = wtt::decode::Int8Rows<false>;

template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
xattn_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,  // (B, D)
                         const int8_t* __restrict__ xk,        // (L, B_kv, T, D)
                         const float* __restrict__ xk_scale,   // (L, B_kv, T)
                         const int8_t* __restrict__ xv,
                         const float* __restrict__ xv_scale,
                         __nv_bfloat16* __restrict__ out,      // (B, D)
                         float* __restrict__ scores,           // (B, H, T) or null
                         int layer, int b_kv_rows, int T, int D, int H,
                         int beam_group, int frames_per_split, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lo = split * frames_per_split;
  const long row0 = ((long)layer * b_kv_rows + b / beam_group) * T;  // first frame's row
  const long head = (long)h * wtt::kHeadDim;
  const long col = (long)b * D + head;
  const Rows rows{xk + row0 * D + head, xv + row0 * D + head, D, xk_scale + row0,
                  xv_scale + row0};
  wtt::decode::attend<kWarps>(rows, q + col, lo, min(T, lo + frames_per_split), scale,
                              scores ? scores + ((long)b * H + h) * T : nullptr, out + col,
                              gridDim.x);
}

}  // namespace

extern "C" int wtt_xattn_decode_int8(const void* q, const void* xk, const void* xk_scale,
                                     const void* xv, const void* xv_scale, void* out,
                                     void* scores, int layer, int B, int b_kv_rows, int T, int D,
                                     int H, int beam_group, int n_split, int frames_per_split,
                                     int warps, float scale, void* stream) {
  return (int)wtt::decode::launch<Rows>(
      warps, xattn_decode_int8_kernel<2>, xattn_decode_int8_kernel<4>, dim3(n_split, H, B),
      (cudaStream_t)stream, (const __nv_bfloat16*)q, (const int8_t*)xk, (const float*)xk_scale, (const int8_t*)xv,
      (const float*)xv_scale, (__nv_bfloat16*)out, (float*)scores, layer, b_kv_rows, T, D, H,
      beam_group, frames_per_split, scale);
}

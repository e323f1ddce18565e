// self_attn_decode_int8: one decode step's self-attention over one layer of
// the stacked int8 self-attention cache with per-slot f32 scales, fused
// with the step's write of its new K/V row into that cache.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:2205
//   self_attention_stacked_int8_pallas (kernel _self_attn_stacked_int8_kernel
//   :2146) and its s8 variant self_attention_stacked_int8_mxu_pallas :2333:
//   live slots [min(pad_len[b], pos), pos], scores (q·k)·ks·dh^-0.5, out =
//   softmax · vs · V. The JAX step quantizes the new row in XLA before the
//   kernel (whisper_jax.py:930-936); here the same launch does it, which
//   saves the eager loop a dozen small launches per layer.
//
// The write: row b's new K (and V) is quantized as quantize_rows does,
// scale = max|x| / 127 over the whole D-wide row, code = rint(x / max(scale,
// 1e-8)) (IEEE divide, round half to even), bit for bit.
//
// What bounds it on the H100: bytes, and at small batch the latency of the
// first loads. A call reads the live slots of one layer's int8 K and V (at
// most ctx * D bytes each per row; large-v3, ctx=456: 0.58 MB) and their
// scales, and the new rows.
//
// Design: self_attn_decode's (decode_attn.cuh, split over the slots [0,
// extent), ``pos`` read from device memory, the same grid (n_split, H, B)
// from ops.kernels over the window's static extent: large-v3 B=1, extent
// 456 -> 8 splits of 64 slots, blocks of 4 warps; B=8 -> 4 splits of 128,
// blocks of 2; B=40 -> no split) with int8 rows: block (s, h, b) attends slots
// [max(lo, s * F), min(pos + 1, (s + 1) * F)) with lo = min(pad_len[b],
// pos); a split wholly below lo or wholly above pos leaves (-inf, 0, 0)
// and weighs 0 in its cluster's merge. Only the blocks whose split holds slot
// pos write: once their first tiles are in flight, each reduces |k_new[b]|
// and |v_new[b]| over all D columns (2 x 2.5 KB, from L2), stores its
// head's 64 codes of each into slot pos, and head 0's block stores the two
// scales. Such a block takes slot pos's codes from its own shared memory and
// its scales from registers, never from the cache row being written (its
// ring skips that row), and no other block reads slot pos. One launch a
// layer.
//
// wtt_self_attn_decode_int8_scaled, the instance for a tensor-parallel
// rank: the rank holds only its heads' D/tp columns of the row, whose
// scale is the whole row's (the caller's max|x| over every rank, then
// / 127, an IEEE quotient: ops/quant.py row_scales). It takes the two
// scales of each row b from ``row_scales`` (2, B) f32 (K's, then V's) and
// writes rint(x / max(scale, 1e-8)) with them: the same kernel without the
// owning blocks' reduction over the row. The instance without it is
// unchanged.

#include "decode_attn.cuh"

namespace {

template <int kWarps, bool kGivenScales>
__global__ void __launch_bounds__(32 * kWarps)
self_attn_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,      // (B, D)
                             const __nv_bfloat16* __restrict__ k_new,  // (B, D)
                             const __nv_bfloat16* __restrict__ v_new,
                             int8_t* k, float* k_scale,                // (L, B, ctx, D), (L, B, ctx)
                             int8_t* v, float* v_scale,
                             __nv_bfloat16* __restrict__ out,          // (B, D)
                             const int* __restrict__ pad_len,          // (B,)
                             const int* __restrict__ pos_slot,         // the step's slot
                             const float* __restrict__ row_scales,     // (2, B), kGivenScales
                             int layer, int B, int ctx, int D, int H,
                             int slots_per_split, float scale) {
  using Rows = wtt::decode::Int8Rows<true, kGivenScales>;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos = *pos_slot;
  const int first = split * slots_per_split;
  const int hi = min(pos + 1, first + slots_per_split);
  const int lo = max(first, max(0, min(pad_len[b], pos)));
  const long row0 = ((long)layer * B + b) * ctx;  // slot 0's row
  const int head = h * wtt::kHeadDim;
  const long col = (long)b * D + head;
  const bool own = first <= pos && pos < hi;  // this split holds slot pos: it writes the row
  Rows rows{k + row0 * D + head, v + row0 * D + head, D, k_scale + row0, v_scale + row0,
            own ? pos : -1, k_new + (long)b * D, v_new + (long)b * D, D, head,
            k + (row0 + pos) * D + head, v + (row0 + pos) * D + head,
            h == 0 ? k_scale + row0 + pos : nullptr, h == 0 ? v_scale + row0 + pos : nullptr};
  if constexpr (kGivenScales) {
    rows.ks_in = row_scales + b;
    rows.vs_in = row_scales + B + b;
  }
  wtt::decode::attend<kWarps>(rows, q + col, lo, hi, scale, nullptr, out + col, gridDim.x);
}

template <bool kGivenScales>
int launch_self_int8(const void* q, const void* k_new, const void* v_new, void* k,
                     void* k_scale, void* v, void* v_scale, void* out, const void* pad_len,
                     const void* pos, const void* row_scales, int layer, int B, int ctx, int D,
                     int H, int n_split, int slots_per_split, int warps, float scale,
                     void* stream) {
  return (int)wtt::decode::launch<wtt::decode::Int8Rows<true, kGivenScales>>(
      warps, self_attn_decode_int8_kernel<2, kGivenScales>,
      self_attn_decode_int8_kernel<4, kGivenScales>, dim3(n_split, H, B), (cudaStream_t)stream,
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
      (int8_t*)k, (float*)k_scale, (int8_t*)v, (float*)v_scale, (__nv_bfloat16*)out,
      (const int*)pad_len, (const int*)pos, (const float*)row_scales, layer, B, ctx, D, H,
      slots_per_split, scale);
}

}  // namespace

extern "C" int wtt_self_attn_decode_int8(const void* q, const void* k_new, const void* v_new,
                                         void* k, void* k_scale, void* v, void* v_scale,
                                         void* out, const void* pad_len, const void* pos,
                                         int layer, int B, int ctx, int D, int H, int n_split,
                                         int slots_per_split, int warps, float scale,
                                         void* stream) {
  return launch_self_int8<false>(q, k_new, v_new, k, k_scale, v, v_scale, out, pad_len, pos,
                                 nullptr, layer, B, ctx, D, H, n_split, slots_per_split, warps,
                                 scale, stream);
}

extern "C" int wtt_self_attn_decode_int8_scaled(const void* q, const void* k_new,
                                                const void* v_new, void* k, void* k_scale,
                                                void* v, void* v_scale, void* out,
                                                const void* pad_len, const void* pos,
                                                const void* row_scales, int layer, int B, int ctx,
                                                int D, int H, int n_split, int slots_per_split,
                                                int warps, float scale, void* stream) {
  return launch_self_int8<true>(q, k_new, v_new, k, k_scale, v, v_scale, out, pad_len, pos,
                                row_scales, layer, B, ctx, D, H, n_split, slots_per_split, warps,
                                scale, stream);
}

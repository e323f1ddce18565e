// self_attn_decode: single-query self-attention of one decode step over one
// layer of the stacked bf16 self-attention KV cache, optionally fused with
// the step's write of its new K/V row into that cache.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:2088
//   self_attention_stacked_pallas (kernel _self_attn_stacked_kernel :2033),
//   and the cache update the JAX step makes before it.
//
// What bounds it on the H100: bytes, and at small batch the latency of the
// first loads. A call reads the live slots of one layer's K and V; at most
// ctx * D * 2 bytes each per row (large-v3, ctx=456: 1.2 MB each), usually
// far fewer, since only slots [min(pad_len, pos), pos] are live: a slot s
// is live when pad_len[b] <= s <= pos, or s == pos (the second clause keeps
// a padding-slot query's own slot, so no row is ever fully masked and no
// NaN reaches later cache slots). No scores are written.
//
// Design: xattn_decode's (decode_attn.cuh, bf16 rows), split over the
// slots [0, extent). The step's slot ``pos`` is an int32 in device memory,
// read by every block, so that a captured CUDA graph replays the same
// launch at every step; the grid is (n_split, H, B), sized by the wrapper
// from the window's static extent (P + max_new slots, not pos + 1) with
// xattn_decode's rule (ops.kernels.xattn_split, pipeline_warps): large-v3
// B=1, extent 456 -> 8 splits of 64 slots, 160 blocks of 4 warps; B=8 -> 4
// splits of 128, 640 blocks of 2; B=40 -> no split, 800 blocks of 2. Block (s,
// h, b) attends slots [max(lo, s * F), min(pos + 1, (s + 1) * F)) with lo =
// min(pad_len[b], pos); a split wholly below lo or wholly above pos has no
// rows, leaves (m = -inf, l = 0, o = 0) and still joins its cluster's
// merge, which gives it weight 0. Slot pos is always live, so the merged
// max is finite.
//
// The fused write: with k_new/v_new given, the block whose split holds slot
// pos writes head h's 64 values of each into slot pos of layer ``layer``,
// row b, and its ring copies that slot's row from k_new/v_new instead of
// the cache, so the launch never reads a row it writes. No other block
// reads slot pos. One launch a layer replaces the two indexing copies and
// the attention.
//
// The row table (beam search): with ``src_row`` (B, ctx) int32 given, slot t
// of row b is read from physical row src_row[b, t] of the layer's cache, at
// ((layer * B + src_row[b, t]) * ctx + t) * D + h * 64, instead of from row
// b. A beam's history then follows its source beams through the table,
// which the decode loop updates each step (B x ctx int32), and the cache
// itself is never reordered. The fused write still goes to row b, slot pos,
// and the caller keeps src_row[b, pos] = b. Each lane loads the table entry
// of each row it copies (8 lanes share one, from L1). Without a table the
// kernel is its own template instance, with no table load.

#include "decode_attn.cuh"

namespace {

template <bool kTable>
using Rows = wtt::decode::Bf16Rows<true, kTable>;

template <int kWarps, bool kTable>
__global__ void __launch_bounds__(32 * kWarps)
self_attn_decode_kernel(const __nv_bfloat16* __restrict__ q,      // (B, D)
                        const __nv_bfloat16* __restrict__ k_new,  // (B, D) or null
                        const __nv_bfloat16* __restrict__ v_new,
                        __nv_bfloat16* k,                         // (L, B, ctx, D)
                        __nv_bfloat16* v,
                        __nv_bfloat16* __restrict__ out,          // (B, D)
                        const int* __restrict__ pad_len,          // (B,)
                        const int* __restrict__ pos_slot,         // the step's slot
                        const int* __restrict__ src_row,          // (B, ctx), kTable only
                        int layer, int B, int ctx, int D, int H,
                        int slots_per_split, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos = *pos_slot;
  const int first = split * slots_per_split;
  const int hi = min(pos + 1, first + slots_per_split);
  const int lo = max(first, max(0, min(pad_len[b], pos)));
  const long slab = ((long)layer * B + b) * (long)ctx * D + h * wtt::kHeadDim;
  const long col = (long)b * D + h * wtt::kHeadDim;
  const bool own = k_new != nullptr && first <= pos && pos < hi;  // this split holds slot pos
  if (own && threadIdx.x < 16) {  // 8 16-byte pieces of K, then 8 of V
    const int piece = threadIdx.x & 7;
    const __nv_bfloat16* src = (threadIdx.x < 8 ? k_new : v_new) + col + piece * 8;
    __nv_bfloat16* dst = (threadIdx.x < 8 ? k : v) + slab + (long)pos * D + piece * 8;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
  long base = slab;  // where row 0 of the read starts: row b's slab, or physical row 0's
  const int* table = nullptr;
  if constexpr (kTable) {
    base = (long)layer * B * (long)ctx * D + h * wtt::kHeadDim;
    table = src_row + (long)b * ctx;
  }
  const Rows<kTable> rows{k + base, v + base, D, own ? pos : -1, own ? k_new + col : nullptr,
                          own ? v_new + col : nullptr, table, (long)ctx * D};
  wtt::decode::attend<kWarps>(rows, q + col, lo, hi, scale, nullptr, out + col, gridDim.x);
}

template <bool kTable>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, void* k, void* v,
                   void* out, const void* pad_len, const void* pos, const void* src_row,
                   int layer, int B, int ctx, int D, int H, int n_split, int slots_per_split,
                   int warps, float scale, void* stream) {
  return wtt::decode::launch<Rows<kTable>>(
      warps, self_attn_decode_kernel<2, kTable>, self_attn_decode_kernel<4, kTable>,
      dim3(n_split, H, B), (cudaStream_t)stream, (const __nv_bfloat16*)q,
      (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (__nv_bfloat16*)k,
      (__nv_bfloat16*)v, (__nv_bfloat16*)out, (const int*)pad_len, (const int*)pos,
      (const int*)src_row, layer, B, ctx, D, H, slots_per_split, scale);
}

}  // namespace

extern "C" int wtt_self_attn_decode(const void* q, const void* k_new, const void* v_new,
                                    void* k, void* v, void* out, const void* pad_len,
                                    const void* pos, const void* src_row, int layer, int B,
                                    int ctx, int D, int H, int n_split, int slots_per_split,
                                    int warps, float scale, void* stream) {
  return (int)(src_row == nullptr ? launch<false> : launch<true>)(
      q, k_new, v_new, k, v, out, pad_len, pos, src_row, layer, B, ctx, D, H, n_split,
      slots_per_split, warps, scale, stream);
}

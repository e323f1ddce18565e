// self_attn_decode: single-query self-attention of one decode step over one
// layer of the stacked bf16 self-attention KV cache.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:2088
//   self_attention_stacked_pallas (kernel _self_attn_stacked_kernel :2033).
//
// What bounds it on the H100: bytes, and at small batch the launch. A call
// reads the live slots of one layer's K and V; at most ctx * D * 2 bytes
// each per row (large-v3, ctx=456: 1.2 MB each), usually far fewer, since
// only slots [min(pad_len, pos), pos] are live.
//
// Design: one block per (head, batch row), 256 threads, the same row-per-8-
// lanes dot products, shared-memory softmax and grouped p·V sum as
// xattn_decode (common.cuh). The block reads only the live slots: a slot s
// is live when pad_len[b] <= s <= pos, or s == pos. The second clause keeps
// a padding-slot query's own slot, so no row is ever fully masked and no
// NaN reaches later cache slots. No scores are written.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(wtt::kThreads)
self_attn_decode_kernel(const __nv_bfloat16* __restrict__ q,  // (B, D)
                        const __nv_bfloat16* __restrict__ k,  // (L, B, ctx, D)
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,      // (B, D)
                        const int* __restrict__ pad_len,      // (B,)
                        int layer, int pos, int B, int ctx, int D,
                        float scale) {
  extern __shared__ float p[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int lo = max(0, min(pad_len[b], pos));
  const long slab = ((long)layer * B + b) * (long)ctx * D;
  wtt::attend_one_head(q + (long)b * D + h * wtt::kHeadDim,
                       wtt::Bf16Rows{k + slab + h * wtt::kHeadDim, D},
                       wtt::Bf16Rows{v + slab + h * wtt::kHeadDim, D}, lo, pos, scale,
                       nullptr, out + (long)b * D + h * wtt::kHeadDim, p);
}

}  // namespace

extern "C" int wtt_self_attn_decode(const void* q, const void* k, const void* v,
                                    void* out, const void* pad_len, int layer,
                                    int pos, int B, int ctx, int D, int H,
                                    float scale, void* stream) {
  dim3 grid(H, B);
  self_attn_decode_kernel<<<grid, wtt::kThreads,
                            (size_t)(pos + 1) * sizeof(float),
                            (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (const int*)pad_len,
      layer, pos, B, ctx, D, scale);
  return (int)cudaGetLastError();
}

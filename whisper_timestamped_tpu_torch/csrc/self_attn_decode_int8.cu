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
// 1e-8)) (IEEE divide, round half to even), bit for bit. Every block
// (head, b) computes the row's scale itself, writes its own head's 64 codes
// into slot pos, and head 0's block stores the scales. Slot pos then takes
// its scale from registers (another head's block may not have stored it
// yet) and its codes from what this block wrote; the cache is read without
// the read-only cache, since this launch writes it.
//
// What bounds it on the H100: bytes, and at small batch the launch. A call
// reads the live slots of one layer's int8 K and V (at most ctx * D bytes
// each per row; large-v3, ctx=456: 0.58 MB) and their scales.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(wtt::kThreads)
self_attn_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,      // (B, D)
                             const __nv_bfloat16* __restrict__ k_new,  // (B, D)
                             const __nv_bfloat16* __restrict__ v_new,
                             int8_t* k, float* k_scale,                // (L, B, ctx, D), (L, B, ctx)
                             int8_t* v, float* v_scale,
                             __nv_bfloat16* __restrict__ out,          // (B, D)
                             const int* __restrict__ pad_len,          // (B,)
                             int layer, int pos, int B, int ctx, int D, float scale) {
  extern __shared__ float p[];
  __shared__ float red[32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long row0 = ((long)layer * B + b) * ctx;  // slot 0's row
  const long col = (long)h * wtt::kHeadDim;

  // 1. quantize and write this step's row (slot pos)
  float kmax = 0.f, vmax = 0.f;
  for (int i = tid; i < D; i += wtt::kThreads) {
    kmax = fmaxf(kmax, fabsf(__bfloat162float(k_new[(long)b * D + i])));
    vmax = fmaxf(vmax, fabsf(__bfloat162float(v_new[(long)b * D + i])));
  }
  const float ks = wtt::block_reduce<0>(kmax, red) / 127.f;
  const float vs = wtt::block_reduce<0>(vmax, red) / 127.f;
  if (tid < wtt::kHeadDim) {
    const long dst = (row0 + pos) * D + col + tid;
    k[dst] = (int8_t)rintf(__bfloat162float(k_new[(long)b * D + col + tid]) / fmaxf(ks, 1e-8f));
    v[dst] = (int8_t)rintf(__bfloat162float(v_new[(long)b * D + col + tid]) / fmaxf(vs, 1e-8f));
  }
  if (h == 0 && tid == 0) {
    k_scale[row0 + pos] = ks;
    v_scale[row0 + pos] = vs;
  }
  __syncthreads();  // this block's codes of slot pos are visible to it

  // 2. attend over the live slots
  const int lo = max(0, min(pad_len[b], pos));
  wtt::attend_one_head(q + (long)b * D + col,
                       wtt::Int8Rows{k + row0 * D + col, D, k_scale + row0, pos, ks},
                       wtt::Int8Rows{v + row0 * D + col, D, v_scale + row0, pos, vs},
                       lo, pos, scale, nullptr, out + (long)b * D + col, p);
}

}  // namespace

extern "C" int wtt_self_attn_decode_int8(const void* q, const void* k_new, const void* v_new,
                                         void* k, void* k_scale, void* v, void* v_scale,
                                         void* out, const void* pad_len, int layer, int pos,
                                         int B, int ctx, int D, int H, float scale,
                                         void* stream) {
  dim3 grid(H, B);
  self_attn_decode_int8_kernel<<<grid, wtt::kThreads, (size_t)(pos + 1) * sizeof(float),
                                 (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
      (int8_t*)k, (float*)k_scale, (int8_t*)v, (float*)v_scale, (__nv_bfloat16*)out,
      (const int*)pad_len, layer, pos, B, ctx, D, scale);
  return (int)cudaGetLastError();
}

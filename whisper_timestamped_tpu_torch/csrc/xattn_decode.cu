// xattn_decode: single-query cross-attention of one decode step over one
// layer of the stacked bf16 encoder K/V, with optional pre-softmax scores.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:854
//   cross_attention_stacked_pallas_v2 (kernel _xattn_stacked_v2_kernel :739).
//
// What bounds it on the H100: bytes. Each call streams one layer's K and V,
// B_kv * T * D * 2 bytes each (large-v3, B=1: 1500 * 1280 * 2 * 2 = 7.7 MB),
// and does 4 flops per K/V element pair, far below the 295 flop/byte ridge.
// At 3.35 TB/s the floor is about 2.3 us per call at B=1.
//
// Design: one block per (head, batch row), 256 threads. Eight lanes read one
// 128-byte K row (16 bytes each), so a warp reads four whole rows per load;
// the dot products sum in f32 and the scaled score goes to shared memory
// (T floats, 6 KB at T=1500) and, for alignment layers only, to ``scores``.
// The softmax runs over shared memory; then 32 row groups of 8 lanes
// accumulate p·V in f32 and a shared-memory pass sums the groups. Softmax
// weights stay f32 (the TPU kernel rounds them to bf16 before the V product);
// the output is rounded to bf16 once. Rows of K/V are read at b / beam_group.
// At B=1 this is 20 blocks on 132 SMs: splitting T across blocks is the
// next step for speed.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(wtt::kThreads)
xattn_decode_kernel(const __nv_bfloat16* __restrict__ q,   // (B, D)
                    const __nv_bfloat16* __restrict__ xk,  // (L, B_kv, T, D)
                    const __nv_bfloat16* __restrict__ xv,
                    __nv_bfloat16* __restrict__ out,       // (B, D)
                    float* __restrict__ scores,            // (B, H, T) or null
                    int layer, int b_kv_rows, int T, int D, int H,
                    int beam_group, float scale) {
  extern __shared__ float p[];
  const int h = blockIdx.x, b = blockIdx.y;
  const long slab = ((long)layer * b_kv_rows + b / beam_group) * (long)T * D;
  wtt::attend_one_head(q + (long)b * D + h * wtt::kHeadDim,
                       wtt::Bf16Rows{xk + slab + h * wtt::kHeadDim, D},
                       wtt::Bf16Rows{xv + slab + h * wtt::kHeadDim, D}, 0, T - 1, scale,
                       scores ? scores + ((long)b * H + h) * T : nullptr,
                       out + (long)b * D + h * wtt::kHeadDim, p);
}

}  // namespace

extern "C" int wtt_xattn_decode(const void* q, const void* xk, const void* xv,
                                void* out, void* scores, int layer, int B,
                                int b_kv_rows, int T, int D, int H,
                                int beam_group, float scale, void* stream) {
  dim3 grid(H, B);
  xattn_decode_kernel<<<grid, wtt::kThreads, (size_t)T * sizeof(float),
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)xk,
      (const __nv_bfloat16*)xv, (__nv_bfloat16*)out, (float*)scores, layer,
      b_kv_rows, T, D, H, beam_group, scale);
  return (int)cudaGetLastError();
}

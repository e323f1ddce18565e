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
// Design: split T across blocks, so that a small batch still fills the
// card, and keep a block's bytes in flight. The grid is (n_split, H, B):
// block (s, h, b) owns frames [s * F, min(T, (s + 1) * F)) of head h of
// row b, F a multiple of 64 frames. The wrapper picks n_split and the warps
// a block (ops.kernels.xattn_split, pipeline_warps): blocks of 4 warps
// while the B * H (row, head) pairs are fewer than the SMs, else 2, and
// about 12 warps an SM, at most one split per 64 frames and 8 in all.
// Large-v3 at T = 1500: B=1 -> 8 splits of 192 frames, 160 blocks of 4
// warps; B=8 -> 5 splits of 320, 800 blocks of 2; B=40 -> no split, 800
// blocks of 2.
//
// A block walks its frames through the shared pipeline of decode_attn.cuh
// with bf16 rows: tiles of 16 frames a warp through a two-stage ring in
// shared memory, each warp copying its rows of a tile by 16-byte cp.async
// two tiles ahead and consuming them alone, so the loop has no block
// barrier. Eight lanes read one 128-byte K row from shared memory; each
// score q·k sums in f32 (the old kernel's order) and the scaled scores go
// to ``scores`` for alignment layers, 16 frames a store. Each warp keeps an
// online softmax (m, l, o in f32); the block merges its warps' at the end.
// With one split the block writes o / l, rounded to bf16 once. With more,
// the n_split blocks of (b, h) are one thread block cluster: rank 0 reads
// the others' (m, l, o) from their shared memory, rescales each by
// exp(m_i - M), divides by sum l_i exp(m_i - M) and writes the output. One
// launch per call, no scratch in device memory. Rows of K/V are read at
// b / beam_group.

#include "decode_attn.cuh"

namespace {

using Rows = wtt::decode::Bf16Rows<false>;

template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
xattn_decode_kernel(const __nv_bfloat16* __restrict__ q,   // (B, D)
                    const __nv_bfloat16* __restrict__ xk,  // (L, B_kv, T, D)
                    const __nv_bfloat16* __restrict__ xv,
                    __nv_bfloat16* __restrict__ out,       // (B, D)
                    float* __restrict__ scores,            // (B, H, T) or null
                    int layer, int b_kv_rows, int T, int D, int H,
                    int beam_group, int frames_per_split, float scale) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lo = split * frames_per_split;
  const long slab = ((long)layer * b_kv_rows + b / beam_group) * (long)T * D + h * wtt::kHeadDim;
  const long col = (long)b * D + h * wtt::kHeadDim;
  const Rows rows{xk + slab, xv + slab, D, -1, nullptr, nullptr, nullptr, 0};
  wtt::decode::attend<kWarps>(rows, q + col, lo, min(T, lo + frames_per_split), scale,
                              scores ? scores + ((long)b * H + h) * T : nullptr, out + col,
                              gridDim.x);
}

}  // namespace

extern "C" int wtt_xattn_decode(const void* q, const void* xk, const void* xv, void* out,
                                void* scores, int layer, int B, int b_kv_rows, int T, int D,
                                int H, int beam_group, int n_split, int frames_per_split,
                                int warps, float scale, void* stream) {
  return (int)wtt::decode::launch<Rows>(
      warps, xattn_decode_kernel<2>, xattn_decode_kernel<4>, dim3(n_split, H, B),
      (cudaStream_t)stream, (const __nv_bfloat16*)q, (const __nv_bfloat16*)xk,
      (const __nv_bfloat16*)xv, (__nv_bfloat16*)out, (float*)scores, layer, b_kv_rows, T, D, H,
      beam_group, frames_per_split, scale);
}

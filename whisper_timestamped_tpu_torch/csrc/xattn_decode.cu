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
// row b, F a multiple of the 64-frame tile. The wrapper picks n_split
// (ops.kernels.xattn_split): about three blocks per SM over the B * H
// (row, head) pairs, at most one split per tile; F is that many splits'
// share of the tiles, in whole tiles, and n_split = ceil(T / F).
// Large-v3 at T = 1500 (24 tiles): B=1 -> 12 splits of 128 frames, 240
// blocks; B=8 -> 3 splits of 512, 480 blocks; B=40 -> no split, 800
// blocks.
//
// A block of 128 threads walks its tiles through a two-stage ring in shared
// memory: every thread issues 16-byte cp.async copies of the tile's K and V
// rows (8 KB each) two tiles ahead, so V arrives while the scores are
// computed and the next tile while this one is consumed. Eight lanes read
// one 128-byte K row from shared memory; each score q·k sums in f32 (the
// old kernel's order) and the scaled score goes to ``scores`` for alignment
// layers. The softmax is online over the block's tiles: the running max m,
// the sum l of exp(s - m) and the unnormalised o = sum exp(s - m) v, all
// f32 (each warp reduces the tile's max and sum itself, so no barrier is
// spent on them). With one split the block writes o / l, rounded to bf16
// once. With more, it writes (m, l, o) to f32 scratch, fences, and takes a
// ticket from its (b, h) counter; the block that draws the last ticket
// resets the counter to 0, merges the partials (each rescaled by
// exp(m_i - M), divided by sum l_i exp(m_i - M)) and writes the output.
// One launch per call. The counters live in a buffer the wrapper keeps per
// device and stream, zero between launches; a launch on another stream
// gets its own, so concurrent calls never share one. Rows of K/V are read
// at b / beam_group.

#include "common.cuh"

namespace {

constexpr int kTileT = 64;          // frames per tile
constexpr int kXThreads = 128;
constexpr int kPartial = 2 + wtt::kHeadDim;  // m, l, o[64]

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(kXThreads)
xattn_decode_kernel(const __nv_bfloat16* __restrict__ q,   // (B, D)
                    const __nv_bfloat16* __restrict__ xk,  // (L, B_kv, T, D)
                    const __nv_bfloat16* __restrict__ xv,
                    __nv_bfloat16* __restrict__ out,       // (B, D)
                    float* __restrict__ scores,            // (B, H, T) or null
                    float* __restrict__ partials,          // (B, H, n_split, 66) or null
                    unsigned* __restrict__ counters,       // (B * H,) or null
                    int layer, int b_kv_rows, int T, int D, int H,
                    int beam_group, int frames_per_split, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[2][kTileT][wtt::kHeadDim];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kTileT][wtt::kHeadDim];
  __shared__ float p[kTileT];
  __shared__ float part[kXThreads / 8][wtt::kHeadDim];
  __shared__ bool last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int sub = lane >> 3;   // which of the warp's 4 rows
  const int chunk = lane & 7;  // which 8 of the 64 dims
  const int grp = tid >> 3;    // row group of the p·V pass (16 of them)
  const int lo = split * frames_per_split;
  const int hi = min(T, lo + frames_per_split);  // exclusive
  const int n_tiles = (hi - lo + kTileT - 1) / kTileT;
  const long slab = ((long)layer * b_kv_rows + b / beam_group) * (long)T * D + h * wtt::kHeadDim;
  const __nv_bfloat16* kb = xk + slab;
  const __nv_bfloat16* vb = xv + slab;
  float* srow = scores ? scores + ((long)b * H + h) * T : nullptr;

  // each thread copies 4 of a tile's 512 16-byte pieces of K and 4 of V
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int t0 = lo + i * kTileT, st = i & 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tid + kXThreads * j, r = c >> 3, col = (c & 7) * 8;
        if (t0 + r < hi) {
          cp_async16(&ks[st][r][col], kb + (long)(t0 + r) * D + col);
          cp_async16(&vs[st][r][col], vb + (long)(t0 + r) * D + col);
        }
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  issue(0);
  issue(1);

  float qf[8];
  wtt::bf16x8_to_f32(*reinterpret_cast<const uint4*>(q + (long)b * D + h * wtt::kHeadDim + chunk * 8),
                     qf);
  float m = -INFINITY, l = 0.f, acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1, t0 = lo + i * kTileT, n = min(kTileT, hi - t0);
    cp_async_wait1();  // this thread's copies of tile i have landed
    __syncthreads();   // and everyone's

    // scores: 8 lanes a row, a warp 4 rows, the block 16 rows a pass
    for (int r0 = (tid >> 5) * 4; r0 < n; r0 += kXThreads / 8) {
      const int r = r0 + sub;
      float s = 0.f;
      if (r < n) {
        float kf[8];
        wtt::bf16x8_to_f32(*reinterpret_cast<const uint4*>(&ks[st][r][chunk * 8]), kf);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += qf[j] * kf[j];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (chunk == 0 && r < n) {
        s *= scale;
        p[r] = s;
        if (srow) srow[t0 + r] = s;
      }
    }
    __syncthreads();

    // online softmax: every warp reduces the tile's max and sum alike
    const float s0 = lane < n ? p[lane] : -INFINITY;
    const float s1 = lane + 32 < n ? p[lane + 32] : -INFINITY;
    const float m_new = fmaxf(m, wtt::warp_max(fmaxf(s0, s1)));
    const float alpha = expf(m - m_new);
    l = l * alpha + wtt::warp_sum((lane < n ? expf(s0 - m_new) : 0.f) +
                                  (lane + 32 < n ? expf(s1 - m_new) : 0.f));
    m = m_new;

    // o = o * alpha + sum_r exp(s_r - m) v_r: 16 row groups x 8 lanes of 8 dims
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] *= alpha;
    for (int r = grp; r < n; r += kXThreads / 8) {
      float vf[8];
      wtt::bf16x8_to_f32(*reinterpret_cast<const uint4*>(&vs[st][r][chunk * 8]), vf);
      const float w = expf(p[r] - m);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += w * vf[j];
    }
    __syncthreads();  // stage st is consumed: refill it
    issue(i + 2);
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) part[grp][chunk * 8 + j] = acc[j];
  __syncthreads();
  float o = 0.f;
  if (tid < wtt::kHeadDim)
    for (int g = 0; g < kXThreads / 8; ++g) o += part[g][tid];
  __nv_bfloat16* orow = out + (long)b * D + h * wtt::kHeadDim;
  if (n_split == 1) {
    if (tid < wtt::kHeadDim) orow[tid] = __float2bfloat16(o / l);
    return;
  }

  // write this split's (m, l, o); the last block of (b, h) merges them
  const int bh = b * H + h;
  float* mine = partials + ((long)bh * n_split + split) * kPartial;
  if (tid < wtt::kHeadDim) mine[2 + tid] = o;
  if (tid == 0) {
    mine[0] = m;
    mine[1] = l;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned ticket = atomicAdd(counters + bh, 1u);
    last = ticket == (unsigned)(n_split - 1);
    if (last) counters[bh] = 0u;  // every other block of (b, h) has drawn
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < wtt::kHeadDim) {
    const float* all = partials + (long)bh * n_split * kPartial;
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, __ldcg(all + s * kPartial));
    float L = 0.f, O = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(__ldcg(all + s * kPartial) - M);
      L += __ldcg(all + s * kPartial + 1) * w;
      O += __ldcg(all + s * kPartial + 2 + tid) * w;
    }
    orow[tid] = __float2bfloat16(O / L);
  }
}

}  // namespace

extern "C" int wtt_xattn_decode(const void* q, const void* xk, const void* xv,
                                void* out, void* scores, void* partials, void* counters,
                                int layer, int B, int b_kv_rows, int T, int D, int H,
                                int beam_group, int n_split, int frames_per_split, float scale,
                                void* stream) {
  dim3 grid(n_split, H, B);
  xattn_decode_kernel<<<grid, kXThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)xk, (const __nv_bfloat16*)xv,
      (__nv_bfloat16*)out, (float*)scores, (float*)partials, (unsigned*)counters, layer,
      b_kv_rows, T, D, H, beam_group, frames_per_split, scale);
  return (int)cudaGetLastError();
}

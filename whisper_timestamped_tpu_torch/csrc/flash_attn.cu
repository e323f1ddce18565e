// flash_attention: multi-head softmax(q·kᵀ·dh^-0.5 + mask)·v over (B, S, D)
// projections, head h in columns h*64 .. h*64+63, for the encoder's
// self-attention and the prompt prefill's self- and cross-attention.
//
// Replaces: the library Pallas kernel
//   jax.experimental.pallas.ops.tpu.flash_attention, called at
//   whisper_timestamped_tpu/models/whisper_jax.py:246 (_encoder_attention)
//   and :299 (_prefill_flash_attention, gated at decoding.py:309-314).
//
// Masks: with ``causal``, key k is live for query q when
// pad_len[b] <= k <= q, or k == q (the own-slot escape: a left-padding
// query keeps its own slot, so no row is ever empty and every row equals
// the plain version's). Without it every key k < Sk is live. The ragged
// tail (T = 1500 = 23 * 64 + 28) is masked here.
//
// What bounds it on the H100: operations. 4 * B * H * Sq * Sk * 64 flops
// (the two products) against B * (2 Sq + 2 Sk) * D * 2 bytes: at the
// encoder's T = 1500 that is ~750 flops per byte, above the card's ~295
// ridge. large-v3 encoder, one layer: 11.5 GFLOP at B=1 (11.6 us at
// 989 TFLOP/s bf16), 92 GFLOP at B=8.
//
// Design (simple first; wgmma/TMA is later work): one block of 4 warps per
// (64-query tile, head, batch row); each warp owns 16 query rows. The Q
// tile is staged through shared memory once and kept as mma A fragments.
// A loop walks 64-key tiles of K and V through shared memory (24 KB of
// tiles; V is stored transposed so its B fragments are 32-bit loads).
// S = Q·Kᵀ and O += P·V run on the tensor cores as mma.sync.m16n8k16 bf16
// with f32 accumulators; the softmax is online (running max and sum in f32
// registers, exp2 of log2e-scaled scores); P is rounded to bf16 for the
// P·V product, as the TPU kernel rounds it (carrying P as two bf16 terms,
// hi + lo, was tried: it barely moved a 32-layer encode's distance from the
// f32 plain version, which is the bf16 network's own and which PyTorch's
// scaled_dot_product_attention shows too). O is divided by the row sum and
// rounded to bf16 once. The
// (B, H, Sq, Sk) scores never reach device memory. Key tiles that are
// wholly masked are skipped: under ``causal`` those past the query tile
// and those wholly below pad_len[b]; the diagonal tile always runs, since
// it holds the own-slot keys. Grid at the large-v3 encoder, B=1:
// 24 x 20 = 480 blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // query rows and keys per tile
constexpr int kHead = 64;     // head width
constexpr int kStride = 72;   // padded shared-memory row (bf16): 144 bytes
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// d += a (16x16, row) * b (16x8, col); bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,  // (B, Sq, D)
                       const __nv_bfloat16* __restrict__ k,  // (B, Sk, D)
                       const __nv_bfloat16* __restrict__ v,  // (B, Sk, D)
                       __nv_bfloat16* __restrict__ out,      // (B, Sq, D)
                       const int* __restrict__ pad_len,      // (B,) or null
                       int Sq, int Sk, int D, int causal, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile][kStride];
  __shared__ __align__(16) __nv_bfloat16 ks[kTile][kStride];
  __shared__ __align__(16) __nv_bfloat16 vt[kHead][kStride];  // [dim][key]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int q0 = qt * kTile;
  const __nv_bfloat16* qb = q + (long)b * Sq * D + h * kHead;
  const __nv_bfloat16* kb = k + (long)b * Sk * D + h * kHead;
  const __nv_bfloat16* vb = v + (long)b * Sk * D + h * kHead;

  // Q tile -> shared (16-byte loads, rows past Sq zero) -> A fragments
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + kThreads * i, r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (long)(q0 + r) * D + col);
    *reinterpret_cast<uint4*>(&qs[r][col]) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qa[kk][0] = ld32(&qs[r0][16 * kk + 2 * t]);
    qa[kk][1] = ld32(&qs[r0 + 8][16 * kk + 2 * t]);
    qa[kk][2] = ld32(&qs[r0][16 * kk + 2 * t + 8]);
    qa[kk][3] = ld32(&qs[r0 + 8][16 * kk + 2 * t + 8]);
  }

  const int row0 = q0 + r0, row1 = row0 + 8;  // this thread's two query rows
  const int pad = pad_len ? pad_len[b] : 0;
  const int n_kt = (Sk + kTile - 1) / kTile;
  int kt_hi = n_kt - 1, kt_lo = 0;
  if (causal) {
    kt_hi = min(kt_hi, qt);                        // tiles past the query tile
    kt_lo = min(max(pad, 0) / kTile, kt_hi);       // tiles wholly below pad_len
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) o[nn][0] = o[nn][1] = o[nn][2] = o[nn][3] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + kThreads * i, r = c >> 3, col = (c & 7) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (long)(k0 + r) * D + col);
        vv = *reinterpret_cast<const uint4*>(vb + (long)(k0 + r) * D + col);
      }
      *reinterpret_cast<uint4*>(&ks[r][col]) = kv;
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[col + j][r] = vh[j];
    }
    __syncthreads();

    // S = Q Kᵀ: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma16816(s[j], qa[kk], ld32(&ks[8 * j + g][16 * kk + 2 * t]),
                 ld32(&ks[8 * j + g][16 * kk + 2 * t + 8]));
    }

    // mask, scale to log2 units, row max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        const bool in = key < Sk;
        const bool live0 = in && (!causal || (key <= row0 && key >= pad) || key == row0);
        const bool live1 = in && (!causal || (key <= row1 && key >= pad) || key == row1);
        s[j][e] = live0 ? s[j][e] * scale_log2 : -INFINITY;
        s[j][2 + e] = live1 ? s[j][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    // a row with no live key yet keeps m = -inf; subtract 0 instead of -inf
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - ms0), al1 = exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;

    // P = exp2(S - m), packed as bf16 A fragments of the P·V product:
    // k-step kk covers keys 16kk..16kk+15 = n-tiles 2kk and 2kk+1
    uint32_t pa[4][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sj = s[2 * kk + half];
        const float p0 = exp2f(sj[0] - ms0), p1 = exp2f(sj[1] - ms0);
        const float p2 = exp2f(sj[2] - ms1), p3 = exp2f(sj[3] - ms1);
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        pa[kk][2 * half] = pack_bf16(p0, p1);      // row g
        pa[kk][2 * half + 1] = pack_bf16(p2, p3);  // row g + 8
      }
    }
    l0 = l0 * al0 + quad_sum(rs0);
    l1 = l1 * al1 + quad_sum(rs1);

    // O = O * alpha + P V: 8 n-tiles of 8 dims
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      o[nn][0] *= al0;
      o[nn][1] *= al0;
      o[nn][2] *= al1;
      o[nn][3] *= al1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma16816(o[nn], pa[kk], ld32(&vt[8 * nn + g][16 * kk + 2 * t]),
                 ld32(&vt[8 * nn + g][16 * kk + 2 * t + 8]));
    }
  }

  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* ob = out + (long)b * Sq * D + h * kHead;
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) {
    const int col = 8 * nn + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)row0 * D + col) =
          __floats2bfloat162_rn(o[nn][0] * inv0, o[nn][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)row1 * D + col) =
          __floats2bfloat162_rn(o[nn][2] * inv1, o[nn][3] * inv1);
  }
}

}  // namespace

extern "C" int wtt_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, const void* pad_len, int B, int Sq,
                                   int Sk, int D, int H, int causal, float scale,
                                   void* stream) {
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_attention_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, (const int*)pad_len, Sq, Sk, D, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

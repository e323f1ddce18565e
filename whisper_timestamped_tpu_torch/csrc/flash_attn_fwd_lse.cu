// flash_attention_fwd: the training forward of the encoder's attention,
// softmax(q·kᵀ·dh^-0.5)·v over (B, S, D) projections, head h in columns
// h*64 .. h*64+63, no mask, with each row's log-sum-exp
// lse = m + log(l) (B, H, Sq) f32, the residual the backward
// (flash_attn_bwd.cu) recomputes the probabilities from. q/k/v f32 or
// bf16; the output in the inputs' type.
//
// Replaces: the library Pallas kernel's forward with residuals,
//   _flash_attention_fwd (jax/experimental/pallas/ops/tpu/flash_attention.py:234),
//   which the JAX package runs under jax.value_and_grad in train_step
//   (whisper_timestamped_tpu/training.py:52) through _encoder_attention
//   (models/whisper_jax.py:246) and saves the row max m and sum l.
//
// This file is the f32 route. bf16 inputs go to flash_attn.cu's kernel
// (wgmma fed by a TMA ring, P rounded to bf16 as the library rounds it)
// with no mask and its lse output.
//
// f32 inputs: 3xTF32 on tf32 wgmma (flash_tf32.cuh, shared with the
// backward). What bounds it on the H100: operations, two T x T x 64
// products a head, each three tf32 products: 3 x 23.04 GFLOP at the
// large-v3 encoder (B=2, T=1500, H=20), 0.140 ms at 495 TFLOP/s (0.344 ms
// on the CUDA cores' 67) against 0.06 ms of bytes.
//
// Design (Hopper), flash_attn.cu's for f32 operands: one block per
// (128-query tile, head, batch row), two consumer warpgroups of 64 query
// rows and a producer warp. The consumers split their Q rows into K-major
// hi and lo tiles once. A pre-pass (split_kv_kernel, one launch a call)
// writes K's hi and lo and the hi and lo of V's transpose (each head's
// (64, Sk) with each 8 keys in the order 0 2 4 6 1 3 5 7) to device memory
// once, so the 12 query blocks of a head do not split the same tiles 12
// times: the producer's TMA loads (32-float boxes, 128-byte swizzle) land
// them as the K-major operand tiles wgmma reads, kBN = 64 keys a tile,
// K and V apart, into a two-stage ring with full and empty mbarriers.
// S = Q·Kᵀ is 3 x 8 wgmma m64n64k8 from shared memory; the softmax is
// online in the accumulator registers (running max and sum in f32, exp2 of
// log2e-scaled scores, keys past Sk at -inf); P is split into hi and lo
// A fragments in registers as the accumulator holds it, and O += P·V is 3 x
// 8 wgmma m64n64k8 with A from registers. A warpgroup issues tile i's S
// with tile i-1's P·V, as flash_attn.cu does. O is divided by the row sum
// once; lse = m·ln2 + log(l).
//
// What holds it back (H100, the encoder shape, tools/torch_kernel_sweeps.py
// flash-fwd-variants): the kernel runs at about two thirds of the tf32
// rate, the split pass adds an eighth (92 MB at about the memory's rate).
// Removing the K and V loads saves 2 %. Each block splitting its raw K
// and V tiles itself instead, as the backward does (two barriers of all
// the consumers a tile), measured 55 % slower; 32-key tiles in a
// three-stage ring 17 % slower.

#include <math.h>

#include "flash_tf32.cuh"

namespace {

using namespace wtt::hopper;
using namespace wtt::tf32;

constexpr int kWGs = 2;         // consumer warpgroups, 64 query rows each
constexpr int kBM = 64 * kWGs;  // query rows a block
constexpr int kBN = 64;         // keys a tile
constexpr int kStages = 2;
constexpr int kConsumerWarps = 4 * kWGs;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr uint32_t kTileBytes = 2 * kBN * kHead * 4;  // hi and lo of one K or V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Slot {  // one ring stage: every tile 1024-byte aligned
  float khi[kBN * kHead], klo[kBN * kHead];  // K-major [2][kBN][32] (dims in halves)
  float vhi[kHead * kBN], vlo[kHead * kBN];  // V's transpose, K-major [kBN / 32][64][32]
};
struct Smem {
  float qhi[kBM * kHead], qlo[kBM * kHead];  // each warpgroup's 64 rows a [2][64][32] tile
  Slot slot[kStages];
  uint64_t k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + room to align the base

// the consumer warps' own barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// k, v (B, Sk, D) f32 -> khi, klo (B, Sk, D) and vthi, vtlo (B, D, Skp):
// the tf32 hi and lo of K, and of V's transpose with each 8 keys in the
// order 0 2 4 6 1 3 5 7 (zeros at keys Sk .. Skp - 1). One block of 256
// threads per (32 keys, head, batch row).
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ khi,
                float* __restrict__ klo, float* __restrict__ vthi, float* __restrict__ vtlo,
                int Sk, int Skp, int D) {
  __shared__ float vt[32][kHead + 1];
  const int k0 = blockIdx.x * 32, h = blockIdx.y, b = blockIdx.z;
  const long in = ((long)b * Sk + k0) * D + h * kHead;
  for (int i = threadIdx.x; i < 32 * 16; i += 256) {
    const int r = i >> 4, c = (i & 15) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (k0 + r < Sk) {
      const long at = in + (long)r * D + c;
      x = *reinterpret_cast<const float4*>(k + at);
      y = *reinterpret_cast<const float4*>(v + at);
      const float4 hx = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
      *reinterpret_cast<float4*>(khi + at) = hx;
      *reinterpret_cast<float4*>(klo + at) =
          make_float4(x.x - hx.x, x.y - hx.y, x.z - hx.z, x.w - hx.w);
    }
    vt[r][c] = y.x;
    vt[r][c + 1] = y.y;
    vt[r][c + 2] = y.z;
    vt[r][c + 3] = y.w;
  }
  __syncthreads();
  // output row n (a dim), 4 key positions p0 .. p0 + 3 a float4
  for (int i = threadIdx.x; i < kHead * 8; i += 256) {
    const int n = i >> 3, p0 = (i & 7) << 2;
    if (k0 + p0 >= Skp) continue;
    float x[4], hx[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int p = p0 + m, key = (p & ~7) + ((p & 7) < 4 ? 2 * (p & 7) : 2 * (p & 7) - 7);
      x[m] = vt[key][n];
      hx[m] = tf32_hi(x[m]);
    }
    const long at = ((long)b * D + h * kHead + n) * Skp + k0 + p0;
    *reinterpret_cast<float4*>(vthi + at) = make_float4(hx[0], hx[1], hx[2], hx[3]);
    *reinterpret_cast<float4*>(vtlo + at) =
        make_float4(x[0] - hx[0], x[1] - hx[1], x[2] - hx[2], x[3] - hx[3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tkh,  // K hi (B, Sk, D)
                      const __grid_constant__ CUtensorMap tkl,  // K lo
                      const __grid_constant__ CUtensorMap tvh,  // Vᵀ hi (B, D, Skp)
                      const __grid_constant__ CUtensorMap tvl,  // Vᵀ lo
                      const float* __restrict__ q,              // (B, Sq, D)
                      float* __restrict__ out,                  // (B, Sq, D)
                      float* __restrict__ lse,                  // (B, H, Sq)
                      int Sq, int Sk, int D, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = (Sk + kBN - 1) / kBN;  // key tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumerWarps);
      mbar_init(&sm.v_empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: lane 0 issues every load
    if (lane != 0) return;
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages, k0 = i * kBN;
      const uint32_t free_parity = ((i / kStages) & 1) ^ 1;  // the first round passes
      Slot& sl = sm.slot[st];
      mbar_wait(&sm.k_empty[st], free_parity);
      mbar_expect_tx(&sm.k_full[st], kTileBytes);
      for (int half = 0; half < 2; ++half) {  // dims in two 32-float halves
        tma_load(sl.khi + half * kBN * 32, &tkh, &sm.k_full[st], h * kHead + 32 * half, k0, b);
        tma_load(sl.klo + half * kBN * 32, &tkl, &sm.k_full[st], h * kHead + 32 * half, k0, b);
      }
      mbar_wait(&sm.v_empty[st], free_parity);
      mbar_expect_tx(&sm.v_full[st], kTileBytes);
      for (int half = 0; half < kBN / 32; ++half) {  // keys in 32-float halves
        tma_load(sl.vhi + half * kHead * 32, &tvh, &sm.v_full[st], k0 + 32 * half, h * kHead, b);
        tma_load(sl.vlo + half * kHead * 32, &tvl, &sm.v_full[st], k0 + 32 * half, h * kHead, b);
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63, this
  // thread rows row0 and row0 + 8 (the wgmma accumulator layout).
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g, row1 = row0 + 8;

  {  // Q's rows, split once (zeros past Sq)
    const int tid = threadIdx.x & 127;
    float* qh = sm.qhi + wg * 64 * kHead;
    float* ql = sm.qlo + wg * 64 * kHead;
    const float* qb = q + ((long)b * Sq + q0 + wg * 64) * D + h * kHead;
    for (int i = tid; i < 64 * 16; i += 128) {
      const int r = i >> 4, c = (i & 15) << 2;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + wg * 64 + r < Sq) x = *reinterpret_cast<const float4*>(qb + (long)r * D + c);
      const float4 hx = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
      *reinterpret_cast<float4*>(qh + kmajor<64>(r, c)) = hx;
      *reinterpret_cast<float4*>(ql + kmajor<64>(r, c)) =
          make_float4(x.x - hx.x, x.y - hx.y, x.z - hx.z, x.w - hx.w);
    }
    fence_async_smem();
    consumers_sync();
  }
  const float* qh = sm.qhi + wg * 64 * kHead;
  const float* ql = sm.qlo + wg * 64 * kHead;

  constexpr int kCols = kBN / 8;  // accumulator column groups of S
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's part
  float o[32], s[kBN / 2];
  Frag<kBN> pf;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto k_ready = [&](int i) { mbar_wait(&sm.k_full[i % kStages], (i / kStages) & 1); };
  auto v_ready = [&](int i) { mbar_wait(&sm.v_full[i % kStages], (i / kStages) & 1); };
  auto k_free = [&](int st) { release(&sm.k_empty[st]); };
  auto v_free = [&](int st) { release(&sm.v_empty[st]); };
  auto issue_s = [&](int st) {
    issue_ss3<kBN>(s, qh, ql, sm.slot[st].khi, sm.slot[st].klo);
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
    issue_rs3<kBN>(o, pf, sm.slot[st].vhi, sm.slot[st].vlo);
    wgmma_commit();
  };
  // mask (the last tile's keys past Sk); new running max; s becomes
  // P = exp2(S log2e/sqrt(dh) - m) in place; returns the old sums' factors.
  // Every tile holds a key below Sk, so the new max is finite.
  auto softmax = [&](int k0, float& al0, float& al1) {
    if (k0 + kBN > Sk) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = k0 + 8 * j + 2 * t + e < Sk;
          s[4 * j + e] = in ? s[4 * j + e] : -INFINITY;
          s[4 * j + 2 + e] = in ? s[4 * j + 2 + e] : -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    al0 = ex2(m0 - mn0);  // 0 on the first tile
    al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -mn0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -mn0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -mn1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -mn1));
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
  };
  auto rescale_o = [&](float al0, float al1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
  };

  float al0, al1;
  // tile 0: S only
  k_ready(0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  k_free(0);
  softmax(0, al0, al1);
  to_frag<kBN>(s, pf);
  // tile i's S with tile i-1's P V
  for (int i = 1; i < n; ++i) {
    const int st = i % kStages, sp = (i - 1) % kStages;
    k_ready(i);
    wgmma_fence();
    issue_s(st);
    v_ready(i - 1);
    issue_pv(sp);
    wgmma_wait<1>();  // S is in
    fence_regs(s);
    k_free(st);
    softmax(i * kBN, al0, al1);
    wgmma_wait<0>();  // P V is in: o and the old P are free
    fence_regs(o);
    fence_frag(pf);
    v_free(sp);
    rescale_o(al0, al1);
    to_frag<kBN>(s, pf);
  }
  // the last tile's P V
  const int sp = (n - 1) % kStages;
  v_ready(n - 1);
  wgmma_fence();
  issue_pv(sp);
  wgmma_wait<0>();
  fence_regs(o);
  fence_frag(pf);
  v_free(sp);

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (t == 0) {
    float* lb = lse + ((long)b * gridDim.y + h) * Sq;
    if (row0 < Sq) lb[row0] = m0 * kLn2 + logf(l0);
    if (row1 < Sq) lb[row1] = m1 * kLn2 + logf(l1);
  }
  float* ob = out + (long)b * Sq * D + h * kHead;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(ob + (long)row0 * D + col) =
          make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(ob + (long)row1 * D + col) =
          make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

}  // namespace

// f32 q, k, v (B, Sq | Sk, D) -> out (B, Sq, D), lse (B, H, Sq). split:
// scratch of 2 * B * D * (Sk + Skp) floats, Skp = Sk rounded up to 8
// (whole column-order groups; a TMA row stride a multiple of 16 bytes),
// for K's hi and lo (B, Sk, D) and those of V's transpose (B, D, Skp).
extern "C" int wtt_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, void* split, int B, int Sq, int Sk, int D,
                                       int H, float scale, void* stream) {
  if (D != H * kHead || B <= 0 || B > 65535 || H <= 0 || H > 65535 || Sq <= 0 || Sk <= 0 ||
      split == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc = cudaFuncSetAttribute(  // per device, so on every call
      flash_fwd_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  const int Skp = (Sk + 7) / 8 * 8;
  float* khi = (float*)split;
  float* klo = khi + (long)B * Sk * D;
  float* vthi = klo + (long)B * Sk * D;
  float* vtlo = vthi + (long)B * D * Skp;
  split_kv_kernel<<<dim3(Skp / 32 + (Skp % 32 != 0), H, B), 256, 0, (cudaStream_t)stream>>>(
      (const float*)k, (const float*)v, khi, klo, vthi, vtlo, Sk, Skp, D);
  CUtensorMap tkh, tkl, tvh, tvl;
  if (!make_map_tf32(&tkh, khi, D, Sk, B, kBN) || !make_map_tf32(&tkl, klo, D, Sk, B, kBN) ||
      !make_map_tf32(&tvh, vthi, Skp, D, B, kHead) || !make_map_tf32(&tvl, vtlo, Skp, D, B, kHead))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_tf32_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tkh, tkl, tvh, tvl, (const float*)q, (float*)out, (float*)lse, Sq, Sk, D, scale * kLog2e);
  return (int)cudaGetLastError();
}

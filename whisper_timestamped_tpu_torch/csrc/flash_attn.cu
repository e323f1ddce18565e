// flash_attention: multi-head softmax(q·kᵀ·dh^-0.5 + mask)·v over (B, S, D)
// projections, head h in columns h*64 .. h*64+63, for the encoder's
// self-attention and the prompt prefill's self- and cross-attention; with
// an lse pointer, also each row's log-sum-exp lse = m + log(l) (B, H, Sq)
// f32: the bf16 training forward (ops.kernels.flash_attention_fwd calls
// this entry point with no mask for bf16 inputs).
//
// Replaces: the library Pallas kernel
//   jax.experimental.pallas.ops.tpu.flash_attention, called at
//   whisper_timestamped_tpu/models/whisper_jax.py:246 (_encoder_attention)
//   and :299 (_prefill_flash_attention, gated at decoding.py:309-314);
//   with lse, its forward with residuals _flash_attention_fwd
//   (jax/experimental/pallas/ops/tpu/flash_attention.py:234), whose m and l
//   the lse folds into one number a row.
//
// Masks: with ``causal``, key k is live for query q when
// pad_len[b] <= k <= q, or k == q (the own-slot escape: a left-padding
// query keeps its own slot, so no row is ever empty and every row equals
// the plain version's). Without it every key k < Sk is live. The ragged
// tail (T = 1500 = 11 * 128 + 92) arrives zero-filled (TMA's out-of-bounds
// fill) and is masked to -inf here.
//
// What bounds it on the H100: operations. 4 * B * H * Sq * Sk * 64 flops
// (the two products) against B * (2 Sq + 2 Sk) * D * 2 bytes: at the
// encoder's T = 1500 that is ~750 flops per byte, above the card's ~295
// ridge. large-v3 encoder, one layer: 11.5 GFLOP at B=1 (11.6 us at
// 989 TFLOP/s bf16), 92 GFLOP at B=8.
//
// Design (Hopper): one block per (query tile of kBM = 64 * kConsumerWGs =
// 128 rows, head, batch row), grid 12 x 20 x B at the large-v3 encoder.
// Each of the two consumer warpgroups owns 64 query rows; one
// thread of a producer warpgroup issues every load by TMA
// (cp.async.bulk.tensor, 3-D tensor maps over (B, S, D) with the 128-byte
// swizzle): the Q tile once, then kBN-key K and V tiles into a two-stage
// ring, with mbarriers for full and empty slots (K and V apart, so S can
// start before V lands and K is freed before P·V ends). S = Q·Kᵀ is four
// wgmma.mma_async m64n128k16 (bf16 in, f32 out) with Q and K read from
// shared memory, both K-major. The softmax is online in the accumulator
// registers: running max and sum in f32, exp2 of log2e-scaled scores. P is
// rounded to bf16 in registers, as the TPU kernel rounds it, and feeds
// O += P·V as the register A operand of wgmma m64n64k16; V is read from
// shared memory in the [key][dim] layout TMA wrote, through the
// descriptor's MN-major (transpose) bit, so no transposed copy exists. O
// is divided by the row sum and rounded to bf16 once; the (B, H, Sq, Sk)
// scores never reach device memory. The lse comes from the running max (in
// log2 units of the scaled scores) and sum the softmax keeps anyway:
// m·ln2 + log(l), written by one thread a row.
//
// At head width 64 a tile's exp2s take the SFU about as long as its two
// products take the tensor cores, so a warpgroup issues tile i's S
// together with tile i-1's P·V, and the warpgroups' softmaxes and products
// interleave on the SM. (Making the warpgroups take turns to issue, with
// named barriers, measured no gain; nor did a third ring stage.)
//
// Key tiles that are wholly masked are skipped: under ``causal`` those past
// the query tile and those wholly below pad_len[b] that hold none of the
// tile's own slots.
//
// The tensor maps are encoded on the host per call (hopper.cuh's make_map)
// and passed as __grid_constant__ parameters. The TMA, mbarrier and wgmma
// helpers are hopper.cuh's, shared with stacked_matmul.cu.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace wtt::hopper;

constexpr int kConsumerWGs = 2;         // warpgroups of 64 query rows
constexpr int kBM = 64 * kConsumerWGs;  // query rows per block
constexpr int kBN = 128;                // keys per tile (wgmma_ss is m64n128)
constexpr int kHead = 64;
constexpr int kStages = 2;
constexpr int kConsumerWarps = 4 * kConsumerWGs;
// + a producer warpgroup (wgmma kernels get registers a warpgroup at a
// time), of which one thread issues the loads
constexpr int kThreads = 128 * (kConsumerWGs + 1);
constexpr uint32_t kTileBytes = kBN * kHead * 2;  // one K or V tile
constexpr uint32_t kQBytes = kBM * kHead * 2;

struct Smem {  // every tile 1024-byte aligned, as the 128-byte swizzle needs
  __nv_bfloat16 q[kBM * kHead];
  __nv_bfloat16 k[kStages][kBN * kHead];
  __nv_bfloat16 v[kStages][kBN * kHead];
  uint64_t q_full, k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + room to align the base

// kLse: write the rows' lse (the training forward); the inference
// instance carries no lse code (testing a runtime lse pointer instead made
// inference 4-6 % slower on the H100)
template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,  // (B, Sq, D)
                       const __grid_constant__ CUtensorMap tk,  // (B, Sk, D)
                       const __grid_constant__ CUtensorMap tv,  // (B, Sk, D)
                       __nv_bfloat16* __restrict__ out,         // (B, Sq, D)
                       float* __restrict__ lse,                 // (B, H, Sq) with kLse
                       const int* __restrict__ pad_len,         // (B,) or null
                       int Sq, int Sk, int D, int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * kBM;
  const int pad = pad_len ? max(pad_len[b], 0) : 0;
  const int n_kt = (Sk + kBN - 1) / kBN;
  int kt_hi = n_kt - 1, kt_lo = 0;
  if (causal) {
    kt_hi = min(kt_hi, (q0 + kBM - 1) / kBN);  // tiles past the query tile
    kt_lo = min(pad, q0) / kBN;  // tiles wholly below pad_len and this tile's own slots
  }
  const int n = kt_hi - kt_lo + 1;  // key tiles this block walks

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumerWarps);
      mbar_init(&sm.v_empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer: one thread issues every load
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(&sm.q_full, kQBytes);
      tma_load(sm.q, &tq, &sm.q_full, h * kHead, q0, b);
      for (int i = 0; i < n; ++i) {
        const int st = i % kStages, k0 = (kt_lo + i) * kBN;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;  // the first round passes
        mbar_wait(&sm.k_empty[st], free_parity);
        mbar_expect_tx(&sm.k_full[st], kTileBytes);
        tma_load(sm.k[st], &tk, &sm.k_full[st], h * kHead, k0, b);
        mbar_wait(&sm.v_empty[st], free_parity);
        mbar_expect_tx(&sm.v_full[st], kTileBytes);
        tma_load(sm.v[st], &tv, &sm.v_full[st], h * kHead, k0, b);
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63, this
  // thread rows row0 and row0 + 8 (the wgmma accumulator layout).
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g, row1 = row0 + 8;
  const uint64_t dq = sw128_desc(sm.q + wg * 64 * kHead);

  constexpr int kCols = kBN / 8;   // accumulator column groups of S
  constexpr int kSteps = kBN / 16;  // k-steps of P·V
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's part
  float o[32], s[kBN / 2];
  uint32_t pa[kSteps][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;

  // S = Q Kᵀ of stage st: 64 rows x kBN keys; s[4j + e] is (row0, key
  // k0 + 8j + 2t + e), s[4j + 2 + e] the same key for row1
  auto issue_qk = [&](int st) {
    const uint64_t dk = sw128_desc(sm.k[st]);
#pragma unroll
    for (int kk = 0; kk < kHead / 16; ++kk)  // 16 columns = 32 bytes a step
      wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    wgmma_commit();
  };
  // O += P V of stage st: 16 keys a step, V rows 2048 bytes apart
  auto issue_pv = [&](int st) {
    const uint64_t dv = sw128_desc(sm.v[st]);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_rs(o, pa[kk], dv + 128 * kk, 1);
    wgmma_commit();
  };
  // mask (only tiles that hold a masked key); new running max; s becomes
  // P = exp2(S log2e/sqrt(dh) - m) in place; returns the old sums' factors
  auto softmax = [&](int k0, float& al0, float& al1) {
    if (causal || k0 + kBN > Sk) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
          // bitwise, not short-circuit: selects, no branches
          const bool in = key < Sk, open = !causal;
          const bool live0 = in & (open | ((key <= row0) & (key >= pad)) | (key == row0));
          const bool live1 = in & (open | ((key <= row1) & (key >= pad)) | (key == row1));
          s[4 * j + e] = live0 ? s[4 * j + e] : -INFINITY;
          s[4 * j + 2 + e] = live1 ? s[4 * j + 2 + e] : -INFINITY;
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
    // a row with no live key yet keeps m = -inf; subtract 0 instead of -inf
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    al0 = ex2(m0 - ms0);
    al1 = ex2(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -ms0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -ms0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -ms1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -ms1));
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
  };
  // P as bf16 A fragments of P·V: k-step kk covers keys 16kk .. 16kk+15,
  // accumulator column groups 2kk (a0 row0, a1 row1) and 2kk+1 (a2, a3)
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
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
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  mbar_wait(&sm.q_full, 0);
  float al0, al1;
  // tile 0: S only
  mbar_wait(&sm.k_full[0], 0);
  wgmma_fence();
  issue_qk(0);
  wgmma_wait<0>();
  fence_regs(s);
  release(&sm.k_empty[0]);
  softmax(kt_lo * kBN, al0, al1);
  pack_p();
  // tile i's S with tile i-1's P V
  for (int i = 1; i < n; ++i) {
    const int st = i % kStages, sp = (i - 1) % kStages;
    mbar_wait(&sm.k_full[st], (i / kStages) & 1);
    wgmma_fence();
    issue_qk(st);
    mbar_wait(&sm.v_full[sp], ((i - 1) / kStages) & 1);
    issue_pv(sp);
    wgmma_wait<1>();  // S is in
    fence_regs(s);
    release(&sm.k_empty[st]);
    softmax((kt_lo + i) * kBN, al0, al1);
    wgmma_wait<0>();  // P V is in: o and the old P are free
    fence_regs(o);
    fence_regs(pa);
    release(&sm.v_empty[sp]);
    rescale_o(al0, al1);
    pack_p();
  }
  // the last tile's P V
  const int sp = (n - 1) % kStages;
  mbar_wait(&sm.v_full[sp], ((n - 1) / kStages) & 1);
  wgmma_fence();
  issue_pv(sp);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (kLse && t == 0) {  // every row holds a live key: l > 0
    float* lb = lse + ((long)b * gridDim.y + h) * Sq;
    if (row0 < Sq) lb[row0] = m0 * 0.6931471805599453f + logf(l0);
    if (row1 < Sq) lb[row1] = m1 * 0.6931471805599453f + logf(l1);
  }
  __nv_bfloat16* ob = out + (long)b * Sq * D + h * kHead;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)row0 * D + col) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long)row1 * D + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

}  // namespace

// lse null: inference (flash_attention); lse set: the bf16 training
// forward (flash_attention_fwd; no mask, pad_len null, causal 0)
extern "C" int wtt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   void* lse, const void* pad_len, int B, int Sq, int Sk, int D,
                                   int H, int causal, float scale, void* stream) {
  auto kernel = lse != nullptr ? flash_attention_kernel<true> : flash_attention_kernel<false>;
  const cudaError_t rc = cudaFuncSetAttribute(  // per device, so on every call
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Sq, B, kBM) || !make_map(&tk, k, D, Sk, B, kBN) ||
      !make_map(&tv, v, D, Sk, B, kBN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, (float*)lse, (const int*)pad_len, Sq, Sk, D, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

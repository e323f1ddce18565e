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
// scores never reach device memory.
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
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links no -lcuda)
// and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of parity ``parity`` has completed; a
// load that never lands traps (an error the wrapper reports) instead of
// hanging the card: every real wait here is microseconds
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    if (spin == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// TMA: box (64 columns, rows, 1) at (column c0, row c1, batch c2) -> smem
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a tile written by TMA with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO). For a
// K-major operand LBO is unused (1, as CUTLASS sets it); for the MN-major V
// tile of 64 columns only one swizzle atom spans N, so LBO is unused too.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of r across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for the P fragments an in-flight wgmma reads
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) · B (128 x 16, smem, K-major)ᵀ
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers) · B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,  // (B, Sq, D)
                       const __grid_constant__ CUtensorMap tk,  // (B, Sk, D)
                       const __grid_constant__ CUtensorMap tv,  // (B, Sk, D)
                       __nv_bfloat16* __restrict__ out,         // (B, Sq, D)
                       const int* __restrict__ pad_len,         // (B,) or null
                       int Sq, int Sk, int D, int causal, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                   cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// (B, S, D) bf16 as a 3-D map read in (64 columns, box_rows rows, 1) boxes,
// 128-byte swizzle, zeros past S
bool make_map(CUtensorMap* map, const void* base, int B, int S, int D, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kHead, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int wtt_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, const void* pad_len, int B, int Sq,
                                   int Sk, int D, int H, int causal, float scale,
                                   void* stream) {
  const cudaError_t rc = cudaFuncSetAttribute(  // per device, so on every call
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, D, kBM) || !make_map(&tk, k, B, Sk, D, kBN) ||
      !make_map(&tv, v, B, Sk, D, kBN))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_attention_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, (const int*)pad_len, Sq, Sk, D, causal,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// flash_attention_bwd: the gradient of the training forward's attention
// (no mask; flash_attn_fwd_lse.cu) from its saved lse, in two launches
// without atomics:
//
//   dQ  kernel: one block per (128-query tile, head, batch row); it walks
//               the key tiles and also writes D = rowsum(dO∘O) (B, H, Sq)
//               f32 for its rows;
//   dKV kernel: one block per (128-key tile, head, batch row); it walks the
//               query tiles, reading D.
//
// With P = exp(S·dh^-0.5 - lse), dP = dO·Vᵀ and dS = P∘(dP - D):
// dQ = dS·K·dh^-0.5, dK = dSᵀ·Q·dh^-0.5, dV = Pᵀ·dO. q/k/v/out/dout f32 or
// bf16; the gradients in the inputs' type. Every block owns its output
// rows, so the result is the same from run to run.
//
// Replaces: the library Pallas kernels _flash_attention_bwd_dkv
//   (jax/experimental/pallas/ops/tpu/flash_attention.py:941, pallas_call at
//   :1121) and _flash_attention_bwd_dq (:1287, pallas_call at :1456), which
//   the JAX package's train_step (whisper_timestamped_tpu/training.py:52)
//   runs through _encoder_attention (models/whisper_jax.py:246) on every
//   encoder layer; the library computes di = rowsum(o·do) in plain JAX
//   (:273-275), here the dQ kernel does.
//
// What bounds it on the H100: operations. The backward's least work is five
// T x T x 64 products a head (S, dP, dV, dQ, dK): 10 * B * H * Sq * Sk * 64
// flops, 57.6 GFLOP at the large-v3 encoder (B=2, T=1500, H=20): 0.058 ms
// in bf16 at 989 TFLOP/s; in f32, 0.86 ms at the CUDA cores' 67 TFLOP/s, or
// three tf32 products each (below) at 495: 0.35 ms. Two passes recompute S
// and dP: dQ does three products, dK/dV four.
//
// Design (Hopper): both kernels are one template. A block owns kBM = 128
// rows (the "row side": keys for dK/dV, queries for dQ), 64 for each of two
// consumer warpgroups, and walks the other side's kBN-row tiles (the
// "column side"). One producer warp loads by TMA: the block's two row-side
// tiles once (K and V, or Q and dO), then each column-side pair (Q and dO,
// or K and V) into a ring of kStages slots, with mbarriers for full and
// empty slots as in flash_attn.cu; for dK/dV its 32 lanes also copy the
// tile's lse (in log2 units) and D into the slot. A warpgroup computes, on
// wgmma with f32 accumulators,
//
//   X = A1·B1ᵀ, Y = A2·B2ᵀ   (S and dP over the head width; transposed
//                            for dK/dV: Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ),
//
// turns them in the accumulator registers into P = exp2(X·scale·log2e -
// lse·log2e) (0 for a column past the column side's end: TMA fills those
// rows with zeros, which do not make P zero) and dS = P∘(Y - D), and feeds
// them back as the register A operand: dQ += dS·K, or dV += Pᵀ·dO and
// dK += dSᵀ·Q, with the streamed tile read along its rows (MN-major).
// Accumulators stay in registers for the whole walk; each thread writes its
// rows once at the end. Nothing of S, P or dS reaches device memory.
//
// bf16 inputs: every tile as TMA wrote it (128-byte swizzle), bf16 wgmma
// m64n64k16; the MN-major reads through the descriptor's transpose bit, so
// no transposed copy exists. P and dS are rounded to bf16 for their
// products, as the library rounds them (flash_attention.py:900, :918,
// :1258); S, dP, D, lse and the sums stay f32. kBN = 64, three ring slots.
//
// f32 inputs: 3xTF32 (flash_tf32.cuh, shared with the forward): each
// product is hi·hi + hi·lo + lo·hi of tf32 parts on tf32 wgmma (m64nNk8),
// summed in f32. The tensor cores add each k-step's sum to the accumulator
// rounded toward zero, so a 1500-row walk (564 k-steps)
// ends ~3e-5 of a gradient's max from float64, where f32 sums rounded to
// nearest give ~3e-6 (tools/torch_kernel_sweeps.py flash-bwd-accuracy).
// PTX takes tf32 operands in shared memory K-major only, so the consumers
// write split copies: the row-side tiles once, as K-major hi and lo tiles;
// each column-side tile as K-major hi and lo (for X, Y) and, where it is
// the B operand of a register-A product, as the hi and lo of its transpose.
// The raw tiles land unswizzled (a 64-float row is wider than the 128-byte
// swizzle); the split copies use the 128-byte swizzle, a 64-float K range as
// two 32-float halves. The tf32 register A fragment takes columns t and t + 4
// of each 8 where the accumulator holds 2t and 2t + 1, so the transposed
// copies store each 8 columns in the order 0 2 4 6 1 3 5 7 and the fragments
// take the accumulator's registers as they are. kBN = 32 and two ring slots,
// which shared memory allows (226 KB).
//
// Ragged ends (1500 = 11 * 128 + 92 rows, 46 * 32 + 28 or 23 * 64 + 28
// columns): TMA fills rows past the end with zeros; P is set to 0 past the
// column side's end, and nothing is written past the row side's end.
//
// What holds it back (H100, the encoder shape, tools/torch_kernel_sweeps.py
// flash-bwd-variants): one block an SM (registers: 168 a thread; f32 also
// shared memory), so two warpgroups hide each other's waits. Removing the
// loads or the exp2s saves a few per cent; removing the register-A
// products frees registers for more blocks an SM and more than halves the
// time. In f32 the split copies cost ~30 % and the S and dP products read
// both operands from shared memory at N = 32.

#include <math.h>

#include <type_traits>

#include "flash_tf32.cuh"

namespace {

using namespace wtt::hopper;
using namespace wtt::tf32;

constexpr int kWGs = 2;                  // consumer warpgroups, 64 rows each
constexpr int kBM = 64 * kWGs;           // row-side rows a block owns
constexpr int kConsumerWarps = 4 * kWGs;
constexpr int kConsumers = 32 * kConsumerWarps;
// + the producer warp. ptxas gives a thread 168 registers (a block of
// three warpgroups' share of the SM's 64K)
constexpr int kThreads = kConsumers + 32;
constexpr float kLog2e = 1.4426950408889634f;

// the consumer warps' own barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// bf16: the tiles as TMA wrote them
// ---------------------------------------------------------------------------

struct Bf16 {
  using T = __nv_bfloat16;
  static constexpr int kBN = 64;  // column-side rows a tile
  static constexpr int kStages = 3;
  struct Smem {  // every tile 1024-byte aligned, as the 128-byte swizzle needs
    T a1[kBM * kHead];  // row side: K (dK/dV) or Q (dQ)
    T a2[kBM * kHead];  // V or dO
    T b1[kStages][kBN * kHead];  // column side: Q or K
    T b2[kStages][kBN * kHead];  // dO or V
    float vec[kStages][2][kBN];  // dK/dV: the tile's lse (log2 units) and D
    uint64_t res_full, full[kStages], empty[kStages];
  };
  struct Frag {  // a 64 x kBN operand as bf16 A fragments, 16 columns a k-step
    uint32_t v[kBN / 16][4];
  };

  // x = A1·B1ᵀ, y = A2·B2ᵀ over the head width (two commit groups): the
  // warpgroup's 64 rows against stage st's kBN columns
  __device__ static void issue_xy(Smem& sm, int st, int wg, float (&x)[kBN / 2],
                                  float (&y)[kBN / 2]) {
    const uint64_t a1 = sw128_desc(sm.a1 + wg * 64 * kHead), a2 = sw128_desc(sm.a2 + wg * 64 * kHead);
    const uint64_t b1 = sw128_desc(sm.b1[st]), b2 = sw128_desc(sm.b2[st]);
#pragma unroll
    for (int kk = 0; kk < kHead / 16; ++kk) wgmma_ss(x, a1 + 2 * kk, b1 + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kHead / 16; ++kk) wgmma_ss(y, a2 + 2 * kk, b2 + 2 * kk, kk > 0);
    wgmma_commit();
  }
  // the accumulator's 64 x kBN values rounded to bf16 as A fragments:
  // k-step kk takes column groups 2kk (rows g, g + 8) and 2kk + 1
  __device__ static void frag(const float (&v)[kBN / 2], Frag& f) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) f.v[kk][r] = pack_bf16(v[8 * kk + 2 * r], v[8 * kk + 2 * r + 1]);
  }
  // acc += F · B, B the kBN x 64 tile as TMA wrote it, read MN-major (16
  // rows, 2048 bytes, a k-step)
  __device__ static void issue_rs(float (&acc)[32], const Frag& f, const T* tile) {
    const uint64_t d = sw128_desc(tile);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) wgmma_rs(acc, f.v[kk], d + 128 * kk, 1);
  }
  // element (r, c) of the second row-side tile (dO, for D)
  __device__ static float a2_at(const Smem& sm, int r, int c) {
    return __bfloat162float(sm.a2[r * kHead + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7))]);
  }
};

// ---------------------------------------------------------------------------
// f32: 3xTF32 from split copies
// ---------------------------------------------------------------------------

struct F32 {
  using T = float;
  static constexpr int kBN = 32;
  static constexpr int kStages = 2;
  struct Split {  // the column-side pair's split copies
    float b1hi[kBN * kHead], b1lo[kBN * kHead], b2hi[kBN * kHead], b2lo[kBN * kHead];
    float b1thi[kHead * kBN], b1tlo[kHead * kBN], b2thi[kHead * kBN], b2tlo[kHead * kBN];
  };
  struct Smem {  // every tile 1024-byte aligned
    // row side, split: each warpgroup's 64 rows a K-major [2][64][32] tile
    float a1hi[kBM * kHead], a1lo[kBM * kHead], a2hi[kBM * kHead], a2lo[kBM * kHead];
    union {
      float raw[2][kBM * kHead];  // the row-side tiles as TMA wrote them, until split
      Split b;
    } w;
    float b1[kStages][kBN * kHead];  // column side as TMA wrote it
    float b2[kStages][kBN * kHead];
    float vec[kStages][2][kBN];
    uint64_t res_full, full[kStages], empty[kStages];
  };
  using Frag = wtt::tf32::Frag<kBN>;

  __device__ static void issue_xy(Smem& sm, int, int wg, float (&x)[kBN / 2],
                                  float (&y)[kBN / 2]) {
    const Split& b = sm.w.b;
    const int a = wg * 64 * kHead;
    issue_ss3<kBN>(x, sm.a1hi + a, sm.a1lo + a, b.b1hi, b.b1lo);
    wgmma_commit();
    issue_ss3<kBN>(y, sm.a2hi + a, sm.a2lo + a, b.b2hi, b.b2lo);
    wgmma_commit();
  }
  __device__ static void frag(const float (&v)[kBN / 2], Frag& f) { to_frag<kBN>(v, f); }
  // acc += F · B, B's transpose split into thi / tlo ([64][kBN], K-major)
  __device__ static void issue_rs(float (&acc)[32], const Frag& f, const float* thi,
                                  const float* tlo) {
    issue_rs3<kBN>(acc, f, thi, tlo);
  }
  __device__ static float a2_at(const Smem& sm, int r, int c) { return sm.w.raw[1][r * kHead + c]; }
};

__device__ __forceinline__ void fence_frag(Bf16::Frag& f) { fence_regs(f.v); }

// X and Y of column tile i (for f32 after its split copies), issued as two
// commit groups
template <typename Tr, bool kDQ, int R>
__device__ __forceinline__ void issue_tile(typename Tr::Smem& sm, int i, int wg, float (&x)[R],
                                           float (&y)[R]) {
  const int st = i % Tr::kStages;
  mbar_wait(&sm.full[st], (i / Tr::kStages) & 1);
  if constexpr (std::is_same<typename Tr::T, float>::value) {
    // every warpgroup is done with the last tile's split copies (and, at
    // the first tile, with the row side's raw rows they overwrite)
    consumers_sync();
    auto& s = sm.w.b;
    constexpr int kBN = Tr::kBN;
    split_rows<kBN>(s.b1hi, s.b1lo, sm.b1[st], threadIdx.x, kConsumers);
    split_rows<kBN>(s.b2hi, s.b2lo, sm.b2[st], threadIdx.x, kConsumers);
    split_cols(s.b1thi, s.b1tlo, sm.b1[st], threadIdx.x, kConsumers);
    if constexpr (!kDQ) split_cols(s.b2thi, s.b2tlo, sm.b2[st], threadIdx.x, kConsumers);
    fence_async_smem();
    consumers_sync();
  }
  wgmma_fence();
  Tr::issue_xy(sm, st, wg, x, y);
}

// the register-A products of tile i: dQ += dS·K, or dV += Pᵀ·dO and
// dK += dSᵀ·Q, one commit group
template <typename Tr, bool kDQ>
__device__ __forceinline__ void issue_rs(typename Tr::Smem& sm, int i, float (&acc1)[32],
                                         float (&acc2)[32], typename Tr::Frag& fp,
                                         typename Tr::Frag& fds) {
  wgmma_fence();
  if constexpr (std::is_same<typename Tr::T, float>::value) {
    const auto& b = sm.w.b;
    if constexpr (kDQ) {
      Tr::issue_rs(acc1, fds, b.b1thi, b.b1tlo);
    } else {
      Tr::issue_rs(acc1, fp, b.b2thi, b.b2tlo);
      Tr::issue_rs(acc2, fds, b.b1thi, b.b1tlo);
    }
  } else {
    const int st = i % Tr::kStages;
    if constexpr (kDQ) {
      Tr::issue_rs(acc1, fds, sm.b1[st]);
    } else {
      Tr::issue_rs(acc1, fp, sm.b2[st]);
      Tr::issue_rs(acc2, fds, sm.b1[st]);
    }
  }
  wgmma_commit();
}

// ---------------------------------------------------------------------------
// The kernel: kDQ for dQ (rows = queries), else dK/dV (rows = keys)
// ---------------------------------------------------------------------------

template <typename Tr, bool kDQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap ta1,  // row side: Q or K (B, Sr, D)
                 const __grid_constant__ CUtensorMap ta2,  // dO or V
                 const __grid_constant__ CUtensorMap tb1,  // column side: K or Q (B, Sc, D)
                 const __grid_constant__ CUtensorMap tb2,  // V or dO
                 const typename Tr::T* __restrict__ o,     // dQ: the forward's out (B, Sq, D)
                 const float* __restrict__ lse,            // (B, H, Sq)
                 float* __restrict__ delta,                // (B, H, Sq): dQ writes, dK/dV reads
                 typename Tr::T* __restrict__ out1,        // dQ, or dV
                 typename Tr::T* __restrict__ out2,        // dK/dV: dK
                 int Sr, int Sc, int D, int H, float scale) {
  using T = typename Tr::T;
  constexpr int kBN = Tr::kBN, kStages = Tr::kStages;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ uint8_t smem_raw[];
  typename Tr::Smem& sm = *reinterpret_cast<typename Tr::Smem*>(align1024(smem_raw));

  const int r0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = (Sc + kBN - 1) / kBN;  // column-side tiles
  const long vrow = ((long)b * H + h) * (kDQ ? Sr : Sc);  // (b, h)'s lse and D

  if (threadIdx.x == 0) {
    mbar_init(&sm.res_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer's lanes
      mbar_init(&sm.empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: lane 0 issues the loads
    void *a1, *a2;
    if constexpr (kF32) {
      a1 = sm.w.raw[0];
      a2 = sm.w.raw[1];
    } else {
      a1 = sm.a1;
      a2 = sm.a2;
    }
    if (lane == 0) {
      mbar_expect_tx(&sm.res_full, 2 * kBM * kHead * sizeof(T));
      tma_load(a1, &ta1, &sm.res_full, h * kHead, r0, b);
      tma_load(a2, &ta2, &sm.res_full, h * kHead, r0, b);
    }
    for (int i = 0; i < n; ++i) {
      const int st = i % kStages, c0 = i * kBN;
      mbar_wait(&sm.empty[st], ((i / kStages) & 1) ^ 1);  // the first round passes
      if constexpr (!kDQ) {
        for (int c = lane; c < kBN; c += 32) {
          const bool in = c0 + c < Sc;
          sm.vec[st][0][c] = in ? lse[vrow + c0 + c] * kLog2e : 0.f;
          sm.vec[st][1][c] = in ? delta[vrow + c0 + c] : 0.f;
        }
      }
      if (lane == 0) {
        mbar_expect_tx(&sm.full[st], 2 * kBN * kHead * sizeof(T));
        tma_load(sm.b1[st], &tb1, &sm.full[st], h * kHead, c0, b);
        tma_load(sm.b2[st], &tb2, &sm.full[st], h * kHead, c0, b);
      } else {
        mbar_arrive(&sm.full[st]);
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns the block's rows 64 wg .. + 63, this
  // thread local rows lr and lr + 8 (the wgmma accumulator layout), columns
  // 8j + 2t + e of each accumulator.
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int lr = wg * 64 + (warp & 3) * 16 + g;
  const int row0 = r0 + lr, row1 = row0 + 8;
  const float scale_log2 = scale * kLog2e;

  mbar_wait(&sm.res_full, 0);
  float lse0 = 0.f, lse1 = 0.f, d0 = 0.f, d1 = 0.f;  // dQ: this thread's rows' lse (log2) and D
  if constexpr (kDQ) {
    // D = rowsum(dO∘O): 16 columns a thread, summed over the row's four threads
    const T* ob = o + (long)b * Sr * D + h * kHead;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int c = 16 * t + j;
      if (row0 < Sr) p0 = fmaf(Tr::a2_at(sm, lr, c), to_f32(ob[(long)row0 * D + c]), p0);
      if (row1 < Sr) p1 = fmaf(Tr::a2_at(sm, lr + 8, c), to_f32(ob[(long)row1 * D + c]), p1);
    }
    d0 = quad_sum(p0);
    d1 = quad_sum(p1);
    if (t == 0) {
      if (row0 < Sr) delta[vrow + row0] = d0;
      if (row1 < Sr) delta[vrow + row1] = d1;
    }
    lse0 = row0 < Sr ? lse[vrow + row0] * kLog2e : 0.f;
    lse1 = row1 < Sr ? lse[vrow + row1] * kLog2e : 0.f;
  }
  if constexpr (kF32) {  // the warpgroup's row-side rows, split once
    const int tid = threadIdx.x & 127;
    split_rows<64>(sm.a1hi + wg * 64 * kHead, sm.a1lo + wg * 64 * kHead,
                   sm.w.raw[0] + wg * 64 * kHead, tid, 128);
    split_rows<64>(sm.a2hi + wg * 64 * kHead, sm.a2lo + wg * 64 * kHead,
                   sm.w.raw[1] + wg * 64 * kHead, tid, 128);
    fence_async_smem();
  }

  float acc1[32], acc2[32];  // dQ, or dV and dK
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = acc2[i] = 0.f;
  float x[kBN / 2], y[kBN / 2];
  typename Tr::Frag fp, fds;

  // A tile's products in order of issue: X, Y, then dV and dK, or dQ. P is
  // taken while Y runs; both fragments are built before the register-A
  // products are issued, which keeps the live registers within the 168 a
  // thread that a block of three warpgroups allows (no spill, and no wgmma
  // serialised by ptxas for want of registers). Issuing a tile's
  // register-A products with the next tile's X and Y measured slower.
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages, c0 = i * kBN;
    issue_tile<Tr, kDQ>(sm, i, wg, x, y);
    wgmma_wait<1>();  // X is in
    fence_regs(x);
    // x <- P
    const bool tail = c0 + kBN > Sc;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float l0 = kDQ ? lse0 : sm.vec[st][0][c], l1 = kDQ ? lse1 : l0;
        const bool live = !tail || c0 + c < Sc;
        x[4 * j + e] = live ? ex2(fmaf(x[4 * j + e], scale_log2, -l0)) : 0.f;
        x[4 * j + 2 + e] = live ? ex2(fmaf(x[4 * j + 2 + e], scale_log2, -l1)) : 0.f;
      }
    }
    wgmma_wait<0>();  // Y is in
    fence_regs(y);
    // y <- dS
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float d0c = kDQ ? d0 : sm.vec[st][1][c], d1c = kDQ ? d1 : d0c;
        y[4 * j + e] = x[4 * j + e] * (y[4 * j + e] - d0c);
        y[4 * j + 2 + e] = x[4 * j + 2 + e] * (y[4 * j + 2 + e] - d1c);
      }
    }
    if constexpr (!kDQ) Tr::frag(x, fp);
    Tr::frag(y, fds);
    issue_rs<Tr, kDQ>(sm, i, acc1, acc2, fp, fds);
    wgmma_wait<0>();
    // keep the products' registers until they are done, then free the slot
    fence_regs(acc1);
    fence_frag(fds);
    if constexpr (!kDQ) {
      fence_regs(acc2);
      fence_frag(fp);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }

  // dQ = acc1·scale; dV = acc1, dK = acc2·scale
  const long base = (long)b * Sr * D + h * kHead;
  const float s1 = kDQ ? scale : 1.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (row0 < Sr) store2(out1 + base + (long)row0 * D + col, acc1[4 * j] * s1, acc1[4 * j + 1] * s1);
    if (row1 < Sr)
      store2(out1 + base + (long)row1 * D + col, acc1[4 * j + 2] * s1, acc1[4 * j + 3] * s1);
    if constexpr (!kDQ) {
      if (row0 < Sr)
        store2(out2 + base + (long)row0 * D + col, acc2[4 * j] * scale, acc2[4 * j + 1] * scale);
      if (row1 < Sr)
        store2(out2 + base + (long)row1 * D + col, acc2[4 * j + 2] * scale,
               acc2[4 * j + 3] * scale);
    }
  }
}

// a1/a2 the row side (B, Sr, D), b1/b2 the column side (B, Sc, D)
template <typename Tr, bool kDQ>
int launch(const void* a1, const void* a2, const void* b1, const void* b2, const void* o,
           const void* lse, void* delta, void* out1, void* out2, int B, int Sr, int Sc, int D,
           int H, float scale, void* stream) {
  using T = typename Tr::T;
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (D != H * kHead || B <= 0 || B > 65535 || H <= 0 || H > 65535 || Sr <= 0 || Sc <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr size_t kSmemBytes = sizeof(typename Tr::Smem) + 1024;  // + room to align the base
  const cudaError_t rc = cudaFuncSetAttribute(  // per device, so on every call
      flash_bwd_kernel<Tr, kDQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  CUtensorMap ta1, ta2, tb1, tb2;
  if (!make_map(&ta1, a1, D, Sr, B, kBM, kF32) || !make_map(&ta2, a2, D, Sr, B, kBM, kF32) ||
      !make_map(&tb1, b1, D, Sc, B, Tr::kBN, kF32) || !make_map(&tb2, b2, D, Sc, B, Tr::kBN, kF32))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sr + kBM - 1) / kBM, H, B);
  flash_bwd_kernel<Tr, kDQ><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      ta1, ta2, tb1, tb2, (const T*)o, (const float*)lse, (float*)delta, (T*)out1, (T*)out2, Sr,
      Sc, D, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wtt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, int B, int Sq, int Sk, int D,
                                          int H, int bf16, float scale, void* stream) {
  return bf16 ? launch<Bf16, true>(q, dout, k, v, o, lse, delta, dq, nullptr, B, Sq, Sk, D, H,
                                   scale, stream)
              : launch<F32, true>(q, dout, k, v, o, lse, delta, dq, nullptr, B, Sq, Sk, D, H,
                                  scale, stream);
}

extern "C" int wtt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int B, int Sq, int Sk, int D,
                                           int H, int bf16, float scale, void* stream) {
  return bf16 ? launch<Bf16, false>(k, v, q, dout, nullptr, lse, const_cast<void*>(delta), dv, dk,
                                    B, Sk, Sq, D, H, scale, stream)
              : launch<F32, false>(k, v, q, dout, nullptr, lse, const_cast<void*>(delta), dv, dk,
                                   B, Sk, Sq, D, H, scale, stream);
}

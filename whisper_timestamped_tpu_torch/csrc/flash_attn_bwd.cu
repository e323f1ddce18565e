// flash_attention_bwd: the gradient of flash_attn_fwd_lse.cu's attention
// (no mask) from its saved lse, in two launches without atomics:
//
//   dQ  kernel: one block per (64-query tile, head, batch row); it walks
//               the key tiles and also writes D = rowsum(dO∘O) (B, H, Sq)
//               f32 for its rows;
//   dKV kernel: one block per (64-key tile, head, batch row); it walks the
//               query tiles, reading D.
//
// With P = exp(S·dh^-0.5 - lse), dP = dO·Vᵀ and dS = P∘(dP - D):
// dQ = dS·K·dh^-0.5, dK = dSᵀ·Q·dh^-0.5, dV = Pᵀ·dO. q/k/v/out/dout f32 or
// bf16, accumulated in f32; the gradients in the inputs' type. Every block
// owns its output rows, so the result is the same from run to run.
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
// flops, 57.6 GFLOP at the large-v3 encoder (B=2, T=1500, H=20), 0.86 ms in
// f32 at 67 TFLOP/s. Two passes recompute S and dP: dQ does three
// products, dK/dV four.
//
// Design: 64 x 64 f32 tiles in shared memory and f32 FMAs on the CUDA cores
// (flash_tile.cuh), as the forward; a simple design, right first, the
// wgmma / TMA design is later work. The ragged tail (1500 = 23 * 64 + 28):
// rows past Sq or Sk are staged as zeros, their P is set to 0, so they add
// nothing, and they are never written.

#include "flash_tile.cuh"

namespace {

using namespace wtt::ftile;

constexpr size_t kSmemBytes = 5 * kTileFloats * sizeof(float) + 2 * kT * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kBlock, 2)  // blocks an SM: shared memory allows 2
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int D, int H, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kTileFloats;
  float* sk = sdo + kTileFloats;
  float* sv = sk + kTileFloats;
  float* sds = sv + kTileFloats;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long qoff = (long)b * Sq * D, koff = (long)b * Sk * D, roff = ((long)b * H + h) * Sq;
  const float scale_log2 = scale * kLog2e;

  load_tile(sq, q + qoff, q0, Sq, D, h);
  load_tile(sdo, dout + qoff, q0, Sq, D, h);
  __syncthreads();
  // this thread's rows: lse in log2 units and D = rowsum(dO∘O)
  float lse2[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    float part = 0.f;
    if (row < Sq) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        part = fmaf(sdo[r * kLd + c], to_f32(o[qoff + (long)row * D + h * kT + c]), part);
      }
    }
    dd[i] = row_sum(part);
    lse2[i] = row < Sq ? lse[roff + row] * kLog2e : 0.f;
    if (tx == 0 && row < Sq) delta[roff + row] = dd[i];
  }

  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < Sk; k0 += kT) {
    __syncthreads();  // the last tile's dS K is done with sk and sds
    load_tile(sk, k + koff, k0, Sk, D, h);
    load_tile(sv, v + koff, k0, Sk, D, h);
    __syncthreads();
    float p[4][4], dp[4][4];
    zero(p);
    zero(dp);
    mma64<true>(p, sq, sk, ty, tx);   // S = Q Kᵀ
    mma64<true>(dp, sdo, sv, ty, tx);  // dP = dO Vᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = k0 + tx + 16 * j < Sk ? exp2f(fmaf(p[i][j], scale_log2, -lse2[i])) : 0.f;
        p[i][j] = pij * (dp[i][j] - dd[i]);  // dS
      }
    put(sds, p, ty, tx);
    __syncthreads();
    mma64<false>(acc, sds, sk, ty, tx);  // dQ += dS K
  }
  write_tile(dq + qoff, acc, scale, q0, Sq, D, h, ty, tx);
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 2)  // blocks an SM: shared memory allows 2
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Sq, int Sk, int D, int H, float scale) {
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kTileFloats;
  float* sq = sv + kTileFloats;
  float* sdo = sq + kTileFloats;
  float* sp = sdo + kTileFloats;  // Pᵀ, then dSᵀ
  float* slse = sp + kTileFloats;  // the query tile's lse (log2 units) and D
  float* sdd = slse + kT;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long qoff = (long)b * Sq * D, koff = (long)b * Sk * D, roff = ((long)b * H + h) * Sq;
  const float scale_log2 = scale * kLog2e;

  load_tile(sk, k + koff, k0, Sk, D, h);
  load_tile(sv, v + koff, k0, Sk, D, h);
  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int q0 = 0; q0 < Sq; q0 += kT) {
    __syncthreads();  // the last tile's dSᵀ Q is done with sq and sp
    load_tile(sq, q + qoff, q0, Sq, D, h);
    load_tile(sdo, dout + qoff, q0, Sq, D, h);
    if (threadIdx.x < kT) {
      const int row = q0 + threadIdx.x;
      slse[threadIdx.x] = row < Sq ? lse[roff + row] * kLog2e : 0.f;
      sdd[threadIdx.x] = row < Sq ? delta[roff + row] : 0.f;
    }
    __syncthreads();
    // rows are keys (ty + 16 i), columns queries (tx + 16 j)
    float pt[4][4], dpt[4][4];
    zero(pt);
    zero(dpt);
    mma64<true>(pt, sk, sq, ty, tx);    // Sᵀ = K Qᵀ
    mma64<true>(dpt, sv, sdo, ty, tx);  // dPᵀ = V dOᵀ
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool live = q0 + c < Sq;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pt[i][j] = live ? exp2f(fmaf(pt[i][j], scale_log2, -slse[c])) : 0.f;
    }
    put(sp, pt, ty, tx);
    __syncthreads();
    mma64<false>(dv_acc, sp, sdo, ty, tx);  // dV += Pᵀ dO
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dj = sdd[tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) pt[i][j] *= dpt[i][j] - dj;  // dSᵀ
    }
    __syncthreads();  // every thread is done reading Pᵀ
    put(sp, pt, ty, tx);
    __syncthreads();
    mma64<false>(dk_acc, sp, sq, ty, tx);  // dK += dSᵀ Q
  }
  write_tile(dk + koff, dk_acc, scale, k0, Sk, D, h, ty, tx);
  write_tile(dv + koff, dv_acc, 1.f, k0, Sk, D, h, ty, tx);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* delta, void* dq, int B, int Sq, int Sk, int D, int H,
              float scale, void* stream) {
  const cudaError_t rc = prepare(flash_bwd_dq_kernel<T>, kSmemBytes, B, Sq, D, H);
  if (rc != cudaSuccess) return (int)rc;
  if (Sk <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + kT - 1) / kT, H, B);
  flash_bwd_dq_kernel<T><<<grid, kBlock, kSmemBytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, (const float*)lse,
      (float*)delta, (T*)dq, Sq, Sk, D, H, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int D, int H,
               float scale, void* stream) {
  const cudaError_t rc = prepare(flash_bwd_dkv_kernel<T>, kSmemBytes, B, Sk, D, H);
  if (rc != cudaSuccess) return (int)rc;
  if (Sq <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((Sk + kT - 1) / kT, H, B);
  flash_bwd_dkv_kernel<T><<<grid, kBlock, kSmemBytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, Sq, Sk, D, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wtt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, int B, int Sq, int Sk, int D,
                                          int H, int bf16, float scale, void* stream) {
  return bf16 ? launch_dq<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, B, Sq, Sk, D, H,
                                         scale, stream)
              : launch_dq<float>(q, k, v, o, dout, lse, delta, dq, B, Sq, Sk, D, H, scale,
                                 stream);
}

extern "C" int wtt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int B, int Sq, int Sk, int D,
                                           int H, int bf16, float scale, void* stream) {
  return bf16 ? launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, D, H,
                                          scale, stream)
              : launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, D, H, scale,
                                  stream);
}

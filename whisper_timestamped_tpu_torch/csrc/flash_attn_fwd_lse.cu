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
// What bounds it on the H100: operations, 4 * B * H * Sq * Sk * 64 flops
// (the two products); in f32 at the large-v3 encoder (B=2, T=1500, H=20)
// 23 GFLOP, 0.34 ms at 67 TFLOP/s against 0.06 ms of bytes.
//
// Design: one block per (64-query tile, head, batch row), 256 threads.
// Q's tile is staged once; each 64-key tile of K and V is staged as f32,
// S = Q Kᵀ and O += P V are f32 FMAs on the CUDA cores (flash_tile.cuh),
// the softmax is online in registers (running max and sum a row, exp2 of
// log2e-scaled scores), and P goes through shared memory to the P V
// product. Keys past Sk get -inf; the ragged tail (1500 = 23 * 64 + 28)
// costs a masked tile. A simple design, right first: no tensor cores
// (their f32 path would round to TF32), no TMA ring; the wgmma design is
// later work.

#include "flash_tile.cuh"

namespace {

using namespace wtt::ftile;

constexpr size_t kSmemBytes = 4 * kTileFloats * sizeof(float);  // Q, K, V, P

template <typename T>
__global__ void __launch_bounds__(kBlock, 3)  // blocks an SM: shared memory allows 3
flash_fwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int D, int H,
                     float scale_log2) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTileFloats;
  float* sv = sk + kTileFloats;
  float* sp = sv + kTileFloats;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + (long)b * Sk * D;
  const T* vb = v + (long)b * Sk * D;

  load_tile(sq, q + (long)b * Sq * D, q0, Sq, D, h);
  float o[4][4], m[4], l[4];
  zero(o);
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kT) {
    __syncthreads();  // the last tile's P V is done with sk, sv and sp
    load_tile(sk, kb, k0, Sk, D, h);
    load_tile(sv, vb, k0, Sk, D, h);
    __syncthreads();
    float s[4][4];
    zero(s);
    mma64<true>(s, sq, sk, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < Sk ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds a key < Sk, so the new max is finite
      const float mn = fmaxf(m[i], row_max(mx));
      const float alpha = exp2f(m[i] - mn);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - mn);
        rs += s[i][j];
        o[i][j] *= alpha;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
    }
    put(sp, s, ty, tx);
    __syncthreads();
    mma64<false>(o, sp, sv, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] *= inv;
    if (tx == 0 && row < Sq) lse[((long)b * H + h) * Sq + row] = m[i] * kLn2 + logf(l[i]);
  }
  write_tile(out + (long)b * Sq * D, o, 1.f, q0, Sq, D, h, ty, tx);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
           int Sk, int D, int H, float scale, void* stream) {
  const cudaError_t rc = prepare(flash_fwd_lse_kernel<T>, kSmemBytes, B, Sq, D, H);
  if (rc != cudaSuccess) return (int)rc;
  if (Sk <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + kT - 1) / kT, H, B);
  flash_fwd_lse_kernel<T><<<grid, kBlock, kSmemBytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, Sq, Sk, D, H,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wtt_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int B, int Sq, int Sk, int D, int H, int bf16,
                                       float scale, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, D, H, scale, stream)
              : launch<float>(q, k, v, out, lse, B, Sq, Sk, D, H, scale, stream);
}

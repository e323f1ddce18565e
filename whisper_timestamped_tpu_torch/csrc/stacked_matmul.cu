// stacked_matmul: x @ w_all[layer]^T for decode shapes, reading the layer's
// weights straight out of the stacked buffer.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:2427
//   stacked_matmul_pallas (kernel _stacked_mm_kernel :2410).
//
// x (B, K) bf16; w_all (L, N, K) bf16, the port's linear layout (out, in),
// where the JAX package stacks (L, K, N); out (B, N) bf16 with
// out[b][n] = sum_k x[b][k] * w_all[layer][n][k], summed in f32 and rounded
// once.
//
// What bounds it on the H100: bytes. At decode batch sizes (B = 1..40) each
// weight is used B times, 2B operations a 2-byte weight, far under the
// ~295 operations a byte at which bf16 tensor-core work would bound it: the
// floor is one layer's N * K * 2 weight bytes over 3.35 TB/s (3.9 us for
// 1280 x 5120).
//
// Design: a weight-streaming GEMV batch. A block of 4 warps takes 16 output
// columns and a group of 8 rows of x (grid: row groups fastest, so the
// blocks that read the same weight rows run together and the later ones find
// them in L2). Each warp owns 4 columns and walks all of K: a lane reads 16
// bytes (8 weights) of each of its 4 columns and 16 bytes of each of the 8
// x rows at the same k (x through the read-only cache: every block of a row
// group reads it), and keeps 4 x 8 f32 sums. A butterfly of 31 warp shuffles
// then reduces the 32 sums across the lanes, leaving lane i with the total
// of sum i, which it writes.

#include "common.cuh"

namespace {

constexpr int kWarpsMM = 4;
constexpr int kCols = 4;   // columns a warp
constexpr int kRows = 8;   // rows of x a block
constexpr int kColsPerBlock = kWarpsMM * kCols;
constexpr int kSums = kCols * kRows;  // 32: one a lane after the reduction

__global__ void __launch_bounds__(kWarpsMM * 32)
stacked_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, int B, int N, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kColsPerBlock + warp * kCols;

  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.f;

  for (int k = lane * 8; k < K; k += 32 * 8) {
    float wf[kCols][8];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (n0 + c < N) {
        wtt::bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(w + (long)(n0 + c) * K + k)),
                           wf[c]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) wf[c][j] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (b0 + r < B) {
        float xf[8];
        wtt::bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(x + (long)(b0 + r) * K + k)), xf);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c * kRows + r] = fmaf(xf[j], wf[c][j], acc[c * kRows + r]);
        }
      }
    }
  }

  // butterfly: at each step a lane keeps one half of its sums (the upper
  // half where its lane bit is set) and adds the partner's copy of that half
#pragma unroll
  for (int off = 16, n = kSums; off >= 1; off >>= 1, n >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? acc[i] : acc[i + n / 2];
      const float keep = upper ? acc[i + n / 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  // lane i now holds sum i: column i / kRows, row i % kRows
  const int c = lane / kRows, r = lane % kRows;
  if (b0 + r < B && n0 + c < N) out[(long)(b0 + r) * N + n0 + c] = __float2bfloat16(acc[0]);
}

}  // namespace

extern "C" int wtt_stacked_matmul(const void* x, const void* w_all, void* out, int layer, int B,
                                  int N, int K, void* stream) {
  const dim3 grid((B + kRows - 1) / kRows, (N + kColsPerBlock - 1) / kColsPerBlock);
  stacked_matmul_kernel<<<grid, kWarpsMM * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w_all + (long)layer * N * K,
      (__nv_bfloat16*)out, B, N, K);
  return (int)cudaGetLastError();
}

// align_cost: batched DTW cost matrices from the alignment heads' scores.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:395
//   attention_to_cost_batched (kernel _cost_kernel_batched :337).
//
// Per segment s, with dims[s] = (n_tokens, span, maxdur_col, start):
//   width-9 median along frames (symmetric reflection at column 0 and at the
//   true span edge, as the JAX wrapper prepares at :404-413), softmax over
//   frames col < span, mean over the K heads, L2 norm of each frame column
//   over the token rows, negate; then cost = 0 at (row < n_tokens - 1,
//   col >= maxdur_col) and cost[0][0] = min(cost). Invalid cells are 0.
//
// What bounds it on the H100: bytes, and the number of blocks. The input is
// S * K * N * M f32 (8 segments, K=10, N=256, M=1536: 126 MB) read once; the
// median network is ~30 min/max per element, far under the compute roof.
//
// Design, three launches on one stream:
//   1. grid (N, S): one block per token row. For each head the row is staged
//      in shared memory with its reflection padding, the median, max, exp and
//      sum run in shared memory, and the per-head softmax adds into a
//      shared-memory accumulator, heads in order 0..K-1 as the TPU kernel
//      does. The row's mean (0 outside the valid extent) goes to ``cost``.
//   2. grid (M / 256, S): one thread per frame column walks the N rows for
//      the L2 norm, then rewrites the column normalised, negated and masked.
//   3. grid (S): a block-wide min over the segment, written to cost[s][0][0].
// expf, not __expf, so the result holds to the plain version at 1e-5.

#include "common.cuh"

namespace {

__device__ __forceinline__ void cx(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// Median of 9 (Paeth's 19-exchange network, the one the TPU kernel uses).
__device__ __forceinline__ float median9(const float* w) {
  float v0 = w[0], v1 = w[1], v2 = w[2], v3 = w[3], v4 = w[4], v5 = w[5],
        v6 = w[6], v7 = w[7], v8 = w[8];
  cx(v1, v2); cx(v4, v5); cx(v7, v8);
  cx(v0, v1); cx(v3, v4); cx(v6, v7);
  cx(v1, v2); cx(v4, v5); cx(v7, v8);
  cx(v0, v3); cx(v5, v8); cx(v4, v7);
  cx(v3, v6); cx(v1, v4); cx(v2, v5);
  cx(v4, v7); cx(v4, v2); cx(v6, v4);
  cx(v4, v2);
  return v4;
}

__global__ void __launch_bounds__(wtt::kThreads)
cost_rows_kernel(const float* __restrict__ scores,  // (S, K, N, M)
                 const int* __restrict__ dims,      // (S, 4)
                 float* __restrict__ cost,          // (S, N, M)
                 int K, int N, int M) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  float* xp = sm;            // M + 8: the reflection-padded row
  float* e = sm + M + 8;     // M: median, then exp
  float* acc = e + M;        // M: sum of the heads' softmax rows
  const int i = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int n_tokens = dims[s * 4 + 0];
  const int span = min(dims[s * 4 + 1], M);
  float* row = cost + ((long)s * N + i) * M;
  if (i >= n_tokens) {
    for (int c = tid; c < M; c += wtt::kThreads) row[c] = 0.f;
    return;
  }
  for (int c = tid; c < M; c += wtt::kThreads) acc[c] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float* x = scores + (((long)s * K + k) * N + i) * M;
    for (int c = tid; c < M; c += wtt::kThreads) xp[4 + c] = x[c];
    __syncthreads();
    if (tid < 4) {
      xp[tid] = x[3 - tid];                          // symmetric at column 0
      xp[4 + span + tid] = x[max(span - 1 - tid, 0)];  // symmetric at span
    }
    __syncthreads();
    float mx = -INFINITY;
    for (int c = tid; c < span; c += wtt::kThreads) {
      const float m9 = median9(xp + c);
      e[c] = m9;
      mx = fmaxf(mx, m9);
    }
    mx = wtt::block_reduce<0>(mx, red);
    float sum = 0.f;
    for (int c = tid; c < span; c += wtt::kThreads) {
      const float ev = expf(e[c] - mx);
      e[c] = ev;
      sum += ev;
    }
    sum = fmaxf(wtt::block_reduce<2>(sum, red), 1e-30f);
    for (int c = tid; c < span; c += wtt::kThreads) acc[c] += e[c] / sum;
    __syncthreads();
  }
  const float inv_k = 1.0f / (float)K;
  for (int c = tid; c < M; c += wtt::kThreads) row[c] = c < span ? acc[c] * inv_k : 0.f;
}

__global__ void __launch_bounds__(wtt::kThreads)
cost_columns_kernel(const int* __restrict__ dims, float* __restrict__ cost,
                    int N, int M) {
  const int s = blockIdx.y;
  const int c = blockIdx.x * wtt::kThreads + threadIdx.x;
  if (c >= M) return;
  const int n_tokens = dims[s * 4 + 0];
  const int span = dims[s * 4 + 1];
  const int maxdur = dims[s * 4 + 2];
  float* col = cost + (long)s * N * M + c;
  float ss = 0.f;
  for (int i = 0; i < N; ++i) {
    const float v = col[(long)i * M];
    ss += v * v;
  }
  const float denom = fmaxf(sqrtf(ss), 1e-30f);
  for (int i = 0; i < N; ++i) {
    const bool valid = c < span && i < n_tokens;
    float v = valid ? -(col[(long)i * M] / denom) : 0.f;
    if (valid && i < n_tokens - 1 && c >= maxdur) v = 0.f;  // max_duration mask
    col[(long)i * M] = v;
  }
}

__global__ void __launch_bounds__(1024)
cost_origin_kernel(float* __restrict__ cost, int N, int M) {
  __shared__ float red[32];
  const int s = blockIdx.x;
  float* seg = cost + (long)s * N * M;
  float mn = INFINITY;
  for (long idx = threadIdx.x; idx < (long)N * M; idx += blockDim.x) mn = fminf(mn, seg[idx]);
  mn = wtt::block_reduce<1>(mn, red);
  if (threadIdx.x == 0) seg[0] = mn;  // encourage the path to start early
}

}  // namespace

extern "C" int wtt_align_cost(const void* scores, const void* dims, void* cost,
                              int S, int K, int N, int M, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(3 * M + 8) * sizeof(float);
  cost_rows_kernel<<<dim3(N, S), wtt::kThreads, smem, st>>>(
      (const float*)scores, (const int*)dims, (float*)cost, K, N, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cost_columns_kernel<<<dim3((M + wtt::kThreads - 1) / wtt::kThreads, S),
                        wtt::kThreads, 0, st>>>((const int*)dims, (float*)cost, N, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cost_origin_kernel<<<S, 1024, 0, st>>>((float*)cost, N, M);
  return (int)cudaGetLastError();
}

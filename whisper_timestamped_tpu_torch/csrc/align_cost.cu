// align_cost and attention_to_cost: DTW cost matrices from the alignment
// heads' scores.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py
//   :395 attention_to_cost_batched (kernel _cost_kernel_batched :337), the
//        batched form (wtt_align_cost);
//   :165 attention_to_cost_pallas (kernel _cost_kernel :137), one segment
//        (wtt_attention_to_cost).
//
// Per segment s, with extent (n_tokens, span):
//   width-9 median along frames (symmetric reflection at column 0 and at the
//   true span edge, as the JAX wrappers prepare at :183-190 and :404-413),
//   softmax over frames col < span, mean over the K heads, L2 norm of each
//   frame column over the token rows, negate. Invalid cells are 0.
// The batched form reads the extents from dims[s] = (n_tokens, span,
// maxdur_col, start) and then edits the weights: cost = 0 at
// (row < n_tokens - 1, col >= maxdur_col) and cost[0][0] = min(cost). The
// one-segment form takes (n_tokens, span) as arguments and edits nothing:
// its caller masks and sets the origin on the host, in float64.
//
// What bounds it on the H100: bytes, and the number of blocks. The input is
// S * K * N * M f32 (batched: 8 segments, K=10, N=256, M=1536: 126 MB; one
// segment with 120 heads, N=224: 165 MB) read once; the median network is
// ~30 min/max per element, far under the compute roof.
//
// Design, two or three launches on one stream:
//   1. grid (N, S): one block per token row. For each head the row is staged
//      in shared memory with its reflection padding, the median, max, exp and
//      sum run in shared memory, and the per-head softmax adds into a
//      shared-memory accumulator, heads in order 0..K-1 as the TPU kernels
//      do. The row's mean (0 outside the valid extent) goes to ``cost``.
//   2. grid (M / 256, S): one thread per frame column walks the N rows for
//      the L2 norm, then rewrites the column normalised, negated and (batched
//      form) masked.
//   3. batched form only, grid (S): a block-wide min over the segment,
//      written to cost[s][0][0].
// expf, not __expf, so the result holds to the plain version at 1e-5.

#include "common.cuh"

namespace {

// A segment's extent: from dims (S, 4) in the batched form; from the launch
// arguments (one segment, no max-duration mask) when dims is null.
struct Extent {
  int n_tokens, span, maxdur;
};

__device__ __forceinline__ Extent extent(const int* dims, int s, int n_tokens, int span, int M) {
  if (dims == nullptr) return {n_tokens, min(span, M), M};
  return {dims[s * 4 + 0], min(dims[s * 4 + 1], M), dims[s * 4 + 2]};
}

__global__ void __launch_bounds__(wtt::kThreads)
cost_rows_kernel(const float* __restrict__ scores,  // (S, K, N, M)
                 const int* __restrict__ dims,      // (S, 4), or null
                 int n_tokens_arg, int span_arg,
                 float* __restrict__ cost,          // (S, N, M)
                 int K, int N, int M) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  float* xp = sm;            // M + 8: the reflection-padded row
  float* e = sm + M + 8;     // M: median, then exp
  float* acc = e + M;        // M: sum of the heads' softmax rows
  const int i = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const Extent ext = extent(dims, s, n_tokens_arg, span_arg, M);
  const int span = ext.span;
  float* row = cost + ((long)s * N + i) * M;
  if (i >= ext.n_tokens) {
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
      const float m9 = wtt::median9(xp + c);
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
cost_columns_kernel(const int* __restrict__ dims, int n_tokens_arg, int span_arg,
                    float* __restrict__ cost, int N, int M) {
  const int s = blockIdx.y;
  const int c = blockIdx.x * wtt::kThreads + threadIdx.x;
  if (c >= M) return;
  const Extent ext = extent(dims, s, n_tokens_arg, span_arg, M);
  float* col = cost + (long)s * N * M + c;
  float ss = 0.f;
  for (int i = 0; i < N; ++i) {
    const float v = col[(long)i * M];
    ss += v * v;
  }
  const float denom = fmaxf(sqrtf(ss), 1e-30f);
  for (int i = 0; i < N; ++i) {
    const bool valid = c < ext.span && i < ext.n_tokens;
    float v = valid ? -(col[(long)i * M] / denom) : 0.f;
    if (valid && i < ext.n_tokens - 1 && c >= ext.maxdur) v = 0.f;  // max_duration mask
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

// Launches 1 and 2 (see the header).
cudaError_t launch_rows_and_columns(const float* scores, const int* dims, int n_tokens, int span,
                                    float* cost, int S, int K, int N, int M, cudaStream_t st) {
  const size_t smem = (size_t)(3 * M + 8) * sizeof(float);
  cost_rows_kernel<<<dim3(N, S), wtt::kThreads, smem, st>>>(scores, dims, n_tokens, span, cost,
                                                            K, N, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cost_columns_kernel<<<dim3((M + wtt::kThreads - 1) / wtt::kThreads, S), wtt::kThreads, 0, st>>>(
      dims, n_tokens, span, cost, N, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wtt_align_cost(const void* scores, const void* dims, void* cost,
                              int S, int K, int N, int M, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_rows_and_columns((const float*)scores, (const int*)dims, 0, 0,
                                            (float*)cost, S, K, N, M, st);
  if (err != cudaSuccess) return (int)err;
  cost_origin_kernel<<<S, 1024, 0, st>>>((float*)cost, N, M);
  return (int)cudaGetLastError();
}

extern "C" int wtt_attention_to_cost(const void* scores, void* cost, int K, int N, int M,
                                     int n_tokens, int span, void* stream) {
  return (int)launch_rows_and_columns((const float*)scores, nullptr, n_tokens, span,
                                      (float*)cost, 1, K, N, M, (cudaStream_t)stream);
}

// dtw_codes: batched anti-diagonal DTW dynamic programme, emitting step codes.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:477
//   dtw_codes_batched (kernel _dtw_kernel_batched :427).
//
// For segment s with true extent (n, m) = dims[s][0:2], cell (i, j) of the
// cost matrix lies on anti-diagonal d = i + j. Walking d = 0 .. n+m-2, each
// cell takes the cheapest of its DIAG (i-1, j-1), LEFT (i, j-1) and UP
// (i-1, j) predecessors, with ties broken exactly as the TPU kernel does
// (strict <, DIAG first, then LEFT, then UP; INF = 3e38) and writes the
// choice to codes[s][d][i] (diagonal-major, the layout the backtrace reads).
// Cells outside the extent carry INF; their codes are written like the TPU
// kernel's. Rows d >= n+m-1 of ``codes`` are not written.
//
// What bounds it on the H100: latency. The diagonals are sequential, so a
// segment is ~n+m dependent steps of one load and a barrier each; the
// S segments run as independent blocks.
//
// Design: one block per segment, one thread per token row i (N <= 1024).
// Three rotating diagonals of g in shared memory, one barrier per diagonal.
// The kernel reads cost[s][i][d-i] directly (the JAX wrapper's skew gather
// is not needed). Only additions touch g, so the sums round exactly as on
// the CPU and the codes match bit for bit.

#include "common.cuh"

namespace {

constexpr int kDiag = 0, kLeft = 1, kUp = 2;
constexpr float kInf = 3e38f;

__global__ void dtw_codes_kernel(const float* __restrict__ cost,  // (S, N, M)
                                 const int* __restrict__ dims,    // (S, 4)
                                 int* __restrict__ codes,         // (S, N+M-1, N)
                                 int N, int M) {
  extern __shared__ float g[];  // 3 diagonals of N
  const int s = blockIdx.x, i = threadIdx.x;
  const int n = min(dims[s * 4 + 0], N);
  const int m = min(dims[s * 4 + 1], M);
  const long D = (long)N + M - 1;
  const float* x = cost + (long)s * N * M + (long)i * M;
  int* out = codes + (long)s * D * N + i;
  g[N + i] = kInf;      // diagonal d = -2
  g[2 * N + i] = kInf;  // diagonal d = -1
  __syncthreads();
  for (int d = 0; d < n + m - 1; ++d) {
    const float* g1 = g + ((d + 2) % 3) * N;  // diagonal d - 1
    const float* g2 = g + ((d + 1) % 3) * N;  // diagonal d - 2
    const int j = d - i;
    const bool valid = j >= 0 && j < m && i < n;
    const float x_d = valid ? x[j] : kInf;
    const float cand_diag = (i >= 1 && j >= 1) ? g2[i - 1] : kInf;
    const float cand_left = j >= 1 ? g1[i] : kInf;
    const float cand_up = i >= 1 ? g1[i - 1] : kInf;
    float best = cand_diag;
    int code = kDiag;
    if (cand_left < best) code = kLeft;
    best = fminf(best, cand_left);
    if (cand_up < best) code = kUp;
    best = fminf(best, cand_up);
    float g_new = (i == 0 && j == 0) ? x_d : __fadd_rn(x_d, best);
    g[(d % 3) * N + i] = valid ? g_new : kInf;
    out[(long)d * N] = code;
    __syncthreads();
  }
}

}  // namespace

extern "C" int wtt_dtw_codes(const void* cost, const void* dims, void* codes,
                             int S, int N, int M, void* stream) {
  dtw_codes_kernel<<<S, N, (size_t)3 * N * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)cost, (const int*)dims, (int*)codes, N, M);
  return (int)cudaGetLastError();
}

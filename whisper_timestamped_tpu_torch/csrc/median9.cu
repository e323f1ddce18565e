// median9: width-9 sliding median along the last axis, symmetric edges.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:114
//   median9_pallas (kernel _median9_kernel :105).
//
// x (R, M) f32 -> out (R, M) f32: out[r][c] is the median of the nine
// values x[r][src(c - 4)] .. x[r][src(c + 4)], where src reflects an index
// outside [0, M) as numpy's "symmetric" padding does (jnp.pad at :121): -1
// reads column 0, M reads column M - 1, repeated for rows shorter than 4.
//
// What bounds it on the H100: bytes. Each input is read once and each output
// written once (8 bytes an element: 330 MB for the 120-head alignment
// scores, (120 * 224, 1536)); the 19 compare-exchanges an output are far
// under the compute roof.
//
// Design: one thread per output element. A block of 256 threads takes 256
// consecutive columns of a row, stages the 264 values they need in shared
// memory with coalesced loads (the 8 halo values are read twice, by two
// neighbouring blocks), then each thread runs Paeth's network (common.cuh)
// on its 9 neighbours. Rows beyond the grid's 65535 are walked in a loop.

#include "common.cuh"

namespace {

__device__ __forceinline__ int reflect(int p, int M) {
  const int period = 2 * M;
  int q = p % period;
  if (q < 0) q += period;
  return q < M ? q : period - 1 - q;
}

__global__ void __launch_bounds__(wtt::kThreads)
median9_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int M) {
  __shared__ float tile[wtt::kThreads + 8];
  const int c0 = blockIdx.x * wtt::kThreads;
  const int c = c0 + threadIdx.x;
  for (long r = blockIdx.y; r < R; r += gridDim.y) {
    const float* row = x + r * M;
    for (int t = threadIdx.x; t < wtt::kThreads + 8; t += wtt::kThreads) {
      tile[t] = row[reflect(c0 + t - 4, M)];
    }
    __syncthreads();
    if (c < M) out[r * M + c] = wtt::median9(tile + threadIdx.x);
    __syncthreads();
  }
}

}  // namespace

extern "C" int wtt_median9(const void* x, void* out, int R, int M, void* stream) {
  const dim3 grid((M + wtt::kThreads - 1) / wtt::kThreads, R < 65535 ? R : 65535);
  median9_kernel<<<grid, wtt::kThreads, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out,
                                                                   R, M);
  return (int)cudaGetLastError();
}

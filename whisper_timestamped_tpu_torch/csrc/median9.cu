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
// scores, (120 * 224, 1536)); the compare-exchanges are far under the
// compute roof.
//
// Design: a thread writes 8 consecutive outputs c0 .. c0 + 7 (c0 a multiple
// of 8) of one row from a register window of the 16 values c0 - 4 ..
// c0 + 11, read as four 16-byte loads (neighbouring threads' windows
// overlap by half: L1 serves the repeats, device memory is read once). The
// median of 9 is Paeth's network's (common.cuh) arithmetic shared between
// neighbours: each triple of consecutive values is sorted once, for the
// three windows that hold it as one of their blocks of three; an output is
// then the median of (the max of its three blocks' lows, the median of
// their middles, the min of their highs): 22.5 min/max operations an output
// where the network alone takes 38. A selection, so the result is the 5th
// smallest value exactly. Threads walk (row, 8-column chunk) pairs in order,
// rows one after another, with no barrier and no shared memory. Only the
// chunks at a row's two ends (c0 < 4 or c0 + 12 > M), and rows that are not
// 16-byte aligned (M % 4 != 0, or an unaligned base), read scalars through
// the reflection; stores are two 16-byte stores where the row allows, else
// scalars.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kOut = 8;  // outputs a thread

__device__ __forceinline__ int reflect(int p, int M) {
  const int period = 2 * M;
  int q = p % period;
  if (q < 0) q += period;
  return q < M ? q : period - 1 - q;
}

__device__ __forceinline__ float med3(float a, float b, float c) {
  return fmaxf(fminf(a, b), fminf(fmaxf(a, b), c));
}

__global__ void __launch_bounds__(kBlock)
median9_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int M, int vec) {
  const int chunks = (M + kOut - 1) / kOut;  // a row's chunks
  const long total = (long)R * chunks;
  for (long i = (long)blockIdx.x * kBlock + threadIdx.x; i < total;
       i += (long)gridDim.x * kBlock) {
    const long r = i / chunks;
    const int c0 = (int)(i - r * chunks) * kOut;
    const float* row = x + r * M;
    float w[kOut + 8];  // w[j] = x[r][c0 - 4 + j]
    if (vec && c0 >= 4 && c0 + kOut + 4 <= M) {
#pragma unroll
      for (int j = 0; j < (kOut + 8) / 4; ++j) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + c0 - 4) + j);
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kOut + 8; ++j) w[j] = __ldg(row + reflect(c0 - 4 + j, M));
    }
    // the sorted triple w[a] <= w[a + 1] <= w[a + 2] as lo, mi, hi
    float lo[kOut + 6], mi[kOut + 6], hi[kOut + 6];
#pragma unroll
    for (int a = 0; a < kOut + 6; ++a) {
      float p = w[a], q = w[a + 1], s = w[a + 2];
      wtt::cx(q, s);
      wtt::cx(p, q);
      wtt::cx(q, s);
      lo[a] = p;
      mi[a] = q;
      hi[a] = s;
    }
    // output c0 + o: the blocks of three at w[o], w[o + 3], w[o + 6]
    float m[kOut];
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const float l = fmaxf(fmaxf(lo[o], lo[o + 3]), lo[o + 6]);
      const float h = fminf(fminf(hi[o], hi[o + 3]), hi[o + 6]);
      m[o] = med3(l, med3(mi[o], mi[o + 3], mi[o + 6]), h);
    }
    float* dst = out + r * M + c0;
    if (vec && c0 + kOut <= M) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(m[0], m[1], m[2], m[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(m[4], m[5], m[6], m[7]);
    } else {
#pragma unroll
      for (int o = 0; o < kOut; ++o)
        if (c0 + o < M) dst[o] = m[o];
    }
  }
}

}  // namespace

extern "C" int wtt_median9(const void* x, void* out, int R, int M, void* stream) {
  if (R <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  // 16-byte rows: M a multiple of 4 and both bases 16-byte aligned
  const int vec = M % 4 == 0 && (((uintptr_t)x | (uintptr_t)out) & 15) == 0;
  const long total = (long)R * ((M + kOut - 1) / kOut);
  const long blocks = (total + kBlock - 1) / kBlock;
  median9_kernel<<<(unsigned)(blocks < (1L << 24) ? blocks : (1L << 24)), kBlock, 0,
                   (cudaStream_t)stream>>>((const float*)x, (float*)out, R, M, vec);
  return (int)cudaGetLastError();
}

// log10_mel: the fused log-mel front end. Frames the reflect-padded audio,
// takes the windowed real DFT, the power spectrum, the mel projection and
// log10(max(mel, 1e-10)), all in f32, in one pass.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:528
//   log10_mel_pallas (kernel _mel_kernel :512).
//
// x (B, L) f32, the audio already reflect-padded by n_fft / 2 on each side;
// cos_b / sin_b (n_fft, n_bins) f32, the windowed DFT bases; mel_w
// (n_mels, n_bins) f32. Frame f reads x[b][f * hop .. f * hop + n_fft); there
// are n_frames = (L - n_fft) / hop frames (whisper drops the STFT's last).
// out (B, n_mels, n_frames) f32, the layout the encoder reads. Whisper's
// max - 8 clamp and (x + 4) / 4, which need the whole row's maximum, are the
// caller's.
//
// What bounds it on the H100: operations. The DFT-matmul formulation (the
// TPU kernel's, and the plain version's) does 2 * n_fft * n_bins * 2 f32
// operations a frame for the real and imaginary parts (321,600 at
// n_fft = 400) against 640 bytes of audio read and 512 bytes of mel written
// (128 mels): ~280 operations a byte, far above the f32 ridge (~20 at
// 67 TFLOP/s over 3.35 TB/s). Plain f32 FMA, no TF32 or bf16.
//
// Design: one block of 256 threads per tile of 64 frames of one row. The
// block stages the tile's span of samples (63 * hop + n_fft floats, 41 KB at
// hop = 160) in shared memory once, so the overlapping frames are never
// copied out as the plain version's framing does. It then walks the bins in
// chunks of 64: the DFT bases of the chunk come through shared memory 16 rows
// at a time, each warp owns 8 frames and each lane 2 bins (cos and sin
// accumulators in registers: 32 a lane), reading a frame's 4 next samples
// with one broadcast 16-byte load. The chunk's power spectrum goes to shared
// memory (64 x n_bins floats, 51 KB): the power spectra never reach device
// memory, as in the TPU kernel. Last, a warp per mel row projects the tile's
// 64 frames (lanes over frames, so the output row is written coalesced),
// over the filter's nonzero bins only (found with a warp min/max), and
// writes log10. ~101 KB of dynamic shared memory a block: two blocks an SM.

#include "common.cuh"

namespace {

constexpr int kTileF = 64;     // frames a block
constexpr int kBinChunk = 64;  // bins a pass: 2 a lane
constexpr int kTChunk = 16;    // basis rows staged at a time
constexpr int kFramesPerWarp = kTileF / wtt::kWarps;  // 8

__host__ __device__ inline int span_floats(int hop, int n_fft) {
  return ((kTileF - 1) * hop + n_fft + 3) & ~3;  // rounded up to 16 bytes
}

__host__ __device__ inline int power_stride(int n_bins) { return n_bins | 1; }  // odd: no bank conflicts

__global__ void __launch_bounds__(wtt::kThreads)
log10_mel_kernel(const float* __restrict__ x, const float* __restrict__ cos_b,
                 const float* __restrict__ sin_b, const float* __restrict__ mel_w,
                 float* __restrict__ out, int L, int n_fft, int n_bins, int n_mels,
                 int n_frames, int hop) {
  extern __shared__ __align__(16) float smem[];
  const int span = span_floats(hop, n_fft), pstride = power_stride(n_bins);
  float* xs = smem;                          // the tile's samples
  float* power = xs + span;                  // (kTileF, pstride)
  float* bc = power + kTileF * pstride;      // (kTChunk, kBinChunk) cos rows
  float* bs = bc + kTChunk * kBinChunk;      // sin rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * kTileF;
  const int nf = min(kTileF, n_frames - f0);

  const long start = (long)f0 * hop;
  const float* src = x + (long)b * L + start;
  const long avail = (long)L - start;
  for (int i = tid; i < span; i += wtt::kThreads) xs[i] = i < avail ? src[i] : 0.f;

  const int fw = warp * kFramesPerWarp;
  for (int k0 = 0; k0 < n_bins; k0 += kBinChunk) {
    float re[kFramesPerWarp][2], im[kFramesPerWarp][2];
#pragma unroll
    for (int j = 0; j < kFramesPerWarp; ++j) re[j][0] = re[j][1] = im[j][0] = im[j][1] = 0.f;
    for (int t0 = 0; t0 < n_fft; t0 += kTChunk) {
      for (int i = tid; i < kTChunk * kBinChunk; i += wtt::kThreads) {
        const int k = k0 + (i % kBinChunk);
        const long at = (long)(t0 + i / kBinChunk) * n_bins + k;
        bc[i] = k < n_bins ? __ldg(cos_b + at) : 0.f;
        bs[i] = k < n_bins ? __ldg(sin_b + at) : 0.f;
      }
      __syncthreads();  // also publishes xs on the first pass
#pragma unroll
      for (int tt = 0; tt < kTChunk; tt += 4) {
        float4 v[kFramesPerWarp];
#pragma unroll
        for (int j = 0; j < kFramesPerWarp; ++j)
          v[j] = *reinterpret_cast<const float4*>(xs + (fw + j) * hop + t0 + tt);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = (tt + u) * kBinChunk;
          const float c0 = bc[row + lane], c1 = bc[row + lane + 32];
          const float s0 = bs[row + lane], s1 = bs[row + lane + 32];
#pragma unroll
          for (int j = 0; j < kFramesPerWarp; ++j) {
            const float s = u == 0 ? v[j].x : (u == 1 ? v[j].y : (u == 2 ? v[j].z : v[j].w));
            re[j][0] = fmaf(s, c0, re[j][0]);
            re[j][1] = fmaf(s, c1, re[j][1]);
            im[j][0] = fmaf(s, s0, im[j][0]);
            im[j][1] = fmaf(s, s1, im[j][1]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kFramesPerWarp; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + lane + 32 * h;
        if (k < n_bins) {
          const float r = re[j][h], i = im[j][h];
          power[(fw + j) * pstride + k] = __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i));
        }
      }
    }
  }
  __syncthreads();

  for (int m = warp; m < n_mels; m += wtt::kWarps) {
    const float* wrow = mel_w + (long)m * n_bins;
    int lo = n_bins, hi = -1;
    for (int k = lane; k < n_bins; k += 32) {
      if (__ldg(wrow + k) != 0.f) {
        lo = min(lo, k);
        hi = max(hi, k);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    float a0 = 0.f, a1 = 0.f;
    for (int k = lo; k <= hi; ++k) {
      const float w = __ldg(wrow + k);
      a0 = fmaf(w, power[lane * pstride + k], a0);
      a1 = fmaf(w, power[(lane + 32) * pstride + k], a1);
    }
    float* orow = out + ((long)b * n_mels + m) * n_frames + f0;
    if (lane < nf) orow[lane] = log10f(fmaxf(a0, 1e-10f));
    if (lane + 32 < nf) orow[lane + 32] = log10f(fmaxf(a1, 1e-10f));
  }
}

}  // namespace

extern "C" int wtt_log10_mel(const void* x, const void* cos_b, const void* sin_b,
                             const void* mel_w, void* out, int B, int L, int n_fft, int n_bins,
                             int n_mels, int hop, void* stream) {
  const int n_frames = (L - n_fft) / hop;
  const int smem = (span_floats(hop, n_fft) + kTileF * power_stride(n_bins) +
                    2 * kTChunk * kBinChunk) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(log10_mel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + kTileF - 1) / kTileF, B);
  log10_mel_kernel<<<grid, wtt::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)cos_b, (const float*)sin_b, (const float*)mel_w,
      (float*)out, L, n_fft, n_bins, n_mels, n_frames, hop);
  return (int)cudaGetLastError();
}

// log10_mel: the fused log-mel front end. Frames the reflect-padded audio,
// takes the windowed real DFT, the power spectrum, the mel projection and
// log10(max(mel, 1e-10)), all in f32, in one pass.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py:528
//   log10_mel_pallas (kernel _mel_kernel :512).
//
// x (B, L) f32, the audio already reflect-padded by n_fft / 2 on each side;
// tw (n_fft) float2, the twiddles exp(-2 pi i m / n_fft) (computed in
// float64 on the host and rounded, ops.kernels.mel_fft_plan); window
// (n_fft) f32, the periodic Hann window (the plan's, computed the same
// way); cos_b / sin_b (n_fft, n_bins) f32, the plain version's windowed
// DFT bases, and bases_t (2, n_bins, n_fft) f32, the same transposed (a
// bin's cos and sin rows contiguous), for the refinement; mel_w (n_mels,
// n_bins) f32; the radices of the FFT's passes (the plan's); refine_below,
// the share of its frame's largest power under which a bin is refined.
// Frame f reads x[b][f * hop .. f * hop + n_fft); there are n_frames =
// (L - n_fft) / hop frames (whisper drops the STFT's last). out (B, n_mels,
// n_frames) f32, the layout the encoder reads. Whisper's max - 8 clamp and
// (x + 4) / 4, which need the whole row's maximum, are the caller's.
//
// What bounds it on the H100: bytes, with a fast transform. The TPU
// kernel's (and the plain version's) DFT-matmul formulation does
// 4 * n_fft * n_bins f32 operations a frame (321,600 at n_fft = 400), ~35x
// the least work; an FFT does a few thousand, under the 640 bytes of audio
// read and 512 bytes of mel written (128 mels) at the f32 rate.
//
// Design: the real n_fft-point transform as an N = n_fft / 2-point complex
// one (even samples real, odd imaginary), split into the n_bins real-signal
// bins after: X[k] = Fe[k] + W^k Fo[k] and X[N - k] = conj(Fe[k] - W^k
// Fo[k]), Fe and Fo the even and odd samples' transforms, both taken from
// Z[k] and Z[N - k]. The complex transform is a Stockham (self-sorting,
// natural-order) mixed-radix FFT, one pass a radix (the odd ones first,
// 5, 5, 8 at n_fft = 400), each pass reading one shared-memory buffer and
// writing the other; an odd first pass reads the staged samples itself.
// A block of 16 warps takes a tile of 32 frames of one row, one frame a
// lane: a warp walks the butterflies of a pass for its 32 frames at once,
// so the index and twiddle arithmetic is the warp's, the twiddle reads are
// broadcasts, and a frame's buffer row of N | 1 (odd) complex values puts
// the 32 frames' same element on distinct banks. The tile's span of
// samples is staged once from device memory by cp.async while the previous
// tile's mel sums run (the overlapping frames are never re-read from it),
// then framed and windowed in shared memory. The power
// spectra stay in shared memory; a warp a mel filter projects the 32
// frames over the filter's nonzero bins (found once per block, their
// weights kept in shared memory) and writes 32 consecutive frames of the
// output row. The grid is persistent: as many blocks as are resident, each
// walking tiles, so the twiddles, window and filters are loaded once a
// block. ~111 KB of shared memory a block at n_fft = 400 (two an SM).
//
// Refinement: an f32 FFT's rounding error in a bin is a share of the
// frame's largest bin, not of the bin itself (the loud bins' rounding
// reaches every output through the later passes), so a bin many decades
// below its frame's peak, a spectral null or the quiet side of a tone,
// keeps few correct digits. There the DFT product's own rounding differs
// as much: at [g]'s stack and the 10-minute stream of chip_smoke.py, the
// plain version is itself up to 4e-4 in log10 from a float64 FFT, so no
// other f32 formulation can hold to it at 2e-4 on such cells. The kernel
// recomputes every bin whose FFT power is below refine_below times its
// frame's largest (1e-6 by default: about 0.1 % of the bins of the
// smoke's tone-and-noise rows; most of those of a spectrum that falls many
// decades, as speech's top band does) the plain version's way: the real
// and imaginary sums of the frame's samples times the bases in sample
// order by fmaf from zero (the order in which cuBLAS's SGEMM sums the
// plain version's product on the H100: the DFT-matmul kernel this one
// replaced summed so and matched it bit for bit), then the power rounded
// as the plain version's elementwise products. Up to kRefineCap bins a
// tile (refine_sparse), a warp takes a bin: it stages the frame's samples
// (device memory, L2: the tile was staged a moment before) and the bin's
// basis rows (bases_t, contiguous) in a slot of the buffers' free tails,
// and one lane sums, while the next tile's samples are on their way.
// Beyond that (refine_dense) the tile's whole DFT product is taken again
// as the DFT-matmul kernel took it (basis rows staged in shared memory and
// shared by the tile's frames): a tile then costs its FFT plus that
// kernel's work. tools/torch_kernel_sweeps.py mel, mel-refine and
// mel-refine-variants measure both paths.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTileF = 32;  // frames a tile: one a lane
constexpr int kMelThreads = 512;  // 16 warps: two blocks an SM fill its registers at 64 a thread
constexpr int kMelWarps = kMelThreads / 32;
// the filters' nonzero weights kept in shared memory when they fit (whisper's
// 80 or 128 filters at n_fft = 400 or 512 have 391 to 504); else they are
// read from device memory
constexpr int kMelWeights = 1024;
constexpr int kMaxStages = 16;
// a tile's refined bins taken one by one (a warp each) up to this many;
// beyond it the tile's whole DFT product is taken again (see Refinement)
constexpr int kRefineCap = 64;
constexpr int kDenseBins = 128;  // the dense refinement's bins a pass: 2 a lane, 2 warps across
constexpr int kDenseRows = 16;   // basis rows it stages at a time

// the radices of the passes, 4 bits each, pass 0 lowest
__device__ __forceinline__ int radix(unsigned long long plan, int s) {
  return (int)((plan >> (4 * s)) & 15);
}

// floats of each of the two work buffers: the staged span, two complex
// buffers of kTileF rows of N | 1 values, or the power spectra (kTileF
// rows of n_bins | 1), whichever is largest, rounded up to 16 bytes
__host__ __device__ inline int buffer_floats(int n_fft, int n_bins, int hop) {
  const int fs = (n_fft / 2) | 1, span = (kTileF - 1) * hop + n_fft;
  int n = 2 * kTileF * fs;
  n = span > n ? span : n;
  n = kTileF * (n_bins | 1) > n ? kTileF * (n_bins | 1) : n;
  // the refinement, in the buffers' tails (the next tile's span staged at
  // the head of one, the power spectra at the head of the other): the span
  // again after the spectra, the basis rows after the staged span
  const int span4 = (span + 3) & ~3, spectra = (kTileF * (n_bins | 1) + 3) & ~3;
  n = spectra + span4 > n ? spectra + span4 : n;
  n = span4 + 2 * kDenseRows * kDenseBins > n ? span4 + 2 * kDenseRows * kDenseBins : n;
  return (n + 3) & ~3;
}

// the tables before the buffers: twiddles (2 n_fft), window (n_fft), each
// filter's (lo, hi, offset of its weights, 0) and the filters' nonzero
// weights, each table rounded up to 16 bytes
__host__ __device__ inline int table_floats(int n_fft, int n_mels) {
  return ((3 * n_fft + 3) & ~3) + 4 * n_mels + kMelWeights;
}

__host__ __device__ inline int smem_floats(int n_fft, int n_bins, int n_mels, int hop) {
  return table_floats(n_fft, n_mels) + 2 * buffer_floats(n_fft, n_bins, hop);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
// a * -i
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }

// v <- its R-point DFT, v'[q] = sum_r v[r] exp(-2 pi i r q / R)
template <int R>
__device__ __forceinline__ void dft(float2* v);

template <>
__device__ __forceinline__ void dft<2>(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<3>(float2* v) {
  const float c = -0.5f, s = 0.86602540378443865f;  // cos, sin of 2 pi / 3
  const float2 a = cadd(v[1], v[2]), d = csub(v[1], v[2]);
  const float2 t = make_float2(v[0].x + c * a.x, v[0].y + c * a.y);
  const float2 u = mul_mi(make_float2(s * d.x, s * d.y));
  v[0] = cadd(v[0], a);
  v[1] = cadd(t, u);
  v[2] = csub(t, u);
}

template <>
__device__ __forceinline__ void dft<4>(float2* v) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<5>(float2* v) {
  // cos and sin of 2 pi / 5 and 4 pi / 5
  const float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;
  const float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;
  const float2 a1 = cadd(v[1], v[4]), b1 = csub(v[1], v[4]);
  const float2 a2 = cadd(v[2], v[3]), b2 = csub(v[2], v[3]);
  const float2 x0 = v[0];
  const float2 p1 = make_float2(x0.x + c1 * a1.x + c2 * a2.x, x0.y + c1 * a1.y + c2 * a2.y);
  const float2 p2 = make_float2(x0.x + c2 * a1.x + c1 * a2.x, x0.y + c2 * a1.y + c1 * a2.y);
  const float2 q1 = mul_mi(make_float2(s1 * b1.x + s2 * b2.x, s1 * b1.y + s2 * b2.y));
  const float2 q2 = mul_mi(make_float2(s2 * b1.x - s1 * b2.x, s2 * b1.y - s1 * b2.y));
  v[0] = cadd(x0, cadd(a1, a2));
  v[1] = cadd(p1, q1);
  v[4] = csub(p1, q1);
  v[2] = cadd(p2, q2);
  v[3] = csub(p2, q2);
}

template <>
__device__ __forceinline__ void dft<8>(float2* v) {
  const float h = 0.70710678118654752f;  // sqrt(1/2)
  float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  o[1] = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));   // * exp(-i pi / 4)
  o[2] = mul_mi(o[2]);                                                // * -i
  o[3] = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));  // * exp(-3 i pi / 4)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = cadd(e[q], o[q]);
    v[q + 4] = csub(e[q], o[q]);
  }
}

// One Stockham pass of radix R over the tile's 32 frames (frame = lane;
// frame rows fs complex values apart) after passes whose radices multiply
// to ns: butterfly j takes elements j + r N / R, twiddles them by
// W_{ns R}^{(j mod ns) r} (= tw[(j mod ns) r n_fft / (ns R)]) and writes
// its DFT to (j - j mod ns) R + j mod ns + r ns.
template <int R>
__device__ __forceinline__ void fft_pass(const float2* __restrict__ src, float2* __restrict__ dst,
                                         const float2* __restrict__ tw, int N, int fs, int ns,
                                         int n_fft, int lane, int warp) {
  const int Q = N / R, step = n_fft / (ns * R);
  src += lane * fs;
  dst += lane * fs;
  for (int j = warp; j < Q; j += kMelWarps) {
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[j + r * Q];
    if (k > 0) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[k * r * step]);
    }
    dft<R>(v);
    const int base = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[base + r * ns] = v[r];
  }
}

// The first Stockham pass (ns = 1, no twiddles) of an odd radix R, read
// from the tile's staged samples with the window applied: here a lane
// takes a butterfly j of one frame, so the samples are read along the
// span (16-byte pairs, consecutive lanes adjacent) and the outputs written
// R complex values apart (R odd: no bank conflicts). It replaces the
// framing copy and one pass through shared memory.
template <int R>
__device__ __forceinline__ void first_pass(const float* __restrict__ span,
                                           const float2* __restrict__ win2,
                                           float2* __restrict__ dst, int N, int fs, int hop,
                                           int tid) {
  const int Q = N / R;
  for (int f = tid / Q, j = tid % Q; f < kTileF;) {  // butterfly f * Q + j, every 512th
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = j + r * Q;
      const float2 x = *reinterpret_cast<const float2*>(span + f * hop + 2 * m), w = win2[m];
      v[r] = make_float2(x.x * w.x, x.y * w.y);
    }
    dft<R>(v);
#pragma unroll
    for (int r = 0; r < R; ++r) dst[f * fs + j * R + r] = v[r];
    for (j += kMelThreads; j >= Q; j -= Q) ++f;
  }
}

// The refinement (see the header), out of line so that its registers do
// not weigh on the FFT's. Both are called by the whole block and end with a
// barrier. src: the tile's first sample; power: the (kTileF, ps) spectra.

// Many bins: the tile's whole DFT product again, the DFT-matmul kernel's
// way: the span staged again in tail_b, basis rows (kDenseRows at a time,
// kDenseBins bins) in tail_a; a warp takes 4 frames and 64 bins, 2 a lane,
// the frames' samples broadcast.
__device__ __noinline__ void refine_dense(const float* __restrict__ src, long avail,
                                          const float* __restrict__ cos_b,
                                          const float* __restrict__ sin_b, float* power,
                                          float* tail_a, float* tail_b, int n_fft, int n_bins,
                                          int ps, int hop, int span) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* xs = tail_b;
  for (int i = tid; i < span; i += kMelThreads) xs[i] = i < avail ? __ldg(src + i) : 0.f;
  float* bc = tail_a;                        // (kDenseRows, kDenseBins) cos rows
  float* bs = bc + kDenseRows * kDenseBins;  // and sin rows
  const int fw = (warp & 7) * 4, kw = (warp >> 3) * 64 + lane;
  for (int c0 = 0; c0 < n_bins; c0 += kDenseBins) {
    float re[4][2], im[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) re[j][0] = re[j][1] = im[j][0] = im[j][1] = 0.f;
    for (int t0 = 0; t0 < n_fft; t0 += kDenseRows) {
      const int rows = min(kDenseRows, n_fft - t0);
      __syncthreads();  // the last rows are read (first: the span is written)
      for (int i = tid; i < rows * kDenseBins; i += kMelThreads) {
        const int k = c0 + (i % kDenseBins);
        const long at = (long)(t0 + i / kDenseBins) * n_bins + k;
        bc[i] = k < n_bins ? __ldg(cos_b + at) : 0.f;
        bs[i] = k < n_bins ? __ldg(sin_b + at) : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < rows; ++r) {
        const float ca = bc[r * kDenseBins + kw], cb = bc[r * kDenseBins + kw + 32];
        const float sa = bs[r * kDenseBins + kw], sb = bs[r * kDenseBins + kw + 32];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = xs[(fw + j) * hop + t0 + r];
          re[j][0] = fmaf(v, ca, re[j][0]);
          re[j][1] = fmaf(v, cb, re[j][1]);
          im[j][0] = fmaf(v, sa, im[j][0]);
          im[j][1] = fmaf(v, sb, im[j][1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = c0 + kw + 32 * h;
        if (k < n_bins)
          power[(fw + j) * ps + k] =
              __fadd_rn(__fmul_rn(re[j][h], re[j][h]), __fmul_rn(im[j][h], im[j][h]));
      }
    }
  }
  __syncthreads();
}

// Few bins: a warp a bin (list: frame * n_bins + bin), its frame's samples
// and its bin's two basis rows (bases_t: contiguous) staged in the warp's
// slot of the tails (slots_a in tail_a, the rest in tail_b), then one
// lane's sums in sample order.
__device__ __noinline__ void refine_sparse(const float* __restrict__ src,
                                           const float* __restrict__ bases_t, const int* list,
                                           int n_ref, float* power, float* tail_a, float* tail_b,
                                           int slots_a, int n_slots, int n_fft, int n_bins, int ps,
                                           int hop) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n4 = (n_fft + 3) & ~3;
  float* xs = warp < slots_a ? tail_a + warp * 3 * n4 : tail_b + (warp - slots_a) * 3 * n4;
  for (int e = warp; warp < n_slots && e < n_ref; e += n_slots) {
    const int f = list[e] / n_bins, k = list[e] - f * n_bins;
    const float* xf = src + (long)f * hop;
    const float* cb = bases_t + (long)k * n_fft;
    const float* sb = cb + (long)n_bins * n_fft;
    for (int i = lane; i < n_fft; i += 32) {
      xs[i] = __ldg(xf + i);
      xs[n4 + i] = __ldg(cb + i);
      xs[2 * n4 + i] = __ldg(sb + i);
    }
    __syncwarp();
    if (lane == 0) {
      float re = 0.f, im = 0.f;
#pragma unroll 8
      for (int j = 0; j < n_fft; ++j) {
        re = fmaf(xs[j], xs[n4 + j], re);
        im = fmaf(xs[j], xs[2 * n4 + j], im);
      }
      power[f * ps + k] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
    }
    __syncwarp();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kMelThreads, 2)
log10_mel_kernel(const float* __restrict__ x, const float2* __restrict__ tw_g,
                 const float* __restrict__ win_g, const float* __restrict__ cos_b,
                 const float* __restrict__ sin_b, const float* __restrict__ bases_t,
                 const float* __restrict__ mel_w, float* __restrict__ out,
                 unsigned long long plan, int n_stages, int L, int n_fft, int n_bins, int n_mels,
                 int n_frames, int hop, int tiles_per_row, int n_tiles, float refine_below) {
  extern __shared__ __align__(16) float smem[];
  const int N = n_fft / 2, fs = N | 1, ps = n_bins | 1;
  const int span = (kTileF - 1) * hop + n_fft, nbuf = buffer_floats(n_fft, n_bins, hop);
  float2* tw = reinterpret_cast<float2*>(smem);                 // n_fft twiddles
  float* win = smem + 2 * n_fft;                                // n_fft window values
  int4* range = reinterpret_cast<int4*>(smem + ((3 * n_fft + 3) & ~3));  // (lo, hi, offset, 0)
  float* wts = reinterpret_cast<float*>(range + n_mels);        // the filters' nonzero weights
  float* buf0 = smem + table_floats(n_fft, n_mels);
  float* buf1 = buf0 + nbuf;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n_fft; i += kMelThreads) {
    tw[i] = tw_g[i];
    win[i] = win_g[i];
  }
  for (int m = warp; m < n_mels; m += kMelWarps) {
    const float* wrow = mel_w + (long)m * n_bins;
    int lo = n_bins, hi = -1;
    for (int k = lane; k < n_bins; k += 32) {
      if (wrow[k] != 0.f) {
        lo = min(lo, k);
        hi = max(hi, k);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) range[m] = make_int4(lo, hi, 0, 0);
  }
  __syncthreads();
  __shared__ int n_weights;
  __shared__ int peak[kTileF];  // each frame's largest power (its bits: powers are >= 0)
  __shared__ int n_refine, refine_list[kRefineCap];  // the tile's refined bins, frame * n_bins + bin
  if (tid == 0) {  // each filter's offset in wts
    int off = 0;
    for (int m = 0; m < n_mels; ++m) {
      range[m].z = off;
      off += max(range[m].y - range[m].x + 1, 0);
    }
    n_weights = off;
  }
  __syncthreads();
  const bool staged = n_weights <= kMelWeights;
  if (staged) {
    for (int m = warp; m < n_mels; m += kMelWarps) {
      const int4 r = range[m];
      for (int k = r.x + lane; k <= r.y; k += 32) wts[r.z + k - r.x] = mel_w[(long)m * n_bins + k];
    }
  }

  // tile t's span of samples into buf, zeros past the row's end: every
  // copy issued at once (cp.async), waited for at the top of the tile
  auto stage = [&](int t, float* buf) {
    const long start = (long)(t % tiles_per_row) * kTileF * hop;
    const float* src = x + (long)(t / tiles_per_row) * L + start;
    const long avail = (long)L - start;
    for (int i = tid; i < span; i += kMelThreads) {
      if (i < avail) {
        cp_async4(buf + i, src + i);
      } else {
        buf[i] = 0.f;
      }
    }
    cp_async_commit();
  };
  // the two buffers swap roles from tile to tile: the tile's samples are
  // staged in sbuf while the last tile's mel sums run
  float *sbuf = buf1, *zbuf = buf0;
  if (blockIdx.x < n_tiles) stage(blockIdx.x, sbuf);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_row, f0 = (t % tiles_per_row) * kTileF;
    cp_async_wait_all();
    // the samples are in and every warp is done with the last tile (on the
    // first tile: the tables are published)
    __syncthreads();
    if (tid < kTileF) peak[tid] = 0;
    if (tid == 0) n_refine = 0;
    // frame f's windowed samples as N complex values (even real, odd
    // imaginary) into zbuf: through the first pass when its radix is odd
    // (fused), else copied as they are for it
    const float2* win2 = reinterpret_cast<const float2*>(win);
    float2* z = reinterpret_cast<float2*>(zbuf);
    const int r0 = radix(plan, 0);
    int s0 = 0;
    switch (r0) {
      case 3: first_pass<3>(sbuf, win2, z, N, fs, hop, tid); s0 = 1; break;
      case 5: first_pass<5>(sbuf, win2, z, N, fs, hop, tid); s0 = 1; break;
      default:
        for (int f = tid / N, m = tid % N; f < kTileF;) {  // element f * N + m, every 512th
          const float2 v = *reinterpret_cast<const float2*>(sbuf + f * hop + 2 * m), w = win2[m];
          z[f * fs + m] = make_float2(v.x * w.x, v.y * w.y);
          for (m += kMelThreads; m >= N; m -= N) ++f;
        }
    }
    __syncthreads();

    float2 *from = z, *to = reinterpret_cast<float2*>(sbuf);
    for (int s = s0, ns = s0 ? r0 : 1; s < n_stages; ++s) {
      const int R = radix(plan, s);
      switch (R) {
        case 2: fft_pass<2>(from, to, tw, N, fs, ns, n_fft, lane, warp); break;
        case 3: fft_pass<3>(from, to, tw, N, fs, ns, n_fft, lane, warp); break;
        case 4: fft_pass<4>(from, to, tw, N, fs, ns, n_fft, lane, warp); break;
        case 5: fft_pass<5>(from, to, tw, N, fs, ns, n_fft, lane, warp); break;
        default: fft_pass<8>(from, to, tw, N, fs, ns, n_fft, lane, warp); break;
      }
      __syncthreads();
      ns *= R;
      float2* swap = from;
      from = to;
      to = swap;
    }

    // the real signal's power spectrum, from Z[k] and Z[N - k]
    const float2* Z = from + lane * fs;
    float* power = reinterpret_cast<float*>(to);  // (kTileF, ps)
    float* p = power + lane * ps;
    int top = 0;
    for (int k = warp; k <= N / 2; k += kMelWarps) {
      const float2 a = Z[k], c = Z[k == 0 ? 0 : N - k];
      const float2 fe = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
      const float2 fo = make_float2(0.5f * (a.y + c.y), 0.5f * (c.x - a.x));
      const float2 u = cmul(tw[k], fo);
      const float re0 = fe.x + u.x, im0 = fe.y + u.y, re1 = fe.x - u.x, im1 = fe.y - u.y;
      const float p0 = re0 * re0 + im0 * im0, p1 = re1 * re1 + im1 * im1;
      p[k] = p0;
      if (N - k != k) p[N - k] = p1;
      top = max(top, __float_as_int(p0));
      if (N - k != k) top = max(top, __float_as_int(p1));
    }
    atomicMax(peak + lane, top);
    __syncthreads();
    // the bins to refine: below refine_below of their frame's largest power
    const bool live = f0 + lane < n_frames;
    if (live) {
      const float at = __int_as_float(peak[lane]) * refine_below;
      for (int k = warp; k < n_bins; k += kMelWarps) {
        if (p[k] < at) {
          const int i = atomicAdd(&n_refine, 1);
          if (i < kRefineCap) refine_list[i] = lane * n_bins + k;
        }
      }
    }
    __syncthreads();
    // the spectrum's buffer is free: the next tile's samples go to its head
    if (t + gridDim.x < n_tiles) stage(t + gridDim.x, reinterpret_cast<float*>(from));
    const int n_ref = n_refine, span4 = (span + 3) & ~3, spectra = (kTileF * ps + 3) & ~3;
    float* tail_a = reinterpret_cast<float*>(from) + span4;  // free: nbuf - span4 floats
    float* tail_b = reinterpret_cast<float*>(to) + spectra;  // free: nbuf - spectra floats
    // the sparse refinement's slots: a frame's samples and a bin's two basis rows
    const int n4 = (n_fft + 3) & ~3, slots_a = (nbuf - span4) / (3 * n4);
    const int n_slots = min(kMelWarps, slots_a + (nbuf - spectra) / (3 * n4));
    if (n_ref > kRefineCap || (n_ref > 0 && n_slots == 0)) {
      refine_dense(x + (long)b * L + (long)f0 * hop, L - (long)f0 * hop, cos_b, sin_b, power, tail_a,
                   tail_b, n_fft, n_bins, ps, hop, span);
    } else if (n_ref > 0) {
      refine_sparse(x + (long)b * L + (long)f0 * hop, bases_t, refine_list, n_ref, power, tail_a,
                    tail_b, slots_a, n_slots, n_fft, n_bins, ps, hop);
    }

    // a warp a mel filter, a lane a frame: 32 consecutive frames of the row
    for (int m = warp; m < n_mels; m += kMelWarps) {
      int4 r = range[m];
      // weight k of the filter: from shared memory (a broadcast) or device memory
      const float* wrow = staged ? wts + r.z - r.x : mel_w + (long)m * n_bins;
      float a[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, so the weights' loads overlap
      int k = r.x;
      for (; k + 3 <= r.y; k += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = fmaf(wrow[k + u], p[k + u], a[u]);
      }
      for (; k <= r.y; ++k) a[0] = fmaf(wrow[k], p[k], a[0]);
      const float acc = (a[0] + a[1]) + (a[2] + a[3]);
      // the fast log10 (log2 times log10 2): within ~1e-6 of log10f
      if (live) out[((long)b * n_mels + m) * n_frames + f0 + lane] = __log10f(fmaxf(acc, 1e-10f));
    }
    sbuf = reinterpret_cast<float*>(from);
    zbuf = reinterpret_cast<float*>(to);
  }
}

}  // namespace

// radices: host array of the plan's n_stages radices (each 2, 3, 4, 5 or
// 8, their product n_fft / 2). Returns cudaErrorInvalidValue, launching
// nothing, for what the kernel does not take: a plan that is not one, hop
// not a multiple of 4, or tables and buffers (smem_floats) beyond the
// device's shared memory a block.
extern "C" int wtt_log10_mel(const void* x, const void* tw, const void* window,
                             const void* cos_b, const void* sin_b, const void* bases_t,
                             const void* mel_w, void* out,
                             const int* radices, int n_stages, int B, int L, int n_fft,
                             int n_bins, int n_mels, int hop, float refine_below, void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || n_fft % 2 || n_bins != n_fft / 2 + 1 ||
      hop <= 0 || hop % 4)
    return (int)cudaErrorInvalidValue;
  long prod = 1;
  unsigned long long plan = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8) return (int)cudaErrorInvalidValue;
    plan |= (unsigned long long)r << (4 * s);
    prod *= r;
  }
  if (prod != n_fft / 2) return (int)cudaErrorInvalidValue;
  const int n_frames = (L - n_fft) / hop;
  const int tiles_per_row = (n_frames + kTileF - 1) / kTileF, n_tiles = B * tiles_per_row;
  const long smem = (long)smem_floats(n_fft, n_bins, n_mels, hop) * (long)sizeof(float);
  int dev = 0, n_sm = 0, per_sm = 0, smem_max = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return (int)err;
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(log10_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // all of L1 as shared memory, so two blocks fit an SM
  err = cudaFuncSetAttribute(log10_mel_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, log10_mel_kernel,
                                                            kMelThreads, smem)) != cudaSuccess)
    return (int)err;
  const int grid = std::min(n_tiles, std::max(per_sm, 1) * n_sm);
  log10_mel_kernel<<<grid, kMelThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)tw, (const float*)window, (const float*)cos_b,
      (const float*)sin_b, (const float*)bases_t,
      (const float*)mel_w, (float*)out, plan, n_stages, L, n_fft, n_bins, n_mels, n_frames, hop,
      tiles_per_row, n_tiles, refine_below);
  return (int)cudaGetLastError();
}

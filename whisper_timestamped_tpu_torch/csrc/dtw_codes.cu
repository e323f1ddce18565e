// dtw_codes: batched DTW dynamic programme, and the walk back along its
// path, in one launch.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py
//   :477 dtw_codes_batched (kernel _dtw_kernel_batched :427), with the
//        backtrace of whisper_timestamped_tpu/device_align.py:100
//        (_backtrace_batch, a lax.fori_loop there): per-token start frames;
//   :259 dtw_pallas and :291 dtw_path_pallas (its host backtrace) at S = 1:
//        the path.
//
// For segment s with true extent (n, m) = dims[s][0:2], each cell (i, j)
// takes the cheapest of its DIAG (i-1, j-1), LEFT (i, j-1) and UP (i-1, j)
// predecessors, ties broken exactly as the TPU kernel breaks them (strict
// <, DIAG first, then LEFT, then UP; INF = 3e38); only __fadd_rn touches g,
// so the sums round as on the CPU and the codes match bit for bit. Cells
// outside the extent carry INF (a cell's value depends only on its three
// predecessors, so the order the cells are taken in changes nothing).
// Outputs, each optional:
//   codes  (S, N+M'-1, N) int32, diagonal-major (M' = M rounded up to 4):
//          the step into cell (i, j) at codes[s][i+j][i] for every row
//          i < N and d = i + j < n+m-1, j >= 0 (the wrapper zeroes the
//          tensor: the TPU kernel's code for the cells at j < 0);
//   starts (S, N) int32: the first frame of token row i on the path, walked
//          back from (n-1, m-1) with the host's rules (at i == 0 step left,
//          at j == 0 step up, else follow the code); rows >= n are 0;
//   path   (1 + 2 (n+m-1)) int32 at S = 1: path[0] = first, then the rows
//          and the columns of the path's cells, from index first on, in
//          order from (0, 0) to (n-1, m-1).
//
// What bounds it on the H100: the chain. The last cell depends on every
// anti-diagonal before it, n+m-1 steps; bytes (each valid cost read once)
// are ~1 % of its time. The S segments run as independent blocks.
//
// Design: a systolic sweep of R x 8 tiles, not a diagonal at a time. One
// block per segment of up to W warps (the wrapper's rule; the block's own
// rows decide how many work). Lane g of the block holds the R <= 4
// contiguous rows gR .. gR+R-1 and takes, at step t, column block k = t - g
// (8 frames): the lanes run skewed by one block, so lane g's tile needs
// only its own previous tile (its right column, in registers) and lane
// g - 1's tile of the step before (the row above, by __shfl_up_sync; at a
// warp's lane 0, from the previous warp through a ring in shared memory:
// the warps run 8 steps further apart, and meet at a barrier every 8
// steps). Inside a tile the 8 R cells are
// register arithmetic whose dependency chains (R + 7 cells long) overlap,
// so a step costs about its instructions, not a shuffle's latency a cell.
// A lane's next tile of cost (2 R aligned 16-byte loads, from the L2 where
// align_cost left it) is in flight during the step before. The codes are
// packed 2 bits a cell, 16 bits a (row, 8-frame block): ceil(M / 8) x N x
// 2 bytes, in shared memory where they fit (96 KB at N = 256, M = 1536),
// else in a device-memory scratch that stays in the L2. Then warp 0 walks
// them back, two rows a round where the path's runs are short (see walk).

#include "common.cuh"

namespace {

constexpr int kDiag = 0, kLeft = 1, kUp = 2;
constexpr float kInf = 3e38f;
constexpr int kMaxRows = 4;    // rows a lane
constexpr int kMaxWarps = 8;
constexpr int kC = 8;          // frames a tile
constexpr int kSync = 8;       // steps between the working warps' barriers
constexpr int kRing = 4 * kSync;  // steps of bottom rows a warp's ring holds
constexpr unsigned kFull = 0xffffffffu;

struct Segment {
  const float* x;      // the segment's (N, M) cost, M a multiple of 4, 16-byte aligned
  int n, m, N, M;
  int cols;            // the columns swept: m, or n + m - 1 when the codes are wanted
  int* codes;          // (N+M-1, N) int32 or null
  uint16_t* packed;    // (ceil(M / 8), stride): each row's codes of each 8-frame block
  int stride;          // rows of the packed codes (32 warps x rows a lane)
};

// The walk's packed codes of a segment: ``blocks`` 8-frame blocks x
// ``stride`` rows (32 warps x the rows a lane) of 16 bits. The one place
// the layout is worked out: the kernel indexes by it, the host sizes the
// shared memory or the device-memory scratch by it.
struct PackedLayout {
  long long blocks;
  int stride;
};

__host__ __device__ __forceinline__ PackedLayout packed_layout(int N, int M, int warps) {
  return {(M + kC - 1) / kC, 32 * warps * ((N + 32 * warps - 1) / (32 * warps))};
}

__host__ __device__ __forceinline__ long long packed_bytes(int N, int M, int warps) {
  const PackedLayout p = packed_layout(N, M, warps);
  return p.blocks * p.stride * (long long)sizeof(uint16_t);
}

__device__ __forceinline__ void working_warps_sync(int warps) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(32 * warps));
}

// A lane's cost tile at column block k: rows i0 + r, frames 8k .. 8k+7 (0
// outside the extent), two aligned float4 a row.
template <int R>
__device__ __forceinline__ void load_tile(const Segment& sg, int i0, int k, float4 (&x)[R][2]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = k * kC + 4 * h;
      x[r][h] = (i0 + r < sg.n && k >= 0 && j < sg.m)
                    ? __ldg(reinterpret_cast<const float4*>(sg.x + (long long)(i0 + r) * sg.M + j))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

__device__ __forceinline__ float elem(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The walk's packed codes where they fit in shared memory (a symbol, so
// that their loads and stores compile to shared-memory instructions).
extern __shared__ __align__(16) uint16_t packed_smem[];

// One tile of g: lane's rows i0 .. i0+R-1 at column block k. kMask: some
// cell lies outside the extent (else every cell is valid, no selects);
// kCodes: the int32 codes are written too.
template <int R, bool kMask, bool kCodes>
__device__ __forceinline__ void tile(const Segment& sg, int i0, int k, const float4 (&x)[R][2],
                                     const float (&top)[kC], float corner, float (&left)[R],
                                     float (&t)[R][kC], unsigned (&bits)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bits[r] = 0;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      // row r - 1 and column c - 1 are this tile's, already new
      const float up = r ? t[r - 1][c] : top[c];
      const float lf = c ? t[r][c - 1] : left[r];
      const float dg = r ? (c ? t[r - 1][c - 1] : left[r - 1]) : (c ? top[c - 1] : corner);
      // the code as the TPU kernel takes it (strict <: DIAG, then LEFT, then
      // UP); the value the least of the three, one min after lf (the chain's
      // link from the cell on the left)
      const int code = up < fminf(dg, lf) ? kUp : (lf < dg ? kLeft : kDiag);
      const float gn = __fadd_rn(elem(x[r][c >> 2], c & 3), fminf(fminf(dg, up), lf));
      bits[r] |= (unsigned)code << (2 * c);
      const int i = i0 + r, j = k * kC + c;
      if (kCodes && i < sg.N && i + j < sg.n + sg.m - 1) sg.codes[(long long)(i + j) * sg.N + i] = code;
      t[r][c] = !kMask || (i < sg.n && j < sg.m) ? gn : kInf;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) left[r] = t[r][kC - 1];
}

// The forward DP by the block's first W warps. Lane l of warp w takes
// block k at step k + l + (32 + kSync) w: a warp runs kSync steps further
// behind the warp before it than its lanes do behind each other, so the
// row it needs from that warp was written kSync + 1 steps earlier, and the
// working warps meet at a barrier only every kSync steps (the ring holds
// 4 kSync steps of each warp's bottom rows: a slot is rewritten 3 kSync - 1
// steps after its reader's step, with a barrier between).
template <int R, bool kCodes, bool kShared>
__device__ __forceinline__ void forward(const Segment& sg, float* bnd, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = threadIdx.x;
  const int i0 = g * R;                      // this lane's first row
  const int nb = (sg.cols + kC - 1) / kC;    // column blocks
  const int lag = g + kSync * warp;          // the step of this lane's block 0
  const int steps = nb + 32 * W - 1 + kSync * (W - 1);
  uint16_t* packed = kShared ? packed_smem : sg.packed;
  float left[R], corner_next = kInf;         // the previous tile's right column; the next corner
  float t[R][kC];                            // this lane's tile of g
#pragma unroll
  for (int r = 0; r < R; ++r) {
    left[r] = kInf;
#pragma unroll
    for (int c = 0; c < kC; ++c) t[r][c] = kInf;
  }
  float4 x[R][2], xn[R][2];
  load_tile<R>(sg, i0, -lag, x);
  for (int step = 0; step < steps; ++step) {
    const int k = step - lag;
    load_tile<R>(sg, i0, k + 1, xn);  // the next tile, in flight during this one
    // the row above: lane g - 1's bottom row of this block, from the step
    // before; at lane 0 the previous warp's lane 31's, written kSync + 1
    // steps ago (every lane reads it: one broadcast, no divergence)
    const float* b = bnd + (max(warp - 1, 0) * kRing + (step + kRing - kSync - 1) % kRing) * kC;
    const bool above = warp > 0 && step > kSync;
    float top[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float v = __shfl_up_sync(kFull, t[R - 1][c], 1), w = b[c];
      top[c] = lane ? v : (above ? w : kInf);
    }
    if (k >= 0 && k < nb) {
      // at the origin the corner stands in for g(-1, -1) = 0: g(0, 0) = x(0, 0)
      const float corner = k ? corner_next : (i0 ? kInf : 0.f);
      unsigned bits[R];
      if (i0 + R <= sg.n && (k + 1) * kC <= sg.m)
        tile<R, false, kCodes>(sg, i0, k, x, top, corner, left, t, bits);
      else
        tile<R, true, kCodes>(sg, i0, k, x, top, corner, left, t, bits);
      corner_next = top[kC - 1];
      if (packed != nullptr)
#pragma unroll
        for (int r = 0; r < R; ++r) packed[k * sg.stride + i0 + r] = (uint16_t)bits[r];
    }
    if (W > 1) {
      if (lane == 31) {
        float* o = bnd + (warp * kRing + step % kRing) * kC;
#pragma unroll
        for (int c = 0; c < kC; ++c) o[c] = t[R - 1][c];
      }
      if (step % kSync == kSync - 1 || step == steps - 1) working_warps_sync(W);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r][0] = xn[r][0];
      x[r][1] = xn[r][1];
    }
  }
}

// The walk back from (n-1, m-1) over the packed codes (warp 0). Each round
// the two half-warps read 16 cells of two rows leftward from the current
// column j (rows i and i - 1, columns j .. j - 15; at column 0 the walk
// steps up), and two ballots settle, from the bits alone, where the path
// leaves row i and, when row i - 1's entry lies in its window, where it
// leaves row i - 1 too: up to two rows a round.
template <bool kShared>
__device__ __forceinline__ void walk(const Segment& sg, int* starts, int* path) {
  constexpr int kL = 16;  // cells a row's window
  const uint16_t* packed = kShared ? packed_smem : sg.packed;
  const int lane = threadIdx.x & 31, half = lane / kL, at = lane % kL;
  const int D = sg.n + sg.m - 1;
  if (starts != nullptr)
    for (int t = sg.n + lane; t < sg.N; t += 32) starts[t] = 0;
  int i = sg.n - 1, j = sg.m - 1, p = D - 1;  // p: the path index of cell (i, j)
  while (i > 0 && j > 0) {
    const int row = i - half, col = j - at;
    int c = kUp;  // at column 0 the walk steps up
    if (row >= 1 && col > 0)
      c = (packed[(col >> 3) * sg.stride + row] >> (2 * (col & 7))) & 3;
    const unsigned stop = __ballot_sync(kFull, c != kLeft);
    const unsigned diag = __ballot_sync(kFull, c == kDiag);
    int e = j, done = 0;  // the entry column of row i - done
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i - h, off = j - e;
      if (r < 1 || e <= 0 || off >= kL) break;  // row 0, column 0, or outside the window
      const unsigned win = (stop >> (h * kL)) & (0xffffu << off) & 0xffffu;
      const int last = win ? __ffs(win) - 1 : kL - 1;  // the row's last cell in the window
      const int count = off > last ? 0 : last - off + 1;
      if (path != nullptr && lane < count) {
        path[1 + p - lane] = r;
        path[1 + D + p - lane] = e - lane;
      }
      p -= count;
      if (!win) {  // the row goes on left past the window
        e = j - kL;
        break;
      }
      const int js = j - last;
      if (starts != nullptr && lane == 0) starts[r] = js;  // the row's smallest frame
      e = js > 0 && ((diag >> (h * kL + last)) & 1) ? js - 1 : js;
      done = h + 1;
    }
    i -= done;
    j = e;
  }
  // the rest is straight: left along row 0, or up along column 0, to (0, 0)
  const int len = i + j + 1;
  for (int t = lane; t < len; t += 32) {
    const int ci = i == 0 ? 0 : i - t, cj = i == 0 ? j - t : 0;
    if (path != nullptr) {
      path[1 + p - t] = ci;
      path[1 + D + p - t] = cj;
    }
    if (starts != nullptr) starts[ci] = 0;
  }
  if (path != nullptr && lane == 0) path[0] = p - len + 1;
}

template <int R, bool kCodes, bool kShared>
__device__ void segment(const Segment& sg, float* bnd, int W, int* starts, int* path) {
  if ((int)(threadIdx.x >> 5) < W) forward<R, kCodes, kShared>(sg, bnd, W);
  if (starts == nullptr && path == nullptr) return;
  __syncthreads();  // every warp's codes written
  if (threadIdx.x < 32) walk<kShared>(sg, starts, path);
}

template <int R>
__device__ void segment(const Segment& sg, float* bnd, int W, int* starts, int* path, bool shared) {
  if (sg.codes != nullptr)
    segment<R, true, false>(sg, bnd, W, starts, path);
  else if (shared)
    segment<R, false, true>(sg, bnd, W, starts, path);
  else
    segment<R, false, false>(sg, bnd, W, starts, path);
}

__global__ void dtw_kernel(const float* __restrict__ cost,  // (S, N, M)
                           const int* __restrict__ dims,    // (S, 4)
                           int N, int M, int* __restrict__ codes, int* __restrict__ starts,
                           int* __restrict__ path, uint16_t* __restrict__ packed) {
  __shared__ float bnd[kMaxWarps * kRing * kC];  // the warps' bottom rows, kRing steps
  const int s = blockIdx.x, warps = blockDim.x >> 5;
  const long long D = (long long)N + M - 1;
  const PackedLayout pl = packed_layout(N, M, warps);
  Segment sg;
  sg.x = cost + (long long)s * N * M;
  sg.n = min(dims[s * 4 + 0], N);
  sg.m = min(dims[s * 4 + 1], M);
  sg.N = N;
  sg.M = M;
  sg.cols = codes != nullptr ? sg.n + sg.m - 1 : sg.m;
  sg.codes = codes != nullptr ? codes + s * D * N : nullptr;
  sg.stride = pl.stride;
  const bool walks = starts != nullptr || path != nullptr;
  sg.packed = walks && packed != nullptr ? packed + s * pl.blocks * pl.stride : nullptr;
  const bool shared = walks && packed == nullptr;
  int* st = starts != nullptr ? starts + (long long)s * N : nullptr;
  if (sg.n <= 0 || sg.m <= 0) {
    if (st != nullptr)
      for (int t = threadIdx.x; t < N; t += blockDim.x) st[t] = 0;
    return;
  }
  // the rows worked (all N when the codes are wanted), R a lane over W working warps
  const int rows = codes != nullptr ? N : sg.n;
  const int R = min((rows + 32 * warps - 1) / (32 * warps), kMaxRows);
  const int W = (rows + 32 * R - 1) / (32 * R);
  switch (R) {
    case 1: segment<1>(sg, bnd, W, st, path, shared); break;
    case 2: segment<2>(sg, bnd, W, st, path, shared); break;
    case 3: segment<3>(sg, bnd, W, st, path, shared); break;
    default: segment<4>(sg, bnd, W, st, path, shared); break;
  }
}

// the packed codes' dynamic shared memory at most: a block's 227 KB less
// the static ring of bottom rows (8 KB) and a margin
constexpr int kMaxSmem = 227 * 1024 - 9 * 1024;

// The DP's chain floor: one warp taking ``steps`` dependent steps of a
// shuffle, a min and an add (what links a diagonal to the next).
__global__ void dtw_chain_kernel(float* __restrict__ out, int steps) {
  float g = (float)threadIdx.x;
  const float x = 0.5f * (float)threadIdx.x;
  for (int t = 0; t < steps; ++t) g = __fadd_rn(x, fminf(g, __shfl_up_sync(kFull, g, 1)));
  out[threadIdx.x] = g;
}

bool dtw_args_ok(int S, int N, int M, int warps) {
  return S >= 1 && N >= 1 && M >= 1 && M % 4 == 0 && warps >= 1 && warps <= kMaxWarps &&
         N <= warps * 32 * kMaxRows;
}

// Bytes of the device-memory scratch a walk's packed codes need: 0 where
// they fit in the block's shared memory (or nothing walks).
long long scratch_bytes(int S, int N, int M, int warps, bool walks) {
  if (!walks || packed_bytes(N, M, warps) <= kMaxSmem) return 0;
  return (long long)S * packed_bytes(N, M, warps);
}

}  // namespace

// Bytes of the device-memory scratch ``wtt_dtw`` needs for these arguments
// (0: none; the launch then keeps the packed codes in shared memory).
extern "C" long long wtt_dtw_scratch_bytes(int S, int N, int M, int warps, int walks) {
  return dtw_args_ok(S, N, M, warps) ? scratch_bytes(S, N, M, warps, walks != 0) : 0;
}

// codes, or starts and/or path: the outputs wanted (null: not written;
// path needs S = 1). packed: the device-memory scratch of exactly
// ``wtt_dtw_scratch_bytes`` bytes (packed_bytes its size), null where that
// is 0. M must be a multiple of 4 and cost 16-byte aligned (the wrapper
// pads). Refuses (InvalidValue, launching nothing) rows beyond 4 a lane and
// a scratch of another size.
extern "C" int wtt_dtw(const void* cost, const void* dims, void* codes, void* starts, void* path,
                       void* packed, long long packed_size, int S, int N, int M, int warps,
                       void* stream) {
  if (!dtw_args_ok(S, N, M, warps) || ((uintptr_t)cost & 15) != 0 ||
      (path != nullptr && S != 1))
    return (int)cudaErrorInvalidValue;
  const bool walks = starts != nullptr || path != nullptr;
  if (walks && codes != nullptr) return (int)cudaErrorInvalidValue;  // one or the other
  const long long need = scratch_bytes(S, N, M, warps, walks);
  if (packed_size != need || (need > 0) != (packed != nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = walks && need == 0 ? (size_t)packed_bytes(N, M, warps) : 0;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dtw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  dtw_kernel<<<S, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)cost, (const int*)dims, N, M, (int*)codes, (int*)starts, (int*)path,
      (uint16_t*)packed);
  return (int)cudaGetLastError();
}

// One warp's chain of ``steps`` shuffle + min + add steps (out: 32 floats),
// timed by chip_smoke.py for the DP's floor.
extern "C" int wtt_dtw_chain(void* out, int steps, void* stream) {
  dtw_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((float*)out, steps);
  return (int)cudaGetLastError();
}

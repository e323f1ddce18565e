// align_cost and attention_to_cost: DTW cost matrices from the alignment
// heads' scores.
//
// Replaces: whisper_timestamped_tpu/ops/pallas_kernels.py
//   :395 attention_to_cost_batched (kernel _cost_kernel_batched :337), the
//        batched form, with the gather and window slice of
//        whisper_timestamped_tpu/device_align.py:145-152 (wtt_align_cost);
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
// Where the scores come from. Token row i of segment s reads head k's frames
// from  scores + row(s, i) * row_stride + k * head_stride + start + col,
// column col reading 0 where start + col >= T (the zero padding of the JAX
// aligner's window slice). The gather form (the device aligner) reads the
// flattened attention buffer (R, K, T) itself: row(s, i) = rows[s][i],
// row_stride = K * T, head_stride = T, start = dims[s][3] clamped to [0, T]
// as lax.dynamic_slice clamps it. The pre-sliced form (S, K, N, M):
// row(s, i) = s * K * N + i, row_stride = M, head_stride = N * M, start 0,
// T = M. So no (S, K, N, M) window copy is made on the main path.
//
// What bounds it on the H100: bytes (each valid score read once: at one
// 120-head segment of 200 x 1500, 144 MB) and, close behind, the median's
// min/max work (half-rate on the ALU pipe).
//
// Design, two launches on one stream:
//   1. rows, grid (N, S, G), blocks of kRowWarps warps: one block per token
//      row and head group (G groups of about 16 heads, so that a segment of
//      many heads still fills the card), each warp a contiguous share of
//      the group's heads in head order. A warp
//      streams its head rows into shared memory one head ahead of the
//      compute, as the row's aligned 16-byte cp.async chunks (the window
//      start has no alignment: the row lands shifted by start & 3, and the
//      lanes' tiles follow the shift, so every shared-memory read stays
//      aligned; 4-byte copies, one a frame, ran at about one a clock an SM
//      and bounded the first design), zero fill past T included, then the
//      8 reflected frames from the landed row. Each lane takes 8 contiguous
//      frames of each 256-frame tile: the medians two at a time (the 4th and 5th
//      smallest of the 8 scores two neighbouring windows share, then each
//      window's own score clamped between them: 19 min/max a median, not
//      38; a selection, so exact), softmax max and sum by warp shuffles, the
//      head's share added to the lane's accumulators in registers. The
//      warps' accumulators are summed in warp order (a fixed order: the
//      same result on every run) and the group's share of the unnormalised
//      head mean is written for the columns < span only: group 0 into the
//      cost, the others into a scratch of partials.
//   2. columns, grid (ceil(M / 32), S), 256 threads: a 32-frame tile of a
//      segment; eight row groups add the head groups' partials in group
//      order and take the sum of squares in row order, summed in row-group
//      order; then every cell of the tile is written normalised,
//      negated, masked (or 0). With the edits, each block writes its tile's
//      minimum, and the segment's last block (a per-segment ticket that the
//      rows launch resets) writes cost[s][0][0] = the segment's minimum.
// No float atomics anywhere: the DTW compares costs exactly. The softmax's
// exp is __expf (ex2.approx of x log2 e): off by a few parts in 1e7 for
// the scores that carry weight, inside the rtol 1e-5 the cost is held to.

#include "common.cuh"

namespace {

constexpr int kRowWarps = 4;     // warps a row block
constexpr int kTile = 256;       // frames a warp covers per tile (8 a lane)
constexpr int kMaxFrames = 1536;  // M, and so the span, at most
constexpr int kMaxTiles = 7;     // spans of up to 1536 frames, shifted by up to 3
constexpr int kColTile = 32;     // frames a column block
constexpr int kColGroups = 8;    // row groups a column block (32 where the grid is small)
constexpr int kMaxColGroups = 32;

// A segment's extent: from dims (S, 4) in the batched forms; from the launch
// arguments (one segment, no edits) when dims is null.
struct Extent {
  int n_tokens, span, maxdur, start;
};

__device__ __forceinline__ Extent extent(const int* dims, int s, int n_tokens, int span, int N,
                                         int M, int T, bool gather) {
  if (dims == nullptr) return {min(n_tokens, N), min(span, M), M, 0};
  const int start = gather ? min(max(dims[s * 4 + 3], 0), T) : 0;
  return {min(dims[s * 4 + 0], N), min(dims[s * 4 + 1], M), dims[s * 4 + 2], start};
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void sort4(float& a, float& b, float& c, float& d) {
  wtt::cx(a, b); wtt::cx(c, d); wtt::cx(a, c); wtt::cx(b, d); wtt::cx(b, c);
}

// Medians of the windows v[0..8] and v[1..9]: with (s4, s5) the 4th and 5th
// smallest of the shared v[1..8], a window's median is its own score
// clamped to [s4, s5].
__device__ __forceinline__ void median_pair(const float* v, float& m0, float& m1) {
  float a0 = v[1], a1 = v[2], a2 = v[3], a3 = v[4];
  float b0 = v[5], b1 = v[6], b2 = v[7], b3 = v[8];
  sort4(a0, a1, a2, a3);
  sort4(b0, b1, b2, b3);
  // k-th smallest of two sorted lists: min over i + j = k of max(a_i, b_j)
  const float s4 = fminf(fminf(fminf(b3, fmaxf(a0, b2)), fminf(fmaxf(a1, b1), fmaxf(a2, b0))), a3);
  const float s5 = fminf(fminf(fmaxf(a0, b3), fmaxf(a1, b2)), fminf(fmaxf(a2, b1), fmaxf(a3, b0)));
  m0 = fmaxf(s4, fminf(v[0], s5));
  m1 = fmaxf(s4, fminf(v[9], s5));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

// A warp's staged head row. The window's frame c (from ``start``) sits at
// buf[a + 4 + c], a = start & 3, so that frame g of the row (g = start + c)
// sits at buf[4 + g - (start & ~3)]: the row's aligned 16-byte chunks land
// on aligned slots. The reflection-padded row is xp = buf + a: xp[4 + c] =
// x[c], and after ``fix_edges`` xp[3 - t] = x[t] (symmetric at column 0) and
// xp[4 + span + t] = x[max(span - 1 - t, 0)] (symmetric at the span edge)
// for t < 4. Frames at or past T read 0 (the slice's zero padding).
//
// Stage frames [0, max(span, 4)) of the window in 16-byte chunks (every
// row 16-byte aligned and T a multiple of 4: the launch refuses others).
__device__ __forceinline__ void stage_row(float* buf, const float* row, int start, int span, int T,
                                          int lane) {
  const int need = max(span, 4);
  const int g0 = start & ~3, n_chunks = (start + need - g0 + 3) >> 2;
  for (int q = lane; q < n_chunks; q += 32) {
    const int g = g0 + 4 * q;
    cp_async16(buf + 4 + 4 * q, g < T ? row + g : row, g < T ? 16 : 0);
  }
}

// The 8 reflected frames, from the landed row (reads first: with span < 4
// a source can lie in a destination).
__device__ __forceinline__ void fix_edges(float* xp, int span, int lane) {
  const int t = lane & 3;
  const float v = lane < 8 ? xp[4 + (lane < 4 ? t : max(span - 1 - t, 0))] : 0.f;
  __syncwarp();
  if (lane < 8) xp[lane < 4 ? 3 - t : 4 + span + t] = v;
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kRowWarps, 3)
cost_rows_kernel(const float* __restrict__ scores, const int* __restrict__ rows,
                 const int* __restrict__ dims, int n_tokens_arg, int span_arg,
                 float* __restrict__ cost, int* __restrict__ tickets, int K, int N, int M, int T,
                 long long row_stride, long long head_stride, int stage,
                 float* __restrict__ partial) {
  extern __shared__ __align__(16) float sm[];
  const int i = blockIdx.x, s = blockIdx.y, g = blockIdx.z, G = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool gather = rows != nullptr;
  const Extent ext = extent(dims, s, n_tokens_arg, span_arg, N, M, T, gather);
  if (tickets != nullptr && i == 0 && g == 0 && threadIdx.x == 0) tickets[s] = 0;  // for the columns launch
  if (i >= ext.n_tokens) return;
  const int span = ext.span, start = ext.start, a = start & 3;
  const long long row = gather ? (long long)rows[(long long)s * N + i] : (long long)s * K * N + i;
  const float* base = scores + row * row_stride;
  float* buf = sm + warp * 2 * stage;  // two stages of this warp's head rows
  // the block's head group [K g / G, K (g + 1) / G), a contiguous share a warp
  const int kg0 = g * K / G, kg = (g + 1) * K / G - kg0;
  const int k0 = kg0 + warp * kg / kRowWarps, k1 = kg0 + (warp + 1) * kg / kRowWarps;
  // lane l takes the 8 frames c = 256 t + 8 l - a + o (o < 8) of tile t:
  // their windows start at buf[256 t + 8 l], 16-byte aligned
  const int tiles = (span + a + kTile - 1) / kTile;

  float acc[kMaxTiles][8];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t)
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[t][o] = 0.f;

  if (k0 < k1) stage_row(buf, base + k0 * head_stride, start, span, T, lane);
  cp_async_commit();
  for (int k = k0; k < k1; ++k) {
    if (k + 1 < k1)
      stage_row(buf + ((k + 1 - k0) & 1) * stage, base + (k + 1) * head_stride, start, span, T,
                lane);
    cp_async_commit();
    cp_async_wait1();
    __syncwarp();
    float* sb = buf + ((k - k0) & 1) * stage;
    fix_edges(sb + a, span, lane);
    float med[kMaxTiles][8];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t < tiles) {
        const int c0 = t * kTile + lane * 8 - a;
        float v[16];
        const float4* q = reinterpret_cast<const float4*>(sb + t * kTile + lane * 8);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 f = q[u];
          v[4 * u] = f.x; v[4 * u + 1] = f.y; v[4 * u + 2] = f.z; v[4 * u + 3] = f.w;
        }
#pragma unroll
        for (int o = 0; o < 8; o += 2) median_pair(v + o, med[t][o], med[t][o + 1]);
#pragma unroll
        for (int o = 0; o < 8; ++o)
          if ((unsigned)(c0 + o) < (unsigned)span) mx = fmaxf(mx, med[t][o]);
      }
    }
    mx = wtt::warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t < tiles) {
        const int c0 = t * kTile + lane * 8 - a;
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const float e = (unsigned)(c0 + o) < (unsigned)span ? __expf(med[t][o] - mx) : 0.f;
          med[t][o] = e;
          sum += e;
        }
      }
    }
    const float inv = 1.0f / fmaxf(wtt::warp_sum(sum), 1e-30f);
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t)
      if (t < tiles)
#pragma unroll
        for (int o = 0; o < 8; ++o) acc[t][o] += med[t][o] * inv;
    __syncwarp();  // the next stage_row overwrites this buffer
  }

  // the warps' sums, added in warp order, times 1/K
  __syncthreads();
  float* part = sm + warp * 2 * stage;  // frame c's sum at part[a + c]
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t)
    if (t < tiles)
#pragma unroll
      for (int o = 0; o < 8; ++o) part[t * kTile + lane * 8 + o] = acc[t][o];
  __syncthreads();
  const float inv_k = 1.0f / (float)K;
  // group 0 writes the cost, group g > 0 its partial (g - 1), which the
  // columns launch adds in group order
  float* out = (g == 0 ? cost : partial + (long long)(g - 1) * gridDim.y * N * M) +
               ((long long)s * N + i) * M;
  for (int c = threadIdx.x; c < span; c += 32 * kRowWarps) {
    float v = sm[a + c];
#pragma unroll
    for (int w = 1; w < kRowWarps; ++w) v += sm[w * 2 * stage + a + c];
    out[c] = v * inv_k;
  }
}

template <int kGroups>  // row groups a block
__global__ void __launch_bounds__(kColTile * kGroups)
cost_columns_kernel(const int* __restrict__ dims, int n_tokens_arg, int span_arg,
                    float* __restrict__ cost, int* __restrict__ tickets,
                    float* __restrict__ tile_min, int N, int M, int T, int gather,
                    const float* __restrict__ partial, int G) {
  __shared__ float red[kGroups][kColTile];
  __shared__ float red_min[32];
  __shared__ bool last;
  const int s = blockIdx.y, tile = blockIdx.x, n_tiles = gridDim.x;
  const int lane_c = threadIdx.x % kColTile, group = threadIdx.x / kColTile;
  const int c = tile * kColTile + lane_c;
  const Extent ext = extent(dims, s, n_tokens_arg, span_arg, N, M, T, gather != 0);
  const bool edits = dims != nullptr;
  float* seg = cost + (long long)s * N * M;
  const bool col_valid = c < ext.span;
  float ss = 0.f;
  if (col_valid)
#pragma unroll 4
    for (int i = group; i < ext.n_tokens; i += kGroups) {
      float v = seg[(long long)i * M + c];
      if (G > 1) {  // the head groups' partials, in group order
        for (int h = 1; h < G; ++h) v += partial[((long long)(h - 1) * gridDim.y * N + i) * M +
                                                 (long long)s * N * M + c];
        seg[(long long)i * M + c] = v;
      }
      ss += v * v;
    }
  red[group][lane_c] = ss;
  __syncthreads();
  ss = red[0][lane_c];
#pragma unroll
  for (int g = 1; g < kGroups; ++g) ss += red[g][lane_c];
  const float denom = fmaxf(sqrtf(ss), 1e-30f);
  float mn = INFINITY;
  if (c < M)
#pragma unroll 4
    for (int i = group; i < N; i += kGroups) {
      const bool valid = col_valid && i < ext.n_tokens;
      float v = valid ? -(seg[(long long)i * M + c] / denom) : 0.f;
      if (edits && valid && i < ext.n_tokens - 1 && c >= ext.maxdur) v = 0.f;  // max_duration mask
      seg[(long long)i * M + c] = v;
      mn = fminf(mn, v);
    }
  if (!edits) return;
  // the origin: cost[s][0][0] = min(cost[s]), by the segment's last block
  mn = wtt::block_reduce<1>(mn, red_min);
  if (threadIdx.x == 0) {
    tile_min[s * n_tiles + tile] = mn;
    __threadfence();
    last = atomicAdd(tickets + s, 1) == n_tiles - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float m = INFINITY;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
    m = fminf(m, *(volatile float*)(tile_min + s * n_tiles + t));
  m = wtt::block_reduce<1>(m, red_min);
  if (threadIdx.x == 0) seg[0] = m;  // encourage the path to start early
}

cudaError_t launch(const float* scores, const int* rows, const int* dims, int n_tokens, int span,
                   float* cost, int* scratch, float* partial, int S, int K, int N, int M, int T,
                   long long row_stride, long long head_stride, int G, cudaStream_t st) {
  // rows staged in 16-byte chunks: every row 16-byte aligned, T a multiple of 4
  const bool aligned = ((uintptr_t)scores & 15) == 0 && row_stride % 4 == 0 &&
                       head_stride % 4 == 0 && T % 4 == 0;
  if (M > kMaxFrames || M < 1 || N < 1 || K < 1 || S < 1 || G < 1 || G > K || G > 64 ||
      (G > 1 && partial == nullptr) || !aligned)
    return cudaErrorInvalidValue;
  // a stage: the tiles of up to M + 3 frames, and the 16 floats past the last (the windows' reach)
  const int stage = ((M + 3 + kTile - 1) / kTile) * kTile + 16;
  const size_t smem = (size_t)kRowWarps * 2 * stage * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once: the largest stage
      cost_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kRowWarps * 2 * (kMaxTiles * kTile + 16) * sizeof(float)));
  if (attr != cudaSuccess) return attr;
  cudaError_t err;
  const int n_tiles = (M + kColTile - 1) / kColTile;
  int* tickets = dims != nullptr ? scratch : nullptr;
  float* tile_min = dims != nullptr ? reinterpret_cast<float*>(scratch + S) : nullptr;
  cost_rows_kernel<<<dim3(N, S, G), 32 * kRowWarps, smem, st>>>(
      scores, rows, dims, n_tokens, span, cost, tickets, K, N, M, T, row_stride, head_stride,
      stage, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 8 row groups a block, or 32 where the grid has fewer blocks than two an SM
  const bool wide = n_tiles * S < 264;
  if (wide)
    cost_columns_kernel<kMaxColGroups><<<dim3(n_tiles, S), kColTile * kMaxColGroups, 0, st>>>(
        dims, n_tokens, span, cost, tickets, tile_min, N, M, T, rows != nullptr, partial, G);
  else
    cost_columns_kernel<kColGroups><<<dim3(n_tiles, S), kColTile * kColGroups, 0, st>>>(
        dims, n_tokens, span, cost, tickets, tile_min, N, M, T, rows != nullptr, partial, G);
  return cudaGetLastError();
}

}  // namespace

// The batched forms. rows null: pre-sliced scores (S, K, N, M) (T = M);
// else the flattened attention buffer (R, K, T) read through rows (S, N).
// scratch: S + S * ceil(M / 32) int32 (tickets, then the tiles' minima).
// G: head groups, each its own row block; the groups after the first write
// their partial head sums to ``partial`` ((G - 1) x S x N x M f32, null at
// G = 1). Both forms refuse (InvalidValue, launching nothing) scores that
// are not 16-byte aligned or rows whose frames (T, or M pre-sliced) are not
// a multiple of 4: the wrappers pad those.
extern "C" int wtt_align_cost(const void* scores, const void* rows, const void* dims,
                              void* cost, void* scratch, void* partial, int S, int K, int N,
                              int M, int T, int G, void* stream) {
  const bool gather = rows != nullptr;
  return (int)launch((const float*)scores, (const int*)rows, (const int*)dims, 0, 0,
                     (float*)cost, (int*)scratch, (float*)partial, S, K, N, M, gather ? T : M,
                     gather ? (long long)K * T : (long long)M,
                     gather ? (long long)T : (long long)N * M, G, (cudaStream_t)stream);
}

extern "C" int wtt_attention_to_cost(const void* scores, void* cost, void* partial, int K, int N,
                                     int M, int n_tokens, int span, int G, void* stream) {
  return (int)launch((const float*)scores, nullptr, nullptr, n_tokens, span, (float*)cost,
                     nullptr, (float*)partial, 1, K, N, M, M, (long long)M, (long long)N * M, G,
                     (cudaStream_t)stream);
}

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
// 1280 x 5120). So every SM needs many bytes in flight, and the products
// must cost nothing next to the stream: tensor cores, fed by TMA.
//
// Design (Hopper): the product is computed transposed, out^T = W · x^T, so
// the weights are wgmma's 64-row A operand and the batch its N (kCols, B
// rounded up to 8..256; a larger B is split into column groups, grid z).
// Both operands are K-major as they lie: w_all is read in place through a
// 3-D tensor map (k, n, layer), x through a map over (k, b). A block owns
// 64 output features (grid y) and a range of whole 64-wide k-tiles (grid
// x: the split). One producer thread keeps a ring of about 64 KB of
// (64 x 64 weight, kCols x 64 x) tile pairs in flight by TMA (128-byte swizzle,
// zeros past every edge, so ragged N, B and K need no masks in the loop),
// with full and empty mbarriers; one consumer warpgroup runs four wgmma
// m64n<kCols>k16 a k-tile, both operands from shared memory, f32 sums in
// registers. When the N / 64 tiles alone would leave SMs idle, K is split
// (ops.kernels.matmul_split): the split blocks of a tile are one thread
// block cluster and rank r owns rows [64 r / n_split, 64 (r + 1) / n_split)
// of the tile. Each block stores its f32 sums straight from its
// accumulators into the owners' shared memory (distributed shared memory,
// 8 bytes a store, no round trips); after one cluster barrier each rank
// sums its rows over the splits in split order, rounds once to bf16 and
// stores them. No scratch in device memory, no second launch, no remote
// reads. An unsplit grid launches without a cluster.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

using namespace wtt::hopper;

constexpr int kTileN = 64;    // output features a block: wgmma's M
constexpr int kTileK = 64;    // k a stage: one 128-byte swizzle row of bf16
constexpr int kThreadsMM = 128 + 32;  // a consumer warpgroup + a producer warp
constexpr uint32_t kWBytes = kTileN * kTileK * 2;
constexpr int kMaxSplits = 8;  // a portable cluster
constexpr int kRecvRows = 72;  // >= n_split * ceil(64 / n_split) for n_split <= 8

// The ring's depth: about 64 KB of (weight, x) tile pairs in flight a
// block, 2 to 16 stages.
template <int kCols>
__host__ __device__ constexpr int stages() {
  const int n = 65536 / (kWBytes + kCols * kTileK * 2);
  return n < 2 ? 2 : (n > 16 ? 16 : n);
}

template <int kCols>
struct MMSmem {  // every tile 1024-byte aligned, as the 128-byte swizzle needs
  // a received row: the columns and 4 floats of padding (16-byte rows whose
  // banks shift by 4 a row, so 8 rows' 16-byte reads cover all 32 banks)
  static constexpr int kRecvStride = kCols + 4;
  __nv_bfloat16 w[stages<kCols>()][kTileN * kTileK];
  __nv_bfloat16 x[stages<kCols>()][kCols * kTileK];
  // the tile rows this block sums, as each split sent them:
  // recv[(split * rows a rank + row) * kRecvStride + column]
  float recv[kRecvRows * kRecvStride];
  uint64_t full[stages<kCols>()], empty[stages<kCols>()];
};
template <int kCols>
constexpr int smem_bytes() {
  return (int)sizeof(MMSmem<kCols>) + 1024;  // + room to align the base
}

template <int kCols>
__global__ void __launch_bounds__(kThreadsMM)
stacked_matmul_kernel(const __grid_constant__ CUtensorMap tw,  // w_all as (K, N, L)
                      const __grid_constant__ CUtensorMap tx,  // x as (K, B, 1)
                      __nv_bfloat16* __restrict__ out, int layer, int B, int N, int k_tiles) {
  static_assert(kCols % 8 == 0 && kCols <= 256, "wgmma's N");
  constexpr int kStages = stages<kCols>();
  constexpr uint32_t kStageBytes = kWBytes + kCols * kTileK * 2;
  extern __shared__ uint8_t smem_raw[];
  MMSmem<kCols>& sm = *reinterpret_cast<MMSmem<kCols>*>(align1024(smem_raw));

  const int split = blockIdx.x, n_split = gridDim.x;
  const int n0 = blockIdx.y * kTileN, b0 = blockIdx.z * kCols;
  const int kt0 = split * k_tiles / n_split, nk = (split + 1) * k_tiles / n_split - kt0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // rank r of the cluster sums the tile's rows [r 64 / n_split, (r + 1) 64 / n_split)
  const int rows = (kTileN + n_split - 1) / n_split;  // the most a rank owns
  const int cols = min(kCols, B - b0);                 // the live batch columns

  if (threadIdx.x == 0) {
    prefetch_tma_desc(&tw);
    prefetch_tma_desc(&tx);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);  // a consumer warp each
    }
    mbar_fence_init();
  }
  __syncthreads();

  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (warp == 4) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % kStages, k0 = (kt0 + i) * kTileK;
        if (i >= kStages) mbar_wait(&sm.empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], kStageBytes);
        tma_load(sm.w[st], &tw, &sm.full[st], k0, n0, layer);
        tma_load(sm.x[st], &tx, &sm.full[st], k0, b0, 0);
      }
    }
  } else {  // the consumers: out^T[n0 .. n0 + 63][b0 .. b0 + kCols - 1] in acc
    float acc[kCols / 2];
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < nk; ++i) {
      const int st = i % kStages;
      mbar_wait(&sm.full[st], (i / kStages) & 1);
      const uint64_t dw = sw128_desc(sm.w[st]), dx = sw128_desc(sm.x[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) wgmma_ss(acc, dw + 2 * kk, dx + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's products are done: free its slots
      __syncwarp();
      if (i > 0 && lane == 0) mbar_arrive(&sm.empty[(i - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // send this thread's sums to the ranks that own their rows: rows r and
    // r + 8, columns c and c + 1 of each 8-column group (the accumulator
    // layout), 8 bytes a store, into distributed shared memory when split
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = warp * 16 + (lane >> 2) + 8 * h;
      const int owner = ((n + 1) * n_split + kTileN - 1) / kTileN - 1;
      const int row = n - owner * kTileN / n_split;
      float* dst = sm.recv + (split * rows + row) * MMSmem<kCols>::kRecvStride + 2 * (lane & 3);
      if (owner != split) dst = cluster.map_shared_rank(dst, owner);  // another rank's rows
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        if (8 * j < cols)  // the live columns only
          *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j + 2 * h],
                                                                acc[4 * j + 2 * h + 1]);
      }
    }
  }
  // Every split's sums of this block's rows have landed (the cluster
  // barrier releases the remote stores and acquires them here); after it
  // no block touches another's shared memory, so each may finish alone.
  if (n_split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  // this rank's rows of the live columns, each summed over the splits in
  // split order and rounded once: a thread takes a row and 8 columns (two
  // 16-byte reads a split), threads along the rows, so each of the 8
  // stores covers adjacent features of one output row across the warp
  constexpr int kRS = MMSmem<kCols>::kRecvStride;
  const int lo = split * kTileN / n_split, mine = (split + 1) * kTileN / n_split - lo;
  for (int e = threadIdx.x; e < mine * (cols + 7) / 8; e += kThreadsMM) {
    const int c0 = e / mine * 8, row = e % mine, n = n0 + lo + row;
    if (n >= N) continue;
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    for (int r = 0; r < n_split; ++r) {
      const float4* src = reinterpret_cast<const float4*>(sm.recv + (r * rows + row) * kRS + c0);
      const float4 a = src[0], b = src[1];
      s0 = make_float4(s0.x + a.x, s0.y + a.y, s0.z + a.z, s0.w + a.w);
      s1 = make_float4(s1.x + b.x, s1.y + b.y, s1.z + b.z, s1.w + b.w);
    }
    const float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    __nv_bfloat16* o = out + (long)(b0 + c0) * N + n;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c0 + c < cols) o[(long)c * N] = __float2bfloat16(v[c]);
  }
}

template <int kCols>
cudaError_t launch(const CUtensorMap& tw, const CUtensorMap& tx, __nv_bfloat16* out, int layer,
                   int B, int N, int k_tiles, int n_split, int groups, cudaStream_t stream) {
  const int smem = smem_bytes<kCols>();
  const cudaError_t e = cudaFuncSetAttribute(  // per device, so on every call
      stacked_matmul_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_split, (N + kTileN - 1) / kTileN, groups);
  config.blockDim = dim3(kThreadsMM);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = n_split > 1 ? 1 : 0;  // unsplit: no cluster
  return cudaLaunchKernelEx(&config, stacked_matmul_kernel<kCols>, tw, tx, out, layer, B, N,
                            k_tiles);
}

}  // namespace

// cols: the block's batch columns (8, 16, 32, 64, 128 or 256), groups of
// them over B; n_split: the k-splits of a tile (ops.kernels.matmul_split)
extern "C" int wtt_stacked_matmul(const void* x, const void* w_all, void* out, int layer, int L,
                                  int B, int N, int K, int cols, int groups, int n_split,
                                  void* stream) {
  const int k_tiles = (K + kTileK - 1) / kTileK;
  if (n_split < 1 || n_split > kMaxSplits || n_split > k_tiles || groups * cols < B)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  if (!make_map(&tw, w_all, K, N, L, kTileN) || !make_map(&tx, x, K, B, 1, cols))
    return (int)cudaErrorInvalidValue;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (cols) {
    case 8: e = launch<8>(tw, tx, o, layer, B, N, k_tiles, n_split, groups, s); break;
    case 16: e = launch<16>(tw, tx, o, layer, B, N, k_tiles, n_split, groups, s); break;
    case 32: e = launch<32>(tw, tx, o, layer, B, N, k_tiles, n_split, groups, s); break;
    case 64: e = launch<64>(tw, tx, o, layer, B, N, k_tiles, n_split, groups, s); break;
    case 128: e = launch<128>(tw, tx, o, layer, B, N, k_tiles, n_split, groups, s); break;
    case 256: e = launch<256>(tw, tx, o, layer, B, N, k_tiles, n_split, groups, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

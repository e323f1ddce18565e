// The single-query decode-attention pipeline of the port's five decode
// attentions: xattn_decode, xattn_decode_int8, xattn_decode_int4,
// self_attn_decode and self_attn_decode_int8 (sm_90a).
//
// One block of kWarps warps attends one query row's head h over the rows
// [lo, hi) of a K/V slab, head width 64, and writes the bf16 output. When
// the rows of a (row, head) are split across blocks, those blocks form one
// thread block cluster (Hopper): each keeps its partial softmax (m, l, o) in
// its shared memory, and the cluster's first block merges them through
// distributed shared memory, with no trip through device memory and no
// counter. The grid's split over the rows is the caller's (see
// xattn_decode.cu), at most kMaxSplits blocks.
//
// The ring: the block walks tiles of 16 rows a warp through kStages stages
// of dynamic shared memory, each warp owning 16 rows of every tile. A warp
// copies its own rows with 16-byte cp.async kStages tiles ahead and consumes
// them alone, so the loop has no block barrier: a warp waits only for its
// own copies. Each warp keeps its own online softmax (max m, sum l of
// exp(s - m), o = sum exp(s - m)·vscale·v, in f32); the warps' states merge
// at the end of the block, weighed by exp(m_w - M), as the splits' do
// across blocks. The
// warps a block (2 or 4) are the wrapper's choice at each launch: fewer
// warps, more resident blocks, so that a large grid runs in one wave; more
// warps, more rows in flight for a block, so that a small grid needs fewer
// splits.
//
// The row format is a template argument. A row holds kFrames frames (the
// attention's keys): each read of a K row gives kFrames scores, each read
// of a V row feeds kFrames weights.
//
//   Bf16Rows  128-byte bf16 rows; 8 lanes read a row, 8 values each, so a
//             warp reads 4 rows at once (with kOwnRow, one row may come
//             from elsewhere than the slab; with kTable, each row comes
//             from the physical row a row table names);
//   Int8Rows  64-byte int8 rows and one f32 scale a row; 4 lanes read a
//             row, 16 codes each, so a warp reads 8 rows at once. A warp's
//             16 rows are 1 KB of K, 1 KB of V and 2 x 64 B of scales.
//             With kOwnRow, the block quantizes one row itself (the step's
//             new row) and takes it from what it computed;
//   Int4Rows  64-byte nibble-packed rows of two frames each (low nibbles
//             the even frame, high the odd) and parity-major scales; read
//             as Int8Rows reads its rows, so a warp's 16 rows are 32
//             frames and each packed byte is read once.
//
// Scores are (q·k)·kscale·scale, the q·k sum in f32 over exactly widened
// values. A warp or a split with no rows leaves (-inf, 0, 0) and adds
// nothing: its weight is taken as 0, never exp(-inf - -inf).

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace wtt {
namespace decode {

constexpr int kStages = 2;              // tiles in the ring
constexpr int kWarpRows = 16;           // rows of a tile that a warp owns
constexpr int kMaxSplits = 8;           // a portable cluster

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kStages - 1 of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Code j (0-3) of the 4 int8 codes in ``w`` as f32, exactly: the code c
// becomes the low byte of the f32 2^23 + (c + 128), and the offset is
// subtracted. A byte permute and an add a code, where the int-to-float
// converter would issue at a quarter of the FMA rate.
__device__ __forceinline__ float s8_to_f32(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540u | j)) - 8388736.f;
}

// Code j (0-3) of the 4 nibble codes in ``w``, each already biased by 8
// into [0, 15] (the low nibble of each byte), as f32, exactly: the same
// byte permute as s8_to_f32, and an offset of 2^23 + 8.
__device__ __forceinline__ float u4_to_f32(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | j)) - 8388616.f;
}

// The even and odd frames' codes of 4 packed bytes, biased into [0, 15] a
// byte: a sign-extended nibble n becomes n ^ 8 = n + 8 (mod 16).
__device__ __forceinline__ uint32_t even_nibbles(uint32_t w) {
  return (w ^ 0x08080808u) & 0x0F0F0F0Fu;
}
__device__ __forceinline__ uint32_t odd_nibbles(uint32_t w) {
  return ((w >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
}

// What every row format gives attend(): kLanes lanes read a row, kVals
// values each, and the row holds kFrames frames. ``issue`` copies a warp's
// rows of a tile into the ring; ``prepare`` runs once, by the whole block,
// after the first tiles are issued; ``k_dot`` gives a K row's kFrames
// dot products with q, ``v_acc`` adds a V row times each frame's weight;
// ``k_scale``/``v_scale`` are frame f's scales. The ring row ``r`` is slab
// row ``t``.

// bf16 rows. ``k``/``v`` point at the head's first column of row 0. With
// kOwnRow, row ``own`` (-1 for none) is read from ``k_own``/``v_own``
// instead: a row the launch writes itself, whose new values the block takes
// from their source. With kTable, row t is read through a row table:
// ``table[t]`` names the physical cache row that holds it, and it lies at
// ``table[t] * row_stride + t * stride`` (``k``/``v`` then point at physical
// row 0); without, at ``t * stride``, and the table costs nothing.
template <bool kOwnRow, bool kTable = false>
struct Bf16Rows {
  static constexpr int kLanes = 8, kVals = 8, kFrames = 1;
  template <int kRows>
  struct Tiles {
    __nv_bfloat16 k[kStages][kRows][kHeadDim];
    __nv_bfloat16 v[kStages][kRows][kHeadDim];
  };
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long stride;  // elements between rows
  int own;
  const __nv_bfloat16* k_own;
  const __nv_bfloat16* v_own;
  const int* table;  // kTable: the physical row of each row t
  long row_stride;   // kTable: elements between physical rows

  __device__ __forceinline__ long offset(int t) const {
    if constexpr (kTable) return (long)__ldg(table + t) * row_stride + t * stride;
    return t * stride;
  }

  // slab rows [t0, t0 + n) into tile rows r0.. of stage st, by one warp:
  // 128 16-byte pieces each of K and V, 4 a lane
  template <class T>
  __device__ __forceinline__ void issue(T& s, int st, int r0, int t0, int n, int lane) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j, r = c >> 3, col = (c & 7) * 8;
      if (r < n) {
        const int t = t0 + r;
        const bool mine = kOwnRow && t == own;
        const long at = offset(t);
        cp_async16(&s.k[st][r0 + r][col], (mine ? k_own : k + at) + col);
        cp_async16(&s.v[st][r0 + r][col], (mine ? v_own : v + at) + col);
      }
    }
  }
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void q_vals(const __nv_bfloat16* q, int chunk, float* f) const {
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(q + chunk * 8), f);
  }
  template <class T>
  __device__ __forceinline__ void k_dot(const T& s, int st, int r, int, int chunk,
                                        const float* qf, float* d) const {
    float kf[8];
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(&s.k[st][r][chunk * 8]), kf);
    d[0] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) d[0] += qf[j] * kf[j];
  }
  // acc += w * v[r], the lane's 8 values
  template <class T>
  __device__ __forceinline__ void v_acc(const T& s, int st, int r, int, int chunk,
                                        const float* w, float* acc) const {
    float vf[8];
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(&s.v[st][r][chunk * 8]), vf);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += w[0] * vf[j];
  }
  template <class T>
  __device__ __forceinline__ float k_scale(const T&, int, int, int, int) const { return 1.f; }
  template <class T>
  __device__ __forceinline__ float v_scale(const T&, int, int, int, int) const { return 1.f; }
};

// int8 rows with one f32 scale a row. ``k``/``v`` point at the head's first
// code of row 0, ``ks``/``vs`` at row 0's scale.
//
// With kOwnRow and own >= 0, the block writes row ``own`` itself: prepare()
// quantizes the step's new rows ``k_new``/``v_new`` (all D columns) as
// quantize_rows does (scale = max|x| / 127, an IEEE quotient; code =
// rint(x / max(scale, 1e-8))), stores the head's 64 codes of each at
// ``k_dst``/``v_dst`` and, where given, the scales at ``ks_dst``/``vs_dst``.
// The ring never copies that row: the block reads its codes from its own
// shared memory and its scales from registers, never from the cache row
// that this launch writes.
//
// kGivenScales: the row's two scales come from ``ks_in``/``vs_in`` (the
// caller's, e.g. those of the whole row when the block sees only a tensor-
// parallel rank's columns) instead of the block's own reduction; the codes
// are rint(x / max(scale, 1e-8)) with them.
template <bool kOwnRow, bool kGivenScales = false>
struct Int8Rows {
  static constexpr int kLanes = 4, kVals = 16, kFrames = 1;
  template <int kRows>
  struct Tiles {
    int8_t k[kStages][kRows][kHeadDim];
    int8_t v[kStages][kRows][kHeadDim];
    float ks[kStages][kRows];
    float vs[kStages][kRows];
  };
  const int8_t* k;
  const int8_t* v;
  long stride;  // bytes between rows
  const float* ks;
  const float* vs;
  // kOwnRow: the row this block quantizes (-1 for none) and where it goes
  int own;
  const __nv_bfloat16* k_new;  // the new rows' first column
  const __nv_bfloat16* v_new;
  int D;     // columns of the new rows
  int head;  // the head's first column
  int8_t* k_dst;
  int8_t* v_dst;
  float* ks_dst;  // null: another block stores the scales
  float* vs_dst;
  float own_ks, own_vs;  // set by prepare()
  const float* ks_in = nullptr;  // kGivenScales: the row's scales
  const float* vs_in = nullptr;

  // the own row's codes, K then V (one copy a block; used only with
  // kOwnRow, so the other instantiations declare no such shared memory)
  __device__ __forceinline__ static int8_t* own_codes() {
    __shared__ __align__(16) int8_t codes[2 * kHeadDim];
    return codes;
  }
  __device__ __forceinline__ bool is_own(int t) const { return kOwnRow && t == own; }

  // slab rows [t0, t0 + n) into tile rows r0.. of stage st, by one warp: 64
  // 16-byte pieces each of K and V, 2 a lane; the scales 16 bytes (4 rows) a
  // lane over lanes 0-7, or 4 bytes at a time where the 4 rows are not whole
  // or not 16-byte aligned, or hold the own row
  template <class T>
  __device__ __forceinline__ void issue(T& s, int st, int r0, int t0, int n, int lane) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, r = c >> 2, col = (c & 3) * 16;
      if (r < n && !is_own(t0 + r)) {
        cp_async16(&s.k[st][r0 + r][col], k + (t0 + r) * stride + col);
        cp_async16(&s.v[st][r0 + r][col], v + (t0 + r) * stride + col);
      }
    }
    if (lane < 8) {
      const int r = (lane & 3) * 4;
      const float* src = (lane < 4 ? ks : vs) + t0 + r;
      float* dst = lane < 4 ? &s.ks[st][r0 + r] : &s.vs[st][r0 + r];
      const bool own_here = kOwnRow && own >= t0 + r && own < t0 + r + 4;
      if (r + 4 <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0 && !own_here) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (r + i < n && !is_own(t0 + r + i)) cp_async4(dst + i, src + i);
      }
    }
  }
  __device__ __forceinline__ void prepare() {
    if constexpr (kOwnRow)
      if (own >= 0) write_own();
  }
  // the fused write, by the whole block (``own`` is the same for all its
  // threads): both rows' max|x| over all D columns (or the given scales),
  // then the head's codes
  __device__ __forceinline__ void write_own() {
    const int tid = threadIdx.x;
    if constexpr (kGivenScales) {
      own_ks = *ks_in;
      own_vs = *vs_in;
    } else {
      __shared__ float red[2][32];
      const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
      float km = 0.f, vm = 0.f, f[8];
      for (int c = tid * 8; c < D; c += blockDim.x * 8) {
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(k_new + c), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) km = fmaxf(km, fabsf(f[j]));
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(v_new + c), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) vm = fmaxf(vm, fabsf(f[j]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        km = fmaxf(km, __shfl_xor_sync(0xffffffffu, km, o));
        vm = fmaxf(vm, __shfl_xor_sync(0xffffffffu, vm, o));
      }
      if (lane == 0) {
        red[0][warp] = km;
        red[1][warp] = vm;
      }
      __syncthreads();
      for (int w = 0; w < nwarps; ++w) {
        km = fmaxf(km, red[0][w]);
        vm = fmaxf(vm, red[1][w]);
      }
      own_ks = km / 127.f;
      own_vs = vm / 127.f;
    }
    int8_t* codes = own_codes();
    for (int c = tid; c < 2 * kHeadDim; c += blockDim.x) {
      const bool is_v = c >= kHeadDim;
      const int col = c & (kHeadDim - 1);
      const float x = __bfloat162float((is_v ? v_new : k_new)[head + col]);
      const int8_t code = (int8_t)rintf(x / fmaxf(is_v ? own_vs : own_ks, 1e-8f));
      (is_v ? v_dst : k_dst)[col] = code;
      codes[c] = code;
    }
    if (ks_dst != nullptr && tid == 0) {
      *ks_dst = own_ks;
      *vs_dst = own_vs;
    }
    __syncthreads();  // the own codes, for every warp
  }
  __device__ __forceinline__ void q_vals(const __nv_bfloat16* q, int chunk, float* f) const {
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(q + chunk * 16), f);
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(q + chunk * 16 + 8), f + 8);
  }
  template <class T>
  __device__ __forceinline__ void k_dot(const T& s, int st, int r, int t, int chunk,
                                        const float* qf, float* d) const {
    const int8_t* row = s.k[st][r];
    if constexpr (kOwnRow)
      if (t == own) row = own_codes();
    const uint4 u = *reinterpret_cast<const uint4*>(row + chunk * 16);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    d[0] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) d[0] += qf[j] * s8_to_f32(w[j >> 2], j & 3);
  }
  // acc += wt * v[r], the lane's 16 codes
  template <class T>
  __device__ __forceinline__ void v_acc(const T& s, int st, int r, int t, int chunk,
                                        const float* wt, float* acc) const {
    const int8_t* row = s.v[st][r];
    if constexpr (kOwnRow)
      if (t == own) row = own_codes() + kHeadDim;
    const uint4 u = *reinterpret_cast<const uint4*>(row + chunk * 16);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] += wt[0] * s8_to_f32(w[j >> 2], j & 3);
  }
  template <class T>
  __device__ __forceinline__ float k_scale(const T& s, int st, int r, int t, int) const {
    return is_own(t) ? own_ks : s.ks[st][r];
  }
  template <class T>
  __device__ __forceinline__ float v_scale(const T& s, int st, int r, int t, int) const {
    return is_own(t) ? own_vs : s.vs[st][r];
  }
};

// int4 frames nibble-packed in pairs: frame 2p sits in the low nibbles of
// packed row p, frame 2p + 1 in the high nibbles, each sign-extended; the
// scales are parity-major, the even frames' (``half`` = T/2 of them) before
// the odd frames'. A row here is a packed row. ``k``/``v`` point at the
// head's first byte of packed row 0, ``ks``/``vs`` at frame 0's scale.
struct Int4Rows {
  static constexpr int kLanes = 4, kVals = 16, kFrames = 2;
  template <int kRows>
  struct Tiles {
    int8_t k[kStages][kRows][kHeadDim];
    int8_t v[kStages][kRows][kHeadDim];
    float ks[kStages][2][kRows];  // [even, odd] frame of each packed row
    float vs[kStages][2][kRows];
  };
  const int8_t* k;
  const int8_t* v;
  long stride;  // bytes between packed rows
  const float* ks;
  const float* vs;
  int half;  // T / 2: where the odd frames' scales start

  // packed rows [t0, t0 + n) into tile rows r0.. of stage st, by one warp:
  // the codes as Int8Rows copies them; the four scale ranges (even and odd
  // of K, even and odd of V) 16 bytes (4 rows) a lane over lanes 0-15, or 4
  // bytes at a time where the 4 rows are not whole or not 16-byte aligned
  template <class T>
  __device__ __forceinline__ void issue(T& s, int st, int r0, int t0, int n, int lane) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j, r = c >> 2, col = (c & 3) * 16;
      if (r < n) {
        cp_async16(&s.k[st][r0 + r][col], k + (t0 + r) * stride + col);
        cp_async16(&s.v[st][r0 + r][col], v + (t0 + r) * stride + col);
      }
    }
    if (lane < 16) {
      const int r = (lane & 3) * 4, parity = (lane >> 2) & 1;
      const float* src = (lane < 8 ? ks : vs) + parity * half + t0 + r;
      float* dst = lane < 8 ? &s.ks[st][parity][r0 + r] : &s.vs[st][parity][r0 + r];
      if (r + 4 <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (r + i < n) cp_async4(dst + i, src + i);
      }
    }
  }
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void q_vals(const __nv_bfloat16* q, int chunk, float* f) const {
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(q + chunk * 16), f);
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(q + chunk * 16 + 8), f + 8);
  }
  // the even and the odd frame's dot products over the lane's 16 columns
  template <class T>
  __device__ __forceinline__ void k_dot(const T& s, int st, int r, int, int chunk,
                                        const float* qf, float* d) const {
    const uint4 u = *reinterpret_cast<const uint4*>(&s.k[st][r][chunk * 16]);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    d[0] = d[1] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t e = even_nibbles(w[i]), o = odd_nibbles(w[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[0] += qf[4 * i + j] * u4_to_f32(e, j);
        d[1] += qf[4 * i + j] * u4_to_f32(o, j);
      }
    }
  }
  // acc += wt[0] * v[even frame] + wt[1] * v[odd frame], one read of the row
  template <class T>
  __device__ __forceinline__ void v_acc(const T& s, int st, int r, int, int chunk,
                                        const float* wt, float* acc) const {
    const uint4 u = *reinterpret_cast<const uint4*>(&s.v[st][r][chunk * 16]);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t e = even_nibbles(w[i]), o = odd_nibbles(w[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[4 * i + j] += wt[0] * u4_to_f32(e, j);
        acc[4 * i + j] += wt[1] * u4_to_f32(o, j);
      }
    }
  }
  template <class T>
  __device__ __forceinline__ float k_scale(const T& s, int st, int r, int, int f) const {
    return s.ks[st][f][r];
  }
  template <class T>
  __device__ __forceinline__ float v_scale(const T& s, int st, int r, int, int f) const {
    return s.vs[st][f][r];
  }
};

// The dynamic shared memory of attend<kWarps, Rows>: its ring.
template <int kWarps, class Rows>
constexpr int tile_bytes() {
  return (int)sizeof(typename Rows::template Tiles<kWarps * kWarpRows>);
}

// Launches k2 or k4, the kernel built for 2 or 4 warps a block (the
// wrapper's choice), over the grid (n_split, H, B) with the ring's dynamic
// shared memory (at most 32 KB with two stages; a deeper ring, past what a
// block may take unasked, is allowed at the kernel's first launch, so that
// a launch captured into a CUDA graph after an eager warm-up makes no
// attribute call), the n_split > 1 blocks of each (row, head) one cluster.
// An unsplit grid launches without clusters: on an H100 the int8 kernel at
// B=40 ran 6-9 % slower as clusters of one block. Returns the launch's
// error.
template <class Rows, class Kernel, class... Args>
cudaError_t launch(int warps, Kernel k2, Kernel k4, dim3 grid, cudaStream_t stream,
                   Args... args) {
  if ((warps != 2 && warps != 4) || grid.x < 1 || grid.x > kMaxSplits)
    return cudaErrorInvalidValue;
  const int smem = warps == 2 ? tile_bytes<2, Rows>() : tile_bytes<4, Rows>();
  static bool smem_allowed[2] = {false, false};  // k2's, k4's
  if (smem > 32 * 1024 && !smem_allowed[warps == 4]) {
    const cudaError_t e = cudaFuncSetAttribute(warps == 2 ? k2 : k4,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_allowed[warps == 4] = true;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = grid.x;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(32 * warps);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = grid.x > 1 ? 1 : 0;  // unsplit: a plain launch
  return cudaLaunchKernelEx(&config, warps == 2 ? k2 : k4, args...);
}

// Attention of one query head ``q`` (64 bf16 values) over rows [lo, hi) of
// ``rows`` (lo >= hi: no rows, only a split may have none). Frame f of row
// t is frame t * kFrames + f; its score goes to srow[t * kFrames + f] when
// srow is given. The output (64 bf16 values) goes to ``orow``, from the
// block itself or, with n_split > 1 (the split blocks one cluster), from
// the cluster's rank 0 after it merged the splits. 32 * kWarps threads,
// kWarps >= 2.
template <int kWarps, class Rows>
__device__ __forceinline__ void attend(Rows rows, const __nv_bfloat16* __restrict__ q,
                                       int lo, int hi, float scale, float* __restrict__ srow,
                                       __nv_bfloat16* __restrict__ orow, int n_split) {
  constexpr int kL = Rows::kLanes, kV = Rows::kVals, kF = Rows::kFrames;
  constexpr int kGroups = 32 / kL;              // rows a warp reads at once
  constexpr int kPasses = kWarpRows / kGroups;  // reads a warp makes of a tile
  constexpr int kTile = kWarps * kWarpRows;     // rows a tile
  static_assert(kWarps >= 2, "the merge takes 64 threads");
  extern __shared__ __align__(16) unsigned char ring[];  // tile_bytes<kWarps, Rows>()
  auto& tiles = *reinterpret_cast<typename Rows::template Tiles<kTile>*>(ring);
  __shared__ float wm[kWarps], wl[kWarps], wo[kWarps][kHeadDim];
  __shared__ float part[2 + kHeadDim];  // this split's (m, l, o), read by the cluster's rank 0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / kL;    // which of the rows the warp reads at once
  const int chunk = lane % kL;  // which kV of the 64 dims
  const int r0 = warp * kWarpRows;  // the warp's first row in every tile
  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int t0 = lo + i * kTile + r0;
      rows.issue(tiles, i % kStages, r0, t0, min(kWarpRows, hi - t0), lane);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) issue(i);
  rows.prepare();

  float qf[kV];
  rows.q_vals(q, chunk, qf);
  float m = -INFINITY, l = 0.f, acc[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) acc[j] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, t0 = lo + i * kTile + r0;
    const int n = min(kWarpRows, hi - t0);  // the warp's rows of this tile (may be none)
    cp_async_wait_ring();  // this lane's copies of tile i have landed
    __syncwarp();          // and the warp's

    // scores of the warp's rows: kL lanes a row, kGroups rows a read
    float s[kPasses][kF], m_tile = -INFINITY;
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const int r = ps * kGroups + sub;
      float d[kF];
      if (r < n) {
        rows.k_dot(tiles, st, r0 + r, t0 + r, chunk, qf, d);
      } else {
#pragma unroll
        for (int f = 0; f < kF; ++f) d[f] = 0.f;
      }
#pragma unroll
      for (int f = 0; f < kF; ++f) {
#pragma unroll
        for (int o = 1; o < kL; o <<= 1) d[f] += __shfl_xor_sync(0xffffffffu, d[f], o);
        s[ps][f] = r < n ? (d[f] * rows.k_scale(tiles, st, r0 + r, t0 + r, f)) * scale : -INFINITY;
        m_tile = fmaxf(m_tile, s[ps][f]);
      }
    }
    if (srow) {  // gather the warp's scores to lanes 0..16 * kF - 1, store them at once
      const int rl = lane / kF, fl = lane % kF;  // the row and frame this lane stores
      float mine = 0.f;
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps)
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          const float v = __shfl_sync(0xffffffffu, s[ps][f], (rl % kGroups) * kL);
          if (rl / kGroups == ps && fl == f) mine = v;
        }
      if (lane < n * kF) srow[t0 * kF + lane] = mine;
    }
#pragma unroll
    for (int o = kL; o < 32; o <<= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, o));

    // online softmax over the warp's rows; m_new is -inf only while the warp
    // has had no row, and then nothing changes
    const float m_new = fmaxf(m, m_tile);
    if (m_new != -INFINITY) {
      const float alpha = expf(m - m_new);  // 0 while m is -inf
      float e_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kV; ++j) acc[j] *= alpha;
#pragma unroll
      for (int ps = 0; ps < kPasses; ++ps) {
        const int r = ps * kGroups + sub;
        if (r < n) {
          float w[kF];
#pragma unroll
          for (int f = 0; f < kF; ++f) {
            const float e = expf(s[ps][f] - m_new);
            e_sum += e;
            w[f] = e * rows.v_scale(tiles, st, r0 + r, t0 + r, f);
          }
          rows.v_acc(tiles, st, r0 + r, t0 + r, chunk, w, acc);
        }
      }
#pragma unroll
      for (int o = kL; o < 32; o <<= 1) e_sum += __shfl_xor_sync(0xffffffffu, e_sum, o);
      l = l * alpha + e_sum;
      m = m_new;
    }
    __syncwarp();  // the warp's rows of stage st are consumed: refill them
    issue(i + kStages);
  }

  // the warp's row groups share m: their o sum; then the warps merge
#pragma unroll
  for (int j = 0; j < kV; ++j)
#pragma unroll
    for (int o = kL; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  if (sub == 0)
#pragma unroll
    for (int j = 0; j < kV; ++j) wo[warp][chunk * kV + j] = acc[j];
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  float M = -INFINITY, L = 0.f, O = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w]);
  if (tid < kHeadDim) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = wm[w] == -INFINITY ? 0.f : expf(wm[w] - M);  // a warp with no rows adds 0
      L += wl[w] * wt;
      O += wo[w][tid] * wt;
    }
  }
  if (n_split == 1) {
    if (tid < kHeadDim) orow[tid] = __float2bfloat16(O / L);
    return;
  }

  // the splits of (b, h) are one cluster: rank 0 merges their (m, l, o)
  // from each block's shared memory once all are written, and every block
  // stays until it has read them
  if (tid < kHeadDim) part[2 + tid] = O;
  if (tid == 0) {
    part[0] = M;
    part[1] = L;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && tid < kHeadDim) {
    M = -INFINITY;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, *cluster.map_shared_rank(part, s));
    L = O = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* other = cluster.map_shared_rank(part, s);
      const float w = other[0] == -INFINITY ? 0.f : expf(other[0] - M);  // no rows: adds 0
      L += other[1] * w;
      O += other[2 + tid] * w;
    }
    orow[tid] = __float2bfloat16(O / L);
  }
  cluster.sync();
}

}  // namespace decode
}  // namespace wtt

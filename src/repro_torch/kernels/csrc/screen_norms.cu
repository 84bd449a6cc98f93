// Fused TLFre screening statistics, read straight from the grid screen's
// GEMM output C (R, p) through the group spec's padded view (pad_index,
// pad_mask), both (G, n_max): for every row r and group g,
//     snorm2[r, g] = ||S_1(c_{r,g})||^2     (Theorem 15, first branch)
//     cinf[r, g]   = ||c_{r,g}||_inf        (branch selection, second branch)
// where c_{r,g} holds C[r, pad_index[g, k]] at the valid slots k and 0 at
// the masked ones, whatever column their index points at.  R = L on the
// path: the remaining lambda grid, padded to a power of two.
//
// Replaces: src/repro/kernels/screen_norms.py:screen_norms_pallas, together
// with the gather by pad_index and the masking that the reference runs in
// front of it (src/repro/core/screening.py:_grid_group_stats), so the
// (L, G, n_max) padded copy of C is never materialised.
//
// Bound on the card: bytes.  C is read once (4 bytes per valid slot and
// row), pad_index and pad_mask once (9 bytes per slot), and two floats per
// (row, group) pair are written: 6.2 MB at Synthetic 1 (R 128, G 1000,
// n_max 10), 1.86 us at 3.35 TB/s.  So little data is bound by the latency
// of its round trips: the design keeps them few and keeps many loads in
// flight in each.
//
// Design.  A block owns a tile of groups and a chunk of rows.
//  * It stages the tile's pad_index and pad_mask in shared memory once, as
//    int32 columns (-1 for a masked slot), slot-major so that a warp's
//    threads read neighbouring words, and reuses them for every row of its
//    chunk: the index is read once per 8 rows, 1.4 MB from L2 at Synthetic
//    1 instead of 11.5 MB once per row.  Each thread starts all its index
//    loads before it uses one.
//  * n_max <= 32: one thread per (row, group) pair, so every lane is busy
//    whatever n_max is; a block is 32 groups x 8 rows, which gives 512
//    blocks at Synthetic 1.  A thread reads its slots straight from C
//    through the read-only cache.  Neighbouring threads hold neighbouring
//    groups, so for contiguous groups a warp's loads of one slot fall on
//    the few cache lines that its next slots read too; a permuted pad_index
//    simply gathers.  Staging each row's span of C in shared memory first
//    (cp.async, 16 bytes at a time), more rows a thread, larger tiles, and
//    an L1 prefetch or speculative loads of the uniform layout's columns
//    ahead of the index were all slower at the path's shapes on the H100.
//  * n_max > 32: a warp per (row, group) pair, the lanes striding over the
//    slots (coalesced for contiguous groups), reduced by warp shuffles; the
//    group's slots are staged in chunks of 1024.
// No atomics: each output is written by one thread.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmallMax = 32;                     // largest small-path n_max
constexpr int kTileGroups = 32;                   // groups in a small tile
constexpr int kTileRows = kThreads / kTileGroups; // rows in a chunk
constexpr int kSlotLoads = kTileGroups * kSmallMax / kThreads;
constexpr int kLargeRowsPerWarp = 4;
constexpr int kLargeRows = kLargeRowsPerWarp * kWarps;
constexpr int kChunkSlots = 1024;                 // staged slots, large path
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ void accumulate(float v, float& s, float& m) {
  const float a = fabsf(v);
  const float sh = fmaxf(a - 1.0f, 0.0f);
  s = fmaf(sh, sh, s);
  m = fmaxf(m, a);
}

__global__ void __launch_bounds__(kThreads) screen_norms_small(
    const float* __restrict__ C, const int64_t* __restrict__ pad_index,
    const bool* __restrict__ pad_mask, float* __restrict__ snorm2,
    float* __restrict__ cinf, int64_t R, int64_t p, int64_t G, int n_max) {
  __shared__ int cols[kSmallMax * kTileGroups];    // [slot][group]
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kTileGroups;
  const int tg = static_cast<int>(G - g0 < kTileGroups ? G - g0
                                                       : kTileGroups);
  const int n_slots = tg * n_max;
  int64_t sl_index[kSlotLoads];
  bool sl_valid[kSlotLoads];
#pragma unroll
  for (int u = 0; u < kSlotLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    sl_valid[u] = false;
    if (i < n_slots) {
      sl_index[u] = pad_index[g0 * n_max + i];
      sl_valid[u] = pad_mask[g0 * n_max + i];
    }
  }
#pragma unroll
  for (int u = 0; u < kSlotLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < n_slots) {
      cols[(i % n_max) * kTileGroups + i / n_max] =
          sl_valid[u] ? static_cast<int>(sl_index[u]) : -1;
    }
  }
  __syncthreads();
  const int gl = threadIdx.x % kTileGroups;       // the thread's group
  if (gl >= tg) return;                          // no barrier follows
  const int* gcols = cols + gl;
  const int64_t n_chunks = (R + kTileRows - 1) / kTileRows;
  for (int64_t chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
    const int64_t r = chunk * kTileRows + threadIdx.x / kTileGroups;
    if (r >= R) continue;
    const float* row = C + r * p;
    float s = 0.0f;
    float m = 0.0f;
#pragma unroll 2
    for (int k = 0; k < n_max; ++k) {
      const int c = gcols[k * kTileGroups];
      if (c >= 0) accumulate(__ldg(row + c), s, m);
    }
    snorm2[r * G + g0 + gl] = s;
    cinf[r * G + g0 + gl] = m;
  }
}

__global__ void __launch_bounds__(kThreads) screen_norms_large(
    const float* __restrict__ C, const int64_t* __restrict__ pad_index,
    const bool* __restrict__ pad_mask, float* __restrict__ snorm2,
    float* __restrict__ cinf, int64_t R, int64_t p, int64_t G, int n_max) {
  __shared__ int cols[kChunkSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t g = blockIdx.x;
  const int64_t n_chunks = (R + kLargeRows - 1) / kLargeRows;
  for (int64_t chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
    const int64_t r0 = chunk * kLargeRows + warp;
    float s[kLargeRowsPerWarp];
    float m[kLargeRowsPerWarp];
#pragma unroll
    for (int q = 0; q < kLargeRowsPerWarp; ++q) s[q] = m[q] = 0.0f;
    for (int k0 = 0; k0 < n_max; k0 += kChunkSlots) {
      const int kn = min(kChunkSlots, n_max - k0);
      __syncthreads();             // the last slot chunk's reads are done
      for (int i = threadIdx.x; i < kn; i += kThreads) {
        const int64_t sl = g * n_max + k0 + i;
        const int64_t c = pad_index[sl];
        cols[i] = pad_mask[sl] ? static_cast<int>(c) : -1;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kLargeRowsPerWarp; ++q) {
        const int64_t r = r0 + q * kWarps;
        if (r < R) {
          const float* crow = C + r * p;
          for (int i = lane; i < kn; i += 32) {
            const int c = cols[i];
            if (c >= 0) accumulate(__ldg(crow + c), s[q], m[q]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kLargeRowsPerWarp; ++q) {
      for (int off = 16; off > 0; off >>= 1) {
        s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
        m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], off));
      }
      const int64_t r = r0 + q * kWarps;
      if (lane == 0 && r < R) {
        snorm2[r * G + g] = s[q];
        cinf[r * G + g] = m[q];
      }
    }
  }
}

}  // namespace

extern "C" int repro_screen_norms_f32(const float* C,
                                      const int64_t* pad_index,
                                      const bool* pad_mask, float* snorm2,
                                      float* cinf, int64_t R, int64_t p,
                                      int64_t G, int64_t n_max,
                                      cudaStream_t stream) {
  if (R > 0 && G > 0) {
    const int nm = static_cast<int>(n_max);
    if (n_max <= kSmallMax) {
      const int64_t gx = (G + kTileGroups - 1) / kTileGroups;
      int64_t gy = (R + kTileRows - 1) / kTileRows;
      gy = gy < kMaxGridY ? gy : kMaxGridY;
      screen_norms_small<<<dim3(static_cast<unsigned int>(gx),
                                static_cast<unsigned int>(gy)),
                           kThreads, 0, stream>>>(
          C, pad_index, pad_mask, snorm2, cinf, R, p, G, nm);
    } else {
      int64_t gy = (R + kLargeRows - 1) / kLargeRows;
      gy = gy < kMaxGridY ? gy : kMaxGridY;
      screen_norms_large<<<dim3(static_cast<unsigned int>(G),
                                static_cast<unsigned int>(gy)),
                           kThreads, 0, stream>>>(
          C, pad_index, pad_mask, snorm2, cinf, R, p, G, nm);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Fused TLFre screening statistics on the fold-stacked CV layout: for every
// row r of c (R = K*L fold x lambda rows, G groups, n_max slots) and every
// group g, with the ONE validity mask (G, n_max) that all rows share,
//     snorm2[r, g] = ||S_1(c_{r,g})||^2     (Theorem 15, first branch)
//     cinf[r, g]   = ||c_{r,g}||_inf        (branch selection, second branch)
//
// Replaces: src/repro/kernels/screen_norms.py:screen_norms_folds_pallas.
//
// Bound on the card: bytes.  Each slot is read once (4 bytes of c) for a
// handful of operations; the mask is read once per block, and two floats per
// (row, group) pair are written.  At the first SGL CV screen of Synthetic 1
// (K*L = 5*128, G = 1000, n_max = 10) that is 25.6 MB read and 5.1 MB
// written, about 9 us at 3.35 TB/s.
//
// Design.  A block owns a tile of groups and a tile of fold x lambda rows.
// It stages the tile's (groups x n_max) mask in shared memory once and
// reuses it for every row of the tile, so the (K*L, G, n_max) broadcast of
// the mask never exists.
//  * n_max <= 32: one thread per (row, group) pair, so every lane of a warp
//    is busy whatever n_max is (a warp per row would leave 22 of 32 lanes
//    idle at n_max = 10).  The row's slice of the tile, which is contiguous
//    in memory, is first copied into shared memory by all threads with
//    coalesced loads; each thread then reduces its group's n_max slots from
//    there and writes its two floats, coalesced across the warp.
//  * n_max > 32: one block per group; the group's mask row is staged once,
//    and each warp reduces one row at a time, lanes striding over the slots,
//    with warp shuffles.
// Masked slots count as 0 whatever they hold (poisoned padding is
// harmless).  No atomics: each output is written by one thread.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;        // groups in a small-path tile
constexpr int kSmallMax = 32;        // largest n_max of the small path
constexpr int kRowsSmall = 8;        // rows in a small-path tile
constexpr int kWarps = kThreads / 32;
constexpr int kRowsLarge = 64;       // rows in a large-path tile
constexpr int64_t kMaxGridY = 65535;

__global__ void screen_norms_folds_small(const float* __restrict__ c,
                                         const bool* __restrict__ mask,
                                         float* __restrict__ snorm2,
                                         float* __restrict__ cinf, int64_t R,
                                         int64_t G, int n_max) {
  extern __shared__ unsigned char smem[];
  float* c_s = reinterpret_cast<float*>(smem);                  // tile of c
  unsigned char* m_s = smem + sizeof(float) * kThreads * n_max;  // its mask
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int tg = static_cast<int>((G - g0 < kThreads) ? (G - g0) : kThreads);
  const int span = tg * n_max;       // the tile's slots in one row
  const bool* mtile = mask + g0 * n_max;
  for (int i = threadIdx.x; i < span; i += kThreads) m_s[i] = mtile[i];
  const int64_t n_tiles = (R + kRowsSmall - 1) / kRowsSmall;
  for (int64_t t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int64_t r0 = t * kRowsSmall;
    const int64_t r1 = (R < r0 + kRowsSmall) ? R : r0 + kRowsSmall;
    for (int64_t r = r0; r < r1; ++r) {
      __syncthreads();   // the mask is staged; the last row's reads are done
      const float* crow = c + (r * G + g0) * n_max;
      for (int i = threadIdx.x; i < span; i += kThreads) c_s[i] = crow[i];
      __syncthreads();
      if (threadIdx.x < tg) {
        const int base = threadIdx.x * n_max;
        float s = 0.0f;
        float m = 0.0f;
        for (int k = 0; k < n_max; ++k) {
          const float a = m_s[base + k] ? fabsf(c_s[base + k]) : 0.0f;
          const float sh = fmaxf(a - 1.0f, 0.0f);
          s = fmaf(sh, sh, s);
          m = fmaxf(m, a);
        }
        snorm2[r * G + g0 + threadIdx.x] = s;
        cinf[r * G + g0 + threadIdx.x] = m;
      }
    }
  }
}

__global__ void screen_norms_folds_large(const float* __restrict__ c,
                                         const bool* __restrict__ mask,
                                         float* __restrict__ snorm2,
                                         float* __restrict__ cinf, int64_t R,
                                         int64_t G, int n_max) {
  extern __shared__ unsigned char m_s[];      // the group's mask row
  const int64_t g = blockIdx.x;
  for (int k = threadIdx.x; k < n_max; k += kThreads) {
    m_s[k] = mask[g * n_max + k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_tiles = (R + kRowsLarge - 1) / kRowsLarge;
  for (int64_t t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int64_t r1 = (R < (t + 1) * kRowsLarge) ? R : (t + 1) * kRowsLarge;
    for (int64_t r = t * kRowsLarge + warp; r < r1; r += kWarps) {
      const float* crow = c + (r * G + g) * n_max;
      float s = 0.0f;
      float m = 0.0f;
      for (int k = lane; k < n_max; k += 32) {
        const float a = m_s[k] ? fabsf(crow[k]) : 0.0f;
        const float sh = fmaxf(a - 1.0f, 0.0f);
        s = fmaf(sh, sh, s);
        m = fmaxf(m, a);
      }
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (lane == 0) {
        snorm2[r * G + g] = s;
        cinf[r * G + g] = m;
      }
    }
  }
}

}  // namespace

extern "C" int repro_screen_norms_folds_f32(const float* c, const bool* mask,
                                            float* snorm2, float* cinf,
                                            int64_t R, int64_t G,
                                            int64_t n_max,
                                            cudaStream_t stream) {
  if (R > 0 && G > 0 && n_max > 0) {
    const int nm = static_cast<int>(n_max);
    if (n_max <= kSmallMax) {
      const int64_t gx = (G + kThreads - 1) / kThreads;
      int64_t gy = (R + kRowsSmall - 1) / kRowsSmall;
      gy = gy < kMaxGridY ? gy : kMaxGridY;
      const size_t shared = (sizeof(float) + 1) * kThreads * n_max;
      screen_norms_folds_small<<<dim3(static_cast<unsigned int>(gx),
                                      static_cast<unsigned int>(gy)),
                                 kThreads, shared, stream>>>(
          c, mask, snorm2, cinf, R, G, nm);
    } else {
      int64_t gy = (R + kRowsLarge - 1) / kRowsLarge;
      gy = gy < kMaxGridY ? gy : kMaxGridY;
      screen_norms_folds_large<<<dim3(static_cast<unsigned int>(G),
                                      static_cast<unsigned int>(gy)),
                                 kThreads, static_cast<size_t>(n_max),
                                 stream>>>(c, mask, snorm2, cinf, R, G, nm);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

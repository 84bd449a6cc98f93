// Fused TLFre screening statistics on the padded group layout: for every
// row r of c (R, n_max), with the validity mask of row r % G,
//     snorm2[r] = ||S_1(c_r)||^2     (Theorem 15, first branch)
//     cinf[r]   = ||c_r||_inf        (branch selection, second branch)
// R = L*G on the path: the remaining lambda grid folded into the group axis.
//
// Replaces: src/repro/kernels/screen_norms.py:screen_norms_pallas.
//
// Bound on the card: bytes.  Each slot is read once (4 bytes of c, 1 byte
// of mask at most) for a handful of operations, and two floats per row are
// written.
//
// Design: one warp per row; the lanes stride over n_max, so a warp reads a
// row's contiguous slots together, and the row sum and max are taken by
// warp shuffles, with no shared memory and no atomics.  The mask is read as
// mask[r % G], so the (L*G, n_max) broadcast copy of the mask that the TPU
// wrapper materialises never exists.  Masked slots count as 0 whatever they
// hold (poisoned padding is harmless).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void screen_norms_kernel(const float* __restrict__ c,
                                    const bool* __restrict__ mask,
                                    float* __restrict__ snorm2,
                                    float* __restrict__ cinf, int64_t R,
                                    int64_t G, int64_t n_max) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warps leave together
  const float* crow = c + row * n_max;
  const bool* mrow = mask + (row % G) * n_max;
  float s = 0.0f;
  float m = 0.0f;
  for (int64_t k = lane; k < n_max; k += 32) {
    const float a = mrow[k] ? fabsf(crow[k]) : 0.0f;
    const float sh = fmaxf(a - 1.0f, 0.0f);
    s = fmaf(sh, sh, s);
    m = fmaxf(m, a);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (lane == 0) {
    snorm2[row] = s;
    cinf[row] = m;
  }
}

}  // namespace

extern "C" int repro_screen_norms_f32(const float* c, const bool* mask,
                                      float* snorm2, float* cinf, int64_t R,
                                      int64_t G, int64_t n_max,
                                      cudaStream_t stream) {
  if (R > 0) {
    const int64_t blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
    screen_norms_kernel<<<static_cast<unsigned int>(blocks),
                          kWarpsPerBlock * 32, 0, stream>>>(
        c, mask, snorm2, cinf, R, G, n_max);
  }
  return static_cast<int>(cudaGetLastError());
}

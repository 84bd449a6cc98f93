// Fused two-level SGL prox on the padded group layout (G, n_max):
//     u     = S_{t_l1}(v)                         elementwise
//     n_g   = ||u_g||_2                           row reduce
//     out_g = (1 - t_group_g / n_g)_+ u_g         row scale
// Masked slots are treated as 0 and written as 0.
//
// Replaces: src/repro/kernels/sgl_prox.py:sgl_prox_pallas.
//
// Bound on the card: bytes (one read of v and the mask, one write of out,
// a few operations a slot).  At the path's shapes the call is small, and
// its launch, once per FISTA iteration, is what it costs.
//
// Design: one warp per group.  The lanes stride over n_max: a first pass
// shrinks and sums u^2, a warp shuffle gives the norm, a second pass
// recomputes u (cheaper than holding it) and writes the scaled value.
// t_l1 is read from a 1-element device tensor, so the solver never reads
// it on the host.  Nothing is allocated and nothing synchronises.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float soft(float x, float t) {
  const float a = fmaxf(fabsf(x) - t, 0.0f);
  return (x > 0.0f) ? a : ((x < 0.0f) ? -a : 0.0f);
}

__global__ void sgl_prox_kernel(const float* __restrict__ v,
                                const bool* __restrict__ mask,
                                const float* __restrict__ t_l1_ptr,
                                const float* __restrict__ t_group,
                                float* __restrict__ out, int64_t G,
                                int64_t n_max) {
  const int lane = threadIdx.x & 31;
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= G) return;  // whole warps leave together
  const float t_l1 = *t_l1_ptr;
  const float* vrow = v + g * n_max;
  const bool* mrow = mask + g * n_max;
  float* orow = out + g * n_max;
  float s = 0.0f;
  for (int64_t k = lane; k < n_max; k += 32) {
    const float u = mrow[k] ? soft(vrow[k], t_l1) : 0.0f;
    s = fmaf(u, u, s);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  const float norm = sqrtf(s);
  const float tg = t_group[g];
  const float scale =
      (norm > tg) ? (1.0f - tg / ((norm > 0.0f) ? norm : 1.0f)) : 0.0f;
  for (int64_t k = lane; k < n_max; k += 32) {
    const float u = mrow[k] ? soft(vrow[k], t_l1) : 0.0f;
    orow[k] = u * scale;
  }
}

}  // namespace

extern "C" int repro_sgl_prox_f32(const float* v, const bool* mask,
                                  const float* t_l1, const float* t_group,
                                  float* out, int64_t G, int64_t n_max,
                                  cudaStream_t stream) {
  if (G > 0) {
    const int64_t blocks = (G + kWarpsPerBlock - 1) / kWarpsPerBlock;
    sgl_prox_kernel<<<static_cast<unsigned int>(blocks), kWarpsPerBlock * 32,
                      0, stream>>>(v, mask, t_l1, t_group, out, G, n_max);
  }
  return static_cast<int>(cudaGetLastError());
}

// Fused two-level SGL prox on the flat coefficient vector v (p,), through
// the group spec's padded view (pad_index, pad_mask), both (G, n_max):
//     u_gk  = S_{t_l1}(v[pad_index[g, k]])        valid slots; masked are 0
//     n_g   = ||u_g||_2                            group reduce
//     out[pad_index[g, k]] = (1 - t_group_g / n_g)_+ u_gk
//     out[j] = 0 for every column j that no valid slot covers
// This is the composition gather -> prox on the padded layout -> scatter-add
// onto zeros, in one launch (each column is covered by at most one valid
// slot, which GroupSpec checks when it is built, so a plain store is the
// scatter-add; adding +0 turns a -0 into the +0 that 0 + (-0) gives).
//
// Replaces: src/repro/kernels/sgl_prox.py:sgl_prox_pallas, together with
// the gather and scatter around it (src/repro/core/path_engine.py
// _padded_prox).
//
// Bound on the card: at the path's shapes (G <= a few thousand, n_max ~ 10)
// the bytes take nanoseconds, and what the call costs is its launch, once
// per FISTA iteration.  So the design keeps it to one launch and keeps
// every lane of a launched warp busy.
//
// Design: a group is a segment of P lanes, P = the next power of two of
// n_max, at most 32, so a warp holds 32 / P groups (n_max = 10 packs 2
// groups a warp, n_max = 1 packs 32).  Lane k of a segment takes slots k,
// k + P, ...; the segment's sum of u^2 is reduced by xor shuffles with
// offsets below P, which never cross segments.  Each lane keeps its first
// slot's u in registers until the store (for n_max <= 32 the only one), so
// a group costs one dependent gather; wider groups recompute the rest.
// Blocks past the groups' blocks zero the uncovered columns (the garbage
// bin's columns past n_max in a bucketed spec), read from the spec's (p,)
// bool mask: a fixed shape, so the launch can be captured in a CUDA graph
// and replayed for any spec of the same bucket.  t_l1 is read from a
// 1-element device tensor, so the solver never reads it on the host.
// Nothing is allocated and nothing synchronises.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float soft(float x, float t) {
  const float a = fmaxf(fabsf(x) - t, 0.0f);
  return (x > 0.0f) ? a : ((x < 0.0f) ? -a : 0.0f);
}

__global__ void sgl_prox_flat_kernel(
    const float* __restrict__ v, const int64_t* __restrict__ pad_index,
    const bool* __restrict__ pad_mask, const bool* __restrict__ uncovered,
    const float* __restrict__ t_l1_ptr, const float* __restrict__ t_group,
    float* __restrict__ out, int64_t G, int64_t n_max, int64_t p, int seg,
    int64_t group_blocks) {
  if (static_cast<int64_t>(blockIdx.x) >= group_blocks) {
    const int64_t j =
        (static_cast<int64_t>(blockIdx.x) - group_blocks) * kThreads +
        threadIdx.x;
    if (j < p && uncovered[j]) out[j] = 0.0f;
    return;                                   // whole block leaves
  }
  const int groups_per_block = kThreads / seg;
  const int k0 = threadIdx.x % seg;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * groups_per_block +
                    threadIdx.x / seg;
  const bool live = g < G;
  const float t_l1 = *t_l1_ptr;
  const float tg = live ? t_group[g] : 0.0f;
  const int64_t* irow = pad_index + g * n_max;
  const bool* mrow = pad_mask + g * n_max;
  // the lane's first slot stays in registers from the reduction to the
  // store (for n_max <= 32 it is the lane's only slot)
  const bool has0 = live && k0 < n_max && mrow[k0];
  const int64_t j0 = has0 ? irow[k0] : 0;
  const float u0 = has0 ? soft(v[j0], t_l1) : 0.0f;
  float s = __fmul_rn(u0, u0);
  if (live) {
    for (int64_t k = k0 + seg; k < n_max; k += seg) {
      if (mrow[k]) {
        const float u = soft(v[irow[k]], t_l1);
        s = fmaf(u, u, s);
      }
    }
  }
  // every lane of the warp reaches the shuffles; offsets < seg stay inside
  // the segment
  for (int off = seg >> 1; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (!live) return;
  const float norm = sqrtf(s);
  const float scale =
      (norm > tg) ? (1.0f - tg / ((norm > 0.0f) ? norm : 1.0f)) : 0.0f;
  if (has0) out[j0] = __fadd_rn(__fmul_rn(u0, scale), 0.0f);
  for (int64_t k = k0 + seg; k < n_max; k += seg) {
    if (mrow[k]) {
      const int64_t j = irow[k];
      const float u = soft(v[j], t_l1);
      out[j] = __fadd_rn(__fmul_rn(u, scale), 0.0f);
    }
  }
}

}  // namespace

extern "C" int repro_sgl_prox_f32(const float* v, const int64_t* pad_index,
                                  const bool* pad_mask, const bool* uncovered,
                                  const float* t_l1, const float* t_group,
                                  float* out, int64_t G, int64_t n_max,
                                  int64_t p, cudaStream_t stream) {
  int seg = 1;
  while (seg < n_max && seg < 32) seg <<= 1;
  const int64_t groups_per_block = kThreads / seg;
  const int64_t group_blocks = (G + groups_per_block - 1) / groups_per_block;
  const int64_t col_blocks = (p + kThreads - 1) / kThreads;
  const int64_t blocks = group_blocks + col_blocks;
  if (blocks > 0) {
    sgl_prox_flat_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           stream>>>(v, pad_index, pad_mask, uncovered, t_l1,
                                     t_group, out, G, n_max, p, seg,
                                     group_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

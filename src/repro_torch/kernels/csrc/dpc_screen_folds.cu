// Fused Theorem-22 (DPC) grid rule on the fold-stacked CV layout:
//     keep[k, l, i] = C[k, l, i] + radii[k, l] * col_norms[k, i] >= 1
// for C (K, L, p) float32, radii (K, L), col_norms (K, p), written as a
// 1-byte bool keep mask (K, L, p).
//
// Replaces: src/repro/kernels/screen_norms.py:dpc_screen_folds_pallas.
//
// Bound on the card: bytes.  An elementwise pass: 4 bytes of C read and
// 1 byte of keep written per element, for a multiply, an add and a compare.
// At the first nonnegative-Lasso CV screen (K = 5, L = 128, p = 10 000)
// that is 25.6 MB read and 6.4 MB written, about 9.6 us at 3.35 TB/s.  The
// TPU kernel writes float32 0/1 and compares > 0.5 afterwards, four times
// the output bytes; here the mask is written once, as bool.
//
// Design: one thread per (fold, column) over a tile of kRows lambda rows.
// The thread loads its column norm once and reuses it for every row it
// walks; neighbour threads take neighbour columns, so the loads of C and
// the stores of keep are coalesced.  The ragged tail of p is masked here:
// C is read in place, neither padded nor copied.
//
// Rounding: the product and the sum are rounded separately
// (__fmul_rn, then __fadd_rn), so the compare sees exactly the plain
// C + r * cn of the reference.  nvcc would otherwise contract the two into
// one fmaf, which rounds once: a borderline omega then lands on the other
// side of 1 and a feature flips, where the result is held to exact equality.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;             // lambda rows a thread walks
constexpr int64_t kMaxGridY = 65535;

__global__ void dpc_screen_folds_kernel(const float* __restrict__ C,
                                        const float* __restrict__ radii,
                                        const float* __restrict__ col_norms,
                                        bool* __restrict__ keep, int64_t L,
                                        int64_t p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p) return;
  const int64_t k = blockIdx.z;
  const float cn = col_norms[k * p + i];
  const int64_t n_tiles = (L + kRows - 1) / kRows;
  for (int64_t t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int64_t l1 = (L < (t + 1) * kRows) ? L : (t + 1) * kRows;
    for (int64_t l = t * kRows; l < l1; ++l) {
      const int64_t at = (k * L + l) * p + i;
      const float omega = __fadd_rn(C[at], __fmul_rn(radii[k * L + l], cn));
      keep[at] = omega >= 1.0f;
    }
  }
}

}  // namespace

extern "C" int repro_dpc_screen_folds_f32(const float* C, const float* radii,
                                          const float* col_norms, bool* keep,
                                          int64_t K, int64_t L, int64_t p,
                                          cudaStream_t stream) {
  if (K > 0 && L > 0 && p > 0) {
    const int64_t gx = (p + kThreads - 1) / kThreads;
    int64_t gy = (L + kRows - 1) / kRows;
    gy = gy < kMaxGridY ? gy : kMaxGridY;
    dpc_screen_folds_kernel<<<dim3(static_cast<unsigned int>(gx),
                                   static_cast<unsigned int>(gy),
                                   static_cast<unsigned int>(K)),
                              kThreads, 0, stream>>>(C, radii, col_norms,
                                                     keep, L, p);
  }
  return static_cast<int>(cudaGetLastError());
}

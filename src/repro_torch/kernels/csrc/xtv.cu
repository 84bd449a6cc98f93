// out = X^T v for a row-major float32 X (N, p) and v (N,): the full-X
// certification GEMV of the SGL path engine.
//
// Replaces: src/repro/kernels/xtv.py:xtv_pallas (the TPU kernel).
//
// Bound on the card: bytes.  The GEMV does 2*N*p operations on 4*N*p bytes
// of X, half an operation per byte, so it runs at the memory rate
// (N=250, p=10 000: 10 MB, about 3 us at 3.35 TB/s; N=747, p=100 000:
// 299 MB, about 89 us).
//
// Design: one thread per output column j, looping over the N rows.  Neighbour
// threads read neighbour columns of one row, so every load of X is coalesced
// and X is read exactly once, in place: no copy and no padding of X (the TPU
// wrapper pads X on every call).  v is staged through shared memory in
// chunks of the block size.  The ragged tail j >= p is masked.  Each column
// is summed by one thread in row order, in float32, with no atomics, so the
// result is deterministic.  With 256 threads a block, p = 10 000 gives only
// 40 blocks for 132 SMs; splitting N across blocks is later work.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void xtv_kernel(const float* __restrict__ X,
                           const float* __restrict__ v,
                           float* __restrict__ out, int64_t N, int64_t p) {
  __shared__ float v_s[kThreads];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float acc = 0.0f;
  for (int64_t base = 0; base < N; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    v_s[threadIdx.x] = (i < N) ? v[i] : 0.0f;
    __syncthreads();
    const int64_t rows = (N - base < kThreads) ? (N - base) : kThreads;
    if (j < p) {
      const float* xrow = X + base * p + j;
      for (int64_t r = 0; r < rows; ++r) {
        acc = fmaf(xrow[r * p], v_s[r], acc);
      }
    }
    __syncthreads();
  }
  if (j < p) out[j] = acc;
}

}  // namespace

extern "C" int repro_xtv_f32(const float* X, const float* v, float* out,
                             int64_t N, int64_t p, cudaStream_t stream) {
  if (p > 0) {
    const int64_t blocks = (p + kThreads - 1) / kThreads;
    xtv_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
        X, v, out, N, p);
  }
  return static_cast<int>(cudaGetLastError());
}

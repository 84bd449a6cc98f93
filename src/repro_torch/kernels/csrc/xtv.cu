// out = X^T v for a row-major float32 X (N, p) and v (N,): the full-X
// certification GEMV of the SGL and nonnegative-Lasso path engines.
//
// Replaces: src/repro/kernels/xtv.py:xtv_pallas (the TPU kernel).
//
// Bound on the card: bytes.  The GEMV does 2*N*p operations on 4*N*p bytes
// of X, half an operation per byte, so it runs at the memory rate
// (N=250, p=10 000: 10 MB, about 3 us at 3.35 TB/s; N=747, p=100 000:
// 299 MB, about 89 us).
//
// Design: a block of 256 threads owns a tile of 32 columns.  Its threads
// form 32 row lanes x 8 column lanes; each column lane owns 4 neighbouring
// columns and reads them as one 128-bit float4 load, so a warp reads 4 rows
// x 128 contiguous bytes per load, and the 32 row lanes split N between
// them (row lane r takes rows r, r+32, ...).  A thread issues its rows in
// chunks of 4 predicated loads before it uses any of them, so 4 loads per
// thread are in flight (a plain unrolled loop leaves its remainder rows to
// one load at a time, a DRAM round trip each).
// The 32 row lanes' partial sums meet in shared memory and one thread per
// column adds them in row-lane order.  A tile of 32 columns gives p/32
// blocks: at p = 10 000 that is 313 blocks, over two waves of 132 SMs.  Where
// columns alone give fewer than two waves (p < 8448), N is also cut into S
// chunks across blocks: each chunk's sums go to a (S, p) buffer, and a
// second, small pass adds the S chunks of each column in chunk order.
// Every sum is taken in a fixed order and nothing is added atomically, so
// the result is the same on every run.  X is read in place, never copied or
// padded (the TPU wrapper pads X on every call); the ragged tail of p is
// masked; rows that are not 16-byte aligned (p % 4 != 0, or an unaligned
// base) take a scalar path with the same order of sums.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kColLanes = 8;                         // 4 columns each
constexpr int kRowLanes = kThreads / kColLanes;      // 32
constexpr int kTile = 4 * kColLanes;                 // 32 columns a block
constexpr int kMinBlocks = 2 * 132;                  // two waves of SMs
constexpr int kUnroll = 4;                           // rows in flight

template <bool kVec>
__global__ void xtv_kernel(const float* __restrict__ X,
                           const float* __restrict__ v,
                           float* __restrict__ out, int64_t N, int64_t p,
                           int64_t rows_per_chunk) {
  __shared__ float part[kRowLanes][kTile];
  const int cl = threadIdx.x % kColLanes;
  const int rl = threadIdx.x / kColLanes;
  const int64_t tile = blockIdx.x;
  const int64_t chunk = blockIdx.y;
  const int64_t j0 = tile * kTile + 4 * cl;         // first of 4 columns
  const int64_t r_begin = chunk * rows_per_chunk;
  const int64_t r_end =
      (r_begin + rows_per_chunk < N) ? r_begin + rows_per_chunk : N;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  if (j0 < p) {
    for (int64_t base = r_begin + rl; base < r_end;
         base += kUnroll * kRowLanes) {
      float4 x[kUnroll];
      float vi[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kRowLanes;
        const bool in = i < r_end;
        vi[u] = in ? __ldg(v + i) : 0.0f;
        if (kVec) {
          x[u] = in ? *reinterpret_cast<const float4*>(X + i * p + j0)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
          const float* row = X + i * p + j0;
          x[u].x = in ? __ldg(row) : 0.0f;
          x[u].y = (in && j0 + 1 < p) ? __ldg(row + 1) : 0.0f;
          x[u].z = (in && j0 + 2 < p) ? __ldg(row + 2) : 0.0f;
          x[u].w = (in && j0 + 3 < p) ? __ldg(row + 3) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a0 = fmaf(x[u].x, vi[u], a0);
        a1 = fmaf(x[u].y, vi[u], a1);
        a2 = fmaf(x[u].z, vi[u], a2);
        a3 = fmaf(x[u].w, vi[u], a3);
      }
    }
  }
  part[rl][4 * cl + 0] = a0;
  part[rl][4 * cl + 1] = a1;
  part[rl][4 * cl + 2] = a2;
  part[rl][4 * cl + 3] = a3;
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int64_t j = tile * kTile + threadIdx.x;
    if (j < p) {
      float s = 0.0f;
#pragma unroll 8
      for (int r = 0; r < kRowLanes; ++r) s += part[r][threadIdx.x];
      out[chunk * p + j] = s;   // chunk 0 only, unless N is split
    }
  }
}

// out[j] = sum over the S chunks of partial[s, j], in chunk order.
__global__ void xtv_sum_chunks(const float* __restrict__ partial,
                               float* __restrict__ out, int64_t p,
                               int64_t S) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= p) return;
  float s = 0.0f;
  for (int64_t c = 0; c < S; ++c) s += partial[c * p + j];
  out[j] = s;
}

}  // namespace

// The number of row chunks the kernel cuts N into at (N, p): 1 where the
// column tiles alone fill two waves of SMs.  The caller allocates an
// (S, p) float32 scratch buffer when it is more than 1.
extern "C" int64_t repro_xtv_chunks(int64_t N, int64_t p) {
  const int64_t tiles = (p + kTile - 1) / kTile;
  if (tiles <= 0 || tiles >= kMinBlocks) return 1;
  int64_t S = (kMinBlocks + tiles - 1) / tiles;
  const int64_t max_by_rows = (N + kRowLanes - 1) / kRowLanes;  // >= 32 rows
  if (S > max_by_rows) S = max_by_rows;
  return S < 1 ? 1 : S;
}

extern "C" int repro_xtv_f32(const float* X, const float* v, float* out,
                             float* partial, int64_t N, int64_t p,
                             cudaStream_t stream) {
  if (p <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t S = repro_xtv_chunks(N, p);
  const int64_t rows_per_chunk = (N + S - 1) / S;
  const dim3 grid(static_cast<unsigned int>((p + kTile - 1) / kTile),
                  static_cast<unsigned int>(S));
  float* dst = (S > 1) ? partial : out;
  const bool vec = (p % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(X) % 16 == 0);
  if (vec) {
    xtv_kernel<true><<<grid, kThreads, 0, stream>>>(X, v, dst, N, p,
                                                    rows_per_chunk);
  } else {
    xtv_kernel<false><<<grid, kThreads, 0, stream>>>(X, v, dst, N, p,
                                                     rows_per_chunk);
  }
  if (S > 1) {
    xtv_sum_chunks<<<static_cast<unsigned int>((p + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(partial, out, p, S);
  }
  return static_cast<int>(cudaGetLastError());
}

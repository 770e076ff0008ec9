// Pairwise base-kernel evaluation: out = K(X, Y), (n, m) in float32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/kernel_tile/kernel_tile.py::kernel_tile
//   (_l2_body and _l1_body).
//
// Shapes: x (n, d), y (m, d) float32, row-major and contiguous (the
// wrapper casts, as the reference pins float32) -> out (n, m) float32.
//
// Bound on the H100: at the gate's shape (n = m = 16,384, d = 54) the
// 2.7e8 entries cost ~3.0e10 flops (~0.45 ms at 67 TFLOP/s) against
// 1.07 GB written (~0.32 ms at 3.35 TB/s): operations, narrowly; at
// smaller d it turns to bytes.
//
// Design: the distance tile of kernel_matvec.cu (pair_tile.cuh: a block
// owns a 64 x 64 output tile, features staged 32 at a time, summed
// directly), with the epilogue applied in registers and written out in
// place of the contraction.  Where the TPU kernel accumulates over a grid
// axis of feature tiles and applies the epilogue on the last one, the
// block loops over the features itself.  Neighbouring threads write
// neighbouring columns; entries past n or m are not written.
#include <cuda_runtime.h>

#include "kernel_epilogue.cuh"
#include "pair_tile.cuh"

namespace {

using pair_tile::BM;
using pair_tile::BN;
using pair_tile::kThreads;
using pair_tile::TM;
using pair_tile::TN;

template <bool L1>
__global__ void __launch_bounds__(kThreads)
kernel_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int n, int m, int d, int kind,
                   float sigma) {
  __shared__ float staged[pair_tile::kStageElems];
  float* xs = staged;
  float* ys = staged + pair_tile::DC * pair_tile::LDX;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  float dist[TM][TN];
  pair_tile::distances<float, L1>(x, y, n, m, d, r0, c0, xs, ys, dist);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < m)
        out[static_cast<size_t>(row) * m + col] =
            kernel_epilogue(kind, dist[i][j], sigma);
    }
  }
}

}  // namespace

extern "C" int kernel_tile_f32(const void* x, const void* y, void* out, int n,
                               int m, int d, int kind, double sigma,
                               void* stream) {
  if (n == 0 || m == 0) return 0;
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* yp = static_cast<const float*>(y);
  auto* op = static_cast<float*>(out);
  if (kind == KIND_LAPLACE)
    kernel_tile_kernel<true><<<grid, kThreads, 0, s>>>(
        xp, yp, op, n, m, d, kind, static_cast<float>(sigma));
  else
    kernel_tile_kernel<false><<<grid, kThreads, 0, s>>>(
        xp, yp, op, n, m, d, kind, static_cast<float>(sigma));
  return static_cast<int>(cudaGetLastError());
}

// One block's tile of pairwise distances between BM rows of X and BN rows
// of Y, summed directly over the features: sum (x - y)^2 for the squared
// Euclidean kernels (gaussian, imq), sum |x - y| for laplace.  Shared by
// kernel_matvec.cu (B10) and kernel_tile.cu (B11), which apply the
// base-kernel epilogue of kernel_epilogue.cuh to the tile and then
// contract it (B10) or write it out (B11).
//
// Layout: 256 threads as a 16 x 16 grid; thread (ty, tx) owns the 4 x 4
// micro-tile of rows ty + 16 i and columns tx + 16 j (i, j < 4), so that
// neighbouring threads read neighbouring shared-memory words and write
// neighbouring output columns.  The features are staged DC at a time,
// transposed (feature-major, odd row stride), so a feature row of the
// tile is one conflict-free shared-memory read per thread and any d is
// taken in chunks: no row of d ever has to fit whole.  Rows past nx or ny
// stage zeros and the chunk loop stops at d: ragged tails in the rows and
// the features are masked, never padded in device memory.  Offsets into X
// and Y are 64-bit.
#pragma once

#include <cuda_runtime.h>

namespace pair_tile {

constexpr int kThreads = 256;   // 16 x 16
constexpr int TM = 4;           // rows of a thread's micro-tile
constexpr int TN = 4;           // columns of a thread's micro-tile
constexpr int BM = 16 * TM;     // rows of X per block tile
constexpr int BN = 16 * TN;     // rows of Y per block tile
constexpr int DC = 32;          // features staged per chunk
constexpr int LDX = BM + 1;     // stride of a staged feature row of X
constexpr int LDY = BN + 1;     // and of Y

__device__ __forceinline__ float fused_ma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused_ma(double a, double b, double c) {
  return fma(a, b, c);
}

// Elements of shared memory the two staged chunks take.
constexpr int kStageElems = DC * (LDX + LDY);

// Stage rows [r0, r0 + rows_tile) x features [f0, f0 + fc) of the
// row-major (n, d) array a into s (feature-major, row stride ld); rows at
// or past n are zeros.  Neighbouring threads read neighbouring features.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ a, int n, int d,
                                      int r0, int f0, int fc, int rows_tile,
                                      int ld, T* s) {
  for (int e = threadIdx.x; e < rows_tile * DC; e += kThreads) {
    const int r = e / DC, f = e % DC;
    if (f < fc) {
      const int row = r0 + r;
      s[f * ld + r] =
          row < n ? a[static_cast<size_t>(row) * d + f0 + f] : T(0);
    }
  }
}

// dist[i][j] = the distance between X row r0 + ty + 16 i and Y row
// c0 + tx + 16 j over all d features (L1: Manhattan, else squared
// Euclidean).  xs and ys hold kStageElems elements of shared memory; the
// function synchronises the block before each staging, so the caller may
// reuse any other shared memory freely once it returns.
template <typename T, bool L1>
__device__ __forceinline__ void distances(const T* __restrict__ x,
                                          const T* __restrict__ y, int nx,
                                          int ny, int d, int r0, int c0,
                                          T* xs, T* ys, T (&dist)[TM][TN]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) dist[i][j] = T(0);
  for (int f0 = 0; f0 < d; f0 += DC) {
    const int fc = min(DC, d - f0);
    __syncthreads();                 // the previous chunk's readers are done
    stage(x, nx, d, r0, f0, fc, BM, LDX, xs);
    stage(y, ny, d, c0, f0, fc, BN, LDY, ys);
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < fc; ++f) {
      T xv[TM], yv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[f * LDX + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) yv[j] = ys[f * LDY + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const T diff = xv[i] - yv[j];
          if (L1)
            dist[i][j] += diff < T(0) ? -diff : diff;
          else
            dist[i][j] = fused_ma(diff, diff, dist[i][j]);
        }
    }
  }
}

}  // namespace pair_tile

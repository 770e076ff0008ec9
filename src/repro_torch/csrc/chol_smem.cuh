// Block-cooperative Cholesky factorization of one SPD tile held in shared
// memory, shared by the gram_chol (build_stage.cu), gram_chol_dist
// (build_dist.cu) and leaf_update (leaf_update.cu) kernels; leaf_factor.cu
// takes its chol_sqrt.  The CUDA counterpart of
// src/repro/kernels/build_stage/build_stage.py::_cholesky_in_vmem.
//
// The TPU body extracts each column with one-hot contractions because
// Mosaic cannot slice dynamically; here every thread indexes the tile
// directly.  Right-looking, one column per step:
//   1. every thread reads the pivot a[j][j] and takes its square root --
//      no clamp, so a tile that is not positive definite gives NaN (the
//      reference's loud failure mode, build_stage.py:85-86);
//   2. the threads scale column j below the diagonal by 1 / pivot;
//   3. the trailing lower triangle takes the rank-1 update
//      a[i][c] -= a[i][j] * a[c][j] for j < c <= i, one warp per row i and
//      lanes over c, so the row writes and the column-j reads (stride lda)
//      fall on distinct banks when lda is odd.
// Two barriers per column; m steps.  On return the upper triangle is zero
// and every thread sees the whole factor.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float chol_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double chol_sqrt(double v) { return sqrt(v); }

template <typename T>
__device__ void chol_smem(T* a, int m, int lda) {
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  for (int j = 0; j < m; ++j) {
    __syncthreads();                    // step j-1's update is complete
    const T pivot = chol_sqrt(a[j * lda + j]);
    for (int i = j + 1 + tid; i < m; i += nth) a[i * lda + j] /= pivot;
    __syncthreads();                    // column j is final, pivot read
    if (tid == 0) a[j * lda + j] = pivot;
    for (int i = j + 1 + warp; i < m; i += nwarps) {
      const T lij = a[i * lda + j];
      for (int c = j + 1 + lane; c <= i; c += 32)
        a[i * lda + c] -= lij * a[c * lda + j];
    }
  }
  __syncthreads();
  for (int e = tid; e < m * m; e += nth) {
    const int i = e / m;
    const int c = e - i * m;
    if (c > i) a[i * lda + c] = T(0);
  }
  __syncthreads();
}

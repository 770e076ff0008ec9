// Per-leaf products of a row-major matrix in device memory with a small
// k-column block in shared memory, shared by the leaf_matvec and
// leaf_update kernels.  Both read the big matrix with neighbouring threads
// on neighbouring addresses:
//   rows_times  out = M in:    one warp per row of M, lanes over the row,
//               KT outputs per lane in registers, reduced with shuffles;
//   cols_times  out = M^T in:  one thread per column of M, rows in turn,
//               the matching row of `in` read by all threads at one
//               address (a broadcast).
// `in` has row stride ldi; an odd stride (k | 1) keeps the lanes of
// rows_times on distinct banks.
#pragma once

#include <cuda_runtime.h>

constexpr int KT = 8;

// out[i][q] (+)= sum_j M[i][j] in[j][q] for i < rows, j < cols: one warp
// per row of the row-major M (stride cols)
template <typename T>
__device__ void rows_times(const T* __restrict__ M, int rows, int cols,
                           const T* in, int ldi, T* out, int ldo, int k,
                           bool add) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows; i += blockDim.x >> 5) {
    const T* mrow = M + static_cast<size_t>(i) * cols;
    for (int q0 = 0; q0 < k; q0 += KT) {
      const int kt = min(KT, k - q0);
      T acc[KT];
#pragma unroll
      for (int q = 0; q < KT; ++q) acc[q] = T(0);
      for (int j = lane; j < cols; j += 32) {
        const T mij = mrow[j];
        const T* ij = in + j * ldi + q0;
#pragma unroll
        for (int q = 0; q < KT; ++q)
          if (q < kt) acc[q] += mij * ij[q];
      }
#pragma unroll
      for (int q = 0; q < KT; ++q) {
        if (q >= kt) break;
        T s = acc[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) {
          T* o = out + i * ldo + q0 + q;
          *o = add ? *o + s : s;
        }
      }
    }
  }
}

// out[j][q] = sum_i M[i][j] in[i][q] for j < cols, i < rows: one thread per
// column of the row-major M (stride cols)
template <typename T>
__device__ void cols_times(const T* __restrict__ M, int rows, int cols,
                           const T* in, int ldi, T* out, int ldo, int k) {
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    for (int q0 = 0; q0 < k; q0 += KT) {
      const int kt = min(KT, k - q0);
      T acc[KT];
#pragma unroll
      for (int q = 0; q < KT; ++q) acc[q] = T(0);
      for (int i = 0; i < rows; ++i) {
        const T mij = M[static_cast<size_t>(i) * cols + j];
        const T* ii = in + i * ldi + q0;
#pragma unroll
        for (int q = 0; q < KT; ++q)
          if (q < kt) acc[q] += mij * ii[q];
      }
#pragma unroll
      for (int q = 0; q < KT; ++q)
        if (q < kt) out[j * ldo + q0 + q] = acc[q];
    }
  }
}

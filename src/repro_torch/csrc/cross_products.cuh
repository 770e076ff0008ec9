// The register-tiled products U = K Linv^T Linv of one row tile, shared by
// the cross_solve (build_stage.cu) and cross_solve_dist (build_dist.cu)
// kernels: the CUDA counterpart of the two dot_generals that end
// src/repro/kernels/build_stage/build_stage.py::_cross_solve_body and
// ::_cross_solve_dist_body.
//
// A block of TY x TX = 256 threads owns a tile of BM = TY * MR rows; each
// thread owns an MR x NR register tile of the (BM, r) output, rows
// ty + TY a and columns tx + TX b (interleaved at stride 16), so r <= TX *
// NR = 128.  The caller stages the node's whole Linv (r, r) and the
// tile's kernel values K (BM, r), rows past the tile's end zero, in shared
// memory at row stride ldr = r + 1.  Y = K Linv^T is accumulated in
// registers and written over K, then U = Y Linv is accumulated in
// registers; each step loads MR + NR values for MR * NR multiply-adds.
// Both products are full (they do not skip Linv's zero upper triangle),
// as the plain version's are.
#pragma once

#include <cuda_runtime.h>

namespace cross_tile {

constexpr int kThreads = 256;
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NR = 8;

// Stage the row-major (r, r) Linv into shared rows of stride r + 1.
template <typename T>
__device__ void stage_linv(T* li, const T* __restrict__ src, int r) {
  for (int e = threadIdx.x; e < r * r; e += blockDim.x)
    li[(e / r) * (r + 1) + e % r] = src[e];
}

// This thread's output columns tx + TX b; a column past r reads column
// r - 1 (in bounds) and is never stored.
__device__ __forceinline__ void columns(int* col, int r) {
  const int tx = threadIdx.x % TX;
#pragma unroll
  for (int b = 0; b < NR; ++b) col[b] = min(tx + TX * b, r - 1);
}

// acc = K Linv^T Linv for this thread's MR x NR tile.  On entry K and
// Linv are staged (the function synchronises before reading them); on
// return ka holds Y = K Linv^T.
template <typename T, int MR>
__device__ void products(T* ka, const T* li, int r, const int* col,
                         T (&acc)[MR][NR]) {
  const int ldr = r + 1;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < NR; ++b) acc[a][b] = T(0);
  __syncthreads();                      // K and Linv are staged

  // Y = K Linv^T: Y[i][s] = sum_t K[i][t] Linv[s][t]
  for (int t = 0; t < r; ++t) {
    T kv[MR], lv[NR];
#pragma unroll
    for (int a = 0; a < MR; ++a) kv[a] = ka[(ty + TY * a) * ldr + t];
#pragma unroll
    for (int b = 0; b < NR; ++b) lv[b] = li[col[b] * ldr + t];
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < NR; ++b) acc[a][b] += kv[a] * lv[b];
  }
  __syncthreads();                      // every read of K is done
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < NR; ++b) {
      if (tx + TX * b < r) ka[(ty + TY * a) * ldr + tx + TX * b] = acc[a][b];
      acc[a][b] = T(0);
    }
  __syncthreads();

  // U = Y Linv: U[i][c] = sum_s Y[i][s] Linv[s][c]
  for (int s = 0; s < r; ++s) {
    T yv[MR], lv[NR];
#pragma unroll
    for (int a = 0; a < MR; ++a) yv[a] = ka[(ty + TY * a) * ldr + s];
#pragma unroll
    for (int b = 0; b < NR; ++b) lv[b] = li[s * ldr + col[b]];
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < NR; ++b) acc[a][b] += yv[a] * lv[b];
  }
}

// Write the first ``rows`` rows of this thread's tile to the row-major
// (., r) output u.
template <typename T, int MR>
__device__ void store(T* __restrict__ u, int rows, int r,
                      T (&acc)[MR][NR]) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < NR; ++b) {
      const int i = ty + TY * a;
      if (i < rows && tx + TX * b < r)
        u[static_cast<size_t>(i) * r + tx + TX * b] = acc[a][b];
    }
}

}  // namespace cross_tile

// The panel form of the blocked Cholesky factorization (chol_blocked.cuh)
// for tiles too large to hold in shared memory: the factor of B3's
// leaf_factor_panel (leaf_factor.cu), B1's gram_chol_levels_panel
// (build_stage.cu) and B8's gram_chol_dist_levels_panel (build_dist.cu),
// m up to kMaxM = 512 in float32 and float64 (the resident forms stop at
// m 235-240 in float32 and 163-169 in float64).
//
// One block of 128 threads a tile.  The tile lives in its output buffer in
// device memory (row stride m), where the caller has put its lower
// triangle, and is read back through L2; only the current panel of NB = 32
// columns (its rows from the panel's diagonal down, at row stride NB + 1)
// and the m reciprocal pivots are in shared memory, 139.5 KB at m 512 in
// float64.  Per panel:
//   1. the panel is staged with cp.async (the diagonal block's lower
//      triangle, zeros above it);
//   2. warp 0 factors the 32 x 32 diagonal block with chol_blocked.cuh's
//      factor_diag, and all threads solve the rows below by forward
//      substitution (forward_pass), both on the staged panel;
//   3. the panel is written back (its lower part);
//   4. A22 -= L21 L21^T on the lower triangle, in chol_blocked.cuh's
//      register tiles (4 rows x 4 columns a thread), A22 read from and
//      written to device memory, L21 from the staged panel.
// B3's triangular inverse X = L^-1 follows in the same panels, by block
// columns from the right as leaf_factor.cu's resident kernel takes it
// (Du Croz and Higham): block column j0's panel of L is staged, and each
// row of X solves x L_jj = e - sum_k X[r][k] L[k][j0 + c] by back
// substitution, X's columns right of the panel read from device memory.
// Semantics are the resident forms': only the lower triangle is factored,
// no pivot is clamped (a tile that is not positive definite gives NaN),
// and each block reads only its own tile.
#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "chol_blocked.cuh"

namespace chol_panel {

using chol_blocked::fmadd;
using chol_blocked::kFull;
using chol_blocked::kGroups;
using chol_blocked::kPassRows;
using chol_blocked::kThreads;
using chol_blocked::kWarps;
using chol_blocked::NB;

constexpr int kMaxM = 512;       // the largest tile (2 r at rank 256)
constexpr int LDP = NB + 1;      // row stride of the staged panel

// Shared memory of the panel factor of an (m, m) tile: the panel (m, LDP),
// the m reciprocal pivots and the diagonal factor's column buffer.
__host__ __device__ constexpr size_t smem_bytes(int m, size_t item) {
  return chol_blocked::col_offset(m, LDP, item) + NB * item;
}

// Stage rows j0 .. m - 1 of columns j0 .. j0 + w - 1 of the (m, m) tile A
// into pan (row i at pan + i LDP), the diagonal block's upper triangle
// zero-filled; commits and waits, then a barrier.
template <typename T>
__device__ __forceinline__ void stage_panel(T* pan, const T* A, int m,
                                            int j0, int w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < w)
    for (int i = warp; i < m - j0; i += kWarps) {
      const bool ok = lane <= i;
      acopy::element(pan + i * LDP + lane,
                     A + static_cast<size_t>(j0 + i) * m + j0 + (ok ? lane : 0),
                     ok);
    }
  acopy::commit();
  acopy::wait<0>();
  __syncthreads();
}

// Step 4 on rows p0 + rg + 16 i (i < NII) and columns cb + cg + 8 j of the
// (m, m) tile A in device memory: A[r][c] -= sum_k L21[r][k] L21[c][k] for
// c <= r, L21 (rows kb.., w columns) the staged panel.
template <int NII, typename T>
__device__ __forceinline__ void update_pass(T* A, const T* pan, int kb, int w,
                                            int cb, int p0, int m) {
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  int rows[NII], cols[4], pr[NII], pc[4];  // pr, pc: offsets into pan
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    cols[jj] = cb + cg + 8 * jj;
    pc[jj] = (min(cols[jj], m - 1) - kb) * LDP;
  }
  T acc[NII][4];
#pragma unroll
  for (int i = 0; i < NII; ++i) {
    rows[i] = p0 + rg + kGroups * i;
    const int r = min(rows[i], m - 1);
    pr[i] = (r - kb) * LDP;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      acc[i][jj] = cols[jj] <= r ? A[static_cast<size_t>(r) * m + cols[jj]]
                                 : T(0);
  }
#pragma unroll 4
  for (int k = 0; k < w; ++k) {
    T lc[4], li[NII];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) lc[jj] = pan[pc[jj] + k];
#pragma unroll
    for (int i = 0; i < NII; ++i) li[i] = pan[pr[i] + k];
#pragma unroll
    for (int i = 0; i < NII; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        acc[i][jj] = fmadd(-li[i], lc[jj], acc[i][jj]);
  }
#pragma unroll
  for (int i = 0; i < NII; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (rows[i] < m && cols[jj] <= rows[i])
        A[static_cast<size_t>(rows[i]) * m + cols[jj]] = acc[i][jj];
}

// Steps 1-4 over every panel: on entry A's lower triangle holds the tile
// (the caller's barrier follows its writes), on return L, with rdiag[i] =
// 1 / L_ii; the function ends in a barrier.  The upper triangle of A is
// neither read nor written.
template <typename T>
__device__ void factor(T* A, int m, T* pan, T* rdiag, T* col) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kb = 0; kb < m; kb += NB) {
    const int w = min(NB, m - kb), rows = m - kb;
    stage_panel(pan, A, m, kb, w);
    if (warp == 0)
      chol_blocked::factor_diag(pan, LDP, rdiag + kb, col, 0, w, lane);
    __syncthreads();                  // L11 and its pivots are final
    if (rows > w) {
      for (int p0 = w; p0 < rows; p0 += kPassRows)
        LEAF_PASS(chol_blocked::forward_pass, p0, rows, pan, LDP,
                  rdiag + kb, 0, w, p0, rows);
      __syncthreads();                // L21 is final
    }
    if (lane < w)
      for (int i = warp; i < rows; i += kWarps)
        if (lane <= i)
          A[static_cast<size_t>(kb + i) * m + kb + lane] = pan[i * LDP + lane];
    for (int cb = kb + w; cb < m; cb += NB)
      for (int p0 = cb; p0 < m; p0 += kPassRows)
        LEAF_PASS(update_pass, p0, m, A, pan, kb, w, cb, p0, m);
    __syncthreads();                  // the panel and A22 are in A
  }
}

// The inverse on rows p0 + rg + 16 i (i < NII) of block column j0 (w
// wide): rhs = e_(r - j0) - sum_{k >= j0 + w} X[r][k] L[k][j0 + c] (X is
// zero above its diagonal, so k stops at the row's own group), then
// x L_jj = rhs by back substitution, column w - 1 first; L's block column
// is the staged panel, X (row stride m) is in device memory.  The pass
// reads X only right of the block column it writes.
template <int NII, typename T>
__device__ __forceinline__ void inverse_pass(T* X, const T* pan,
                                             const T* rdiag, int j0, int w,
                                             int p0, int m) {
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  const int src0 = (tid & 31) & ~7;
  int rows[NII];
  const T* xr[NII];
  T x[NII][4];
#pragma unroll
  for (int i = 0; i < NII; ++i) {
    rows[i] = p0 + rg + kGroups * i;
    xr[i] = X + static_cast<size_t>(min(rows[i], m - 1)) * m;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      x[i][jj] = (rows[i] - j0 == cg + 8 * jj) ? T(1) : T(0);
  }
  int lc[4];                               // L[k][j0 + c] = pan[lc + k LDP]
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) lc[jj] = min(cg + 8 * jj, w - 1) - j0 * LDP;
#pragma unroll
  for (int t = -1; t < NII; ++t) {
    const int k0 = t < 0 ? j0 + w : max(j0 + w, p0 + kGroups * t);
    const int k1 = t < 0 ? p0 : min(m, p0 + kGroups * (t + 1));
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      T l[4], xv[NII];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) l[jj] = pan[lc[jj] + k * LDP];
#pragma unroll
      for (int i = 0; i < NII; ++i)
        if (i >= t) xv[i] = xr[i][k];
#pragma unroll
      for (int i = 0; i < NII; ++i)
        if (i >= t)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            x[i][jj] = fmadd(-xv[i], l[jj], x[i][jj]);
    }
  }
#pragma unroll
  for (int co = 3; co >= 0; --co) {      // column c = 8 co + c8
#pragma unroll 1
    for (int c8 = 7; c8 >= 0; --c8) {
      const int c = 8 * co + c8;
      if (c >= w) continue;
      const T rc = rdiag[j0 + c];
      T lck[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k = cg + 8 * jj;
        lck[jj] = (k < c) ? pan[c * LDP + k] : T(0);
      }
#pragma unroll
      for (int i = 0; i < NII; ++i) {
        const T xc = __shfl_sync(kFull, x[i][co], src0 + c8) * rc;
        if (cg == c8) x[i][co] = xc;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (cg + 8 * jj < c) x[i][jj] = fmadd(-xc, lck[jj], x[i][jj]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NII; ++i) {
    if (rows[i] >= m) continue;
    T* r = X + static_cast<size_t>(rows[i]) * m + j0;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (cg + 8 * jj < w) r[cg + 8 * jj] = x[i][jj];
  }
}

// X = L^-1 (both (m, m) in device memory, L from factor(), rdiag its
// reciprocal pivots): block columns from the right.  On entry X's strict
// upper triangle must be zero (the caller writes it before a barrier).
// Ends in a barrier.
template <typename T>
__device__ void inverse(const T* L, T* X, int m, T* pan, const T* rdiag) {
  for (int j0 = ((m - 1) / NB) * NB; j0 >= 0; j0 -= NB) {
    const int w = min(NB, m - j0);
    stage_panel(pan, L, m, j0, w);
    for (int p0 = j0; p0 < m; p0 += kPassRows)
      LEAF_PASS(inverse_pass, p0, m, X, pan, rdiag, j0, w, p0, m);
    __syncthreads();                  // block column j0 of X is in X
  }
}

}  // namespace chol_panel

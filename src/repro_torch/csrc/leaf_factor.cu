// Leaf Schur-complement factorization of Algorithm 2 (repro.core.hmatrix
// invert / invert_with_leaf): per leaf p, the SPD block D_p (n0, n0) ->
// L_p = chol(D_p) and L_p^-1, both lower triangular (D^-1 = L^-T L^-1).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hck_leaf/hck_leaf.py::hck_leaf_factor
//   (_factor_body, _tri_inv_in_vmem).
//
// Shapes: dleaf (P, n0, n0) -> lo, linv (P, n0, n0), row-major and
// contiguous; T is float or double and every sum is taken in T.  Only the
// lower triangle of D is read; both outputs hold zeros above the diagonal.
//
// Bound on the H100: bytes at the covtype shape (P = 4,096, n0 = 128,
// f32): 679 MB (the lower triangle of D read in the 32-byte sectors its
// rows touch, L and L^-1 written whole), ~0.20 ms at 3.35 TB/s, against
// ~5.7 GFLOP (n0^3 / 3 for the factor, n0^3 / 3 for the inverse,
// ~0.09 ms at the f32 CUDA-core rate).  Each leaf is a chain of dependent
// steps, so the kernel is bound by that chain's latency unless the card
// runs many leaves side by side; no tensor cores (the work is below the
// bytes bound).
//
// One block per leaf.  The tile is staged with cp.async into shared
// memory at an odd row stride (column reads by a warp fall on distinct
// banks) and factored in panels of NB = 32 columns, the last one ragged:
//   1. warp 0 factors the 32 x 32 diagonal block in registers, lane i
//      holding row i: each pivot's square root and reciprocal (stored),
//      the column scaled by it and passed to every lane through a small
//      shared buffer (no block barrier); the next pivot is computed while
//      the column is in flight;
//   2. all threads compute the panel below, L21 = A21 L11^-T, by forward
//      substitution on each row (not by a product with an inverse, which
//      would lose the componentwise backward-error bound);
//   3. all threads apply A22 -= L21 L21^T to the lower triangle only, in
//      register tiles.
// Then L^-1 = X by block columns from the right (Du Croz and Higham,
// "Stability of methods for matrix inversion", IMA J. Numer. Anal. 12,
// 1992: the method that bounds the left residual |X L - I|): block column
// j solves X_(:,j) L_jj = [I; -sum_{k>j} X_(:,k) L_(k,j)] by back
// substitution on each row, so every row of X is a substitution with the
// computed L and |X L - I| <= c n0 eps |X| |L| entry by entry.
//
// A block has 128 threads, so that three leaves of n0 = 128 (66.5 KB of
// shared memory each in f32) share an SM and one leaf's serial steps
// overlap the others' work.  A thread owns 4 rows x 4 columns of a
// 32-column panel (rows rg + 16 i, columns cg + 8 j); the 8 lanes of a row
// group pass each solved column by __shfl_sync.  Three barriers per panel
// of the factor and two or three per block column of the inverse, against
// two per column (2 n0 in all) in the column-by-column design this kernel
// replaced, and a dependent chain of O(n0) steps per leaf in place of
// O(n0^2).  The step loops stay loops (the fully unrolled panels do not
// fit the instruction cache).  Shared memory: the (n0, n0 | 1) tile, n0
// reciprocal pivots and a column buffer of 32, so n0 <= 240 in f32 and
// <= 169 in f64; larger leaves, up to 512, take the panel form
// (leaf_factor_panel.cu, the tile in device memory).
//
// No pivot is clamped: a block that is not positive definite gives NaN.
// Each block reads only its own leaf, so a leaf's factors do not
// depend on the launch it is part of (invert_multi relies on that).
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "chol_blocked.cuh"
#include "kernel_epilogue.cuh"

namespace {

using namespace chol_blocked;

constexpr int kMinBlocksF32 = 3;          // n0 = 128 f32 blocks an SM holds

// The inverse on rows p0 + rg + 16 i (i < NII) of block column j0 (w
// wide): rhs = e_(r - j0) - sum_{k >= j0 + w} X[r][k] L[k][j0 + c] (X is
// zero above its diagonal, so k stops at the row's own group), then
// x L_jj = rhs by back substitution, column w - 1 first.  The caller's
// rows of the panel are overwritten after a barrier: the other threads
// still read L there.
template <int NII, typename T>
__device__ __forceinline__ void inverse_pass(T* a, int lda, const T* rdiag,
                                             int j0, int w, int p0, int n0) {
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  const int src0 = (tid & 31) & ~7;
  int rows[NII], xr[NII];                  // xr, lc: offsets into a
  T x[NII][4];
#pragma unroll
  for (int i = 0; i < NII; ++i) {
    rows[i] = p0 + rg + kGroups * i;
    xr[i] = min(rows[i], n0 - 1) * lda;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      x[i][jj] = (rows[i] - j0 == cg + 8 * jj) ? T(1) : T(0);
  }
  int lc[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) lc[jj] = j0 + min(cg + 8 * jj, w - 1);
  // k above this pass's rows feeds every row group; k in the pass's row
  // group t feeds groups t and below only (X is zero above its diagonal)
#pragma unroll
  for (int t = -1; t < NII; ++t) {
    const int k0 = t < 0 ? j0 + w : max(j0 + w, p0 + kGroups * t);
    const int k1 = t < 0 ? p0 : min(n0, p0 + kGroups * (t + 1));
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      T l[4], xv[NII];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) l[jj] = a[lc[jj] + k * lda];
#pragma unroll
      for (int i = 0; i < NII; ++i)
        if (i >= t) xv[i] = a[xr[i] + k];
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
        lck[jj] = (k < c) ? a[(j0 + c) * lda + j0 + k] : T(0);
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
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NII; ++i) {
    if (rows[i] >= n0) continue;
    T* r = a + rows[i] * lda + j0;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (cg + 8 * jj < w) r[cg + 8 * jj] = x[i][jj];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 4 ? kMinBlocksF32 : 1)
leaf_factor_kernel(const T* __restrict__ dleaf, T* __restrict__ lo,
                           T* __restrict__ linv, int n0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = n0 | 1;
  T* a = reinterpret_cast<T*>(smem_raw);              // (n0, lda)
  T* rdiag = a + n0 * lda;                            // (n0,)
  T* col = reinterpret_cast<T*>(smem_raw + col_offset(n0, lda, sizeof(T)));
  const size_t off = static_cast<size_t>(blockIdx.x) * n0 * n0;
  const T* src = dleaf + off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int r = warp; r < n0; r += kWarps)
    for (int c = lane; c < n0; c += 32) {
      if (c <= r)
        acopy::element(a + r * lda + c, src + static_cast<size_t>(r) * n0 + c,
                       true);
      else
        a[r * lda + c] = T(0);
    }
  acopy::commit();
  acopy::wait<0>();
  __syncthreads();

  factor_panels(a, lda, rdiag, col, n0);
  T* lout = lo + off;
  for (int r = warp; r < n0; r += kWarps)
    for (int c = lane; c < n0; c += 32)
      lout[static_cast<size_t>(r) * n0 + c] = a[r * lda + c];

  // Bottom passes first: a pass reads L of its block column only in rows
  // at or above its own, so once the lower pass has stored X the upper
  // one may still read the rows it needs.
  for (int j0 = ((n0 - 1) / NB) * NB; j0 >= 0; j0 -= NB) {
    const int w = min(NB, n0 - j0);
    for (int p0 = j0 + ((n0 - j0 - 1) / kPassRows) * kPassRows; p0 >= j0;
         p0 -= kPassRows)
      LEAF_PASS(inverse_pass, p0, n0, a, lda, rdiag, j0, w, p0, n0);
    __syncthreads();                  // block column j0 of X is final
  }
  T* xout = linv + off;
  for (int r = warp; r < n0; r += kWarps)
    for (int c = lane; c < n0; c += 32)
      xout[static_cast<size_t>(r) * n0 + c] = a[r * lda + c];
}

template <typename T>
int launch(const void* dleaf, void* lo, void* linv, int p, int n0,
           void* stream) {
  if (p == 0 || n0 == 0) return 0;
  const auto kernel = leaf_factor_kernel<T>;
  const size_t smem = col_offset(n0, n0 | 1, sizeof(T)) + NB * sizeof(T);
  const int err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<p, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dleaf), static_cast<T*>(lo),
      static_cast<T*>(linv), n0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The resident kernel's entries; leaf_factor_panel.cu compiles this file
// with REPRO_PANEL_ENTRIES for the panel form's.
#ifndef REPRO_PANEL_ENTRIES

extern "C" int leaf_factor_f32(const void* dleaf, void* lo, void* linv,
                               int p, int n0, void* stream) {
  return launch<float>(dleaf, lo, linv, p, n0, stream);
}

extern "C" int leaf_factor_f64(const void* dleaf, void* lo, void* linv,
                               int p, int n0, void* stream) {
  return launch<double>(dleaf, lo, linv, p, n0, stream);
}

#endif  // REPRO_PANEL_ENTRIES

// Leaf Schur-complement factorization of Algorithm 2 (repro.core.hmatrix
// invert / invert_with_leaf): per leaf p, the SPD block D_p (n0, n0) ->
// L_p = chol(D_p) and L_p^-1, both lower triangular (D^-1 = L^-T L^-1).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hck_leaf/hck_leaf.py::hck_leaf_factor
//   (_factor_body, _tri_inv_in_vmem).
//
// Shapes: dleaf (P, n0, n0) -> lo, linv (P, n0, n0), row-major and
// contiguous; T is float or double and every sum is taken in T.
//
// Bound on the H100: bytes at the covtype shape (P = 4,096, n0 = 128,
// f32): 805 MB (D read, L and L^-1 written), ~0.24 ms at 3.35 TB/s,
// against ~4 GFLOP (n0^3 / 3 for the factor, n0^3 / 3 for the inverse).
// Each block's two m-step sequential loops make it latency-bound per block;
// the card hides that with several blocks per SM (66 KB of shared memory
// each in f32, so three per SM).
//
// Design: one block per leaf.  The tile is loaded with coalesced copies
// into shared memory (row stride n0 + 1), factored in place by the shared
// right-looking Cholesky (chol_smem.cuh: no pivot clamp, NaN for a block
// that is not positive definite) and written as L.  Then L is inverted in
// place, one row at a time by forward substitution:
//   X[i][c] = (delta_ic - sum_{k=c}^{i-1} L[i][k] X[k][c]) / L[i][i],
// with row i of L copied to a buffer first, since rows < i already hold X
// and row i is overwritten; threads take the columns c <= i.  One tile
// only: n0 (n0 + 1) + n0 values, so n0 <= 240 in f32 and <= 169 in f64
// (the wrapper raises beyond).
#include <cuda_runtime.h>

#include "chol_smem.cuh"
#include "kernel_epilogue.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
leaf_factor_kernel(const T* __restrict__ dleaf, T* __restrict__ lo,
                   T* __restrict__ linv, int n0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = n0 + 1;
  T* a = reinterpret_cast<T*>(smem_raw);              // (n0, lda)
  T* row = a + static_cast<size_t>(n0) * lda;         // (n0,)
  const size_t off = static_cast<size_t>(blockIdx.x) * n0 * n0;
  const int tid = threadIdx.x;
  const int nn = n0 * n0;

  for (int e = tid; e < nn; e += blockDim.x)
    a[(e / n0) * lda + e % n0] = dleaf[off + e];
  chol_smem(a, n0, lda);
  for (int e = tid; e < nn; e += blockDim.x)
    lo[off + e] = a[(e / n0) * lda + e % n0];

  for (int i = 0; i < n0; ++i) {
    __syncthreads();                    // row i - 1 of X is complete
    for (int c = tid; c <= i; c += blockDim.x) row[c] = a[i * lda + c];
    __syncthreads();
    const T pivot = row[i];
    for (int c = tid; c <= i; c += blockDim.x) {
      T s = (c == i) ? T(1) : T(0);
      for (int k = c; k < i; ++k) s -= row[k] * a[k * lda + c];
      a[i * lda + c] = s / pivot;
    }
  }
  __syncthreads();
  for (int e = tid; e < nn; e += blockDim.x)
    linv[off + e] = a[(e / n0) * lda + e % n0];
}

template <typename T>
int launch(const void* dleaf, void* lo, void* linv, int p, int n0,
           void* stream) {
  if (p == 0 || n0 == 0) return 0;
  const size_t smem = (static_cast<size_t>(n0) * (n0 + 1) + n0) * sizeof(T);
  const int err = launch_with_smem(leaf_factor_kernel<T>, smem);
  if (err) return err;
  leaf_factor_kernel<T><<<p, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dleaf), static_cast<T*>(lo),
      static_cast<T*>(linv), n0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int leaf_factor_f32(const void* dleaf, void* lo, void* linv,
                               int p, int n0, void* stream) {
  return launch<float>(dleaf, lo, linv, p, n0, stream);
}

extern "C" int leaf_factor_f64(const void* dleaf, void* lo, void* linv,
                               int p, int n0, void* stream) {
  return launch<double>(dleaf, lo, linv, p, n0, stream);
}

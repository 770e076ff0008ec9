// Bordered extension of the leaf Schur-complement factors (the online
// update, repro.core.hmatrix.invert_extend): a leaf whose ridged Schur
// complement A11 = L L^T grew by k appended rows, with cross block B
// (k, n0) and appended block C (k, k), gets
//
//   L21   = B L^-T = B Linv^T           (k, n0)
//   S     = C - L21 L21^T                (k, k)
//   L22   = chol(S),  L22^-1
//   L'    = [[L, 0], [L21, L22]]
//   Linv' = [[Linv, 0], [-L22^-1 (L21 Linv), L22^-1]]
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/update_stage/update_stage.py::hck_leaf_update
//   (_update_body).
//
// Shapes: lo, linv (P, n0, n0) lower triangular (linv = lo^-1), b (P, k,
// n0), c (P, k, k) -> lo_ext, linv_ext (P, n0 + k, n0 + k), all row-major
// and contiguous; T is float or double and every sum is taken in T.  The
// leading (n0, n0) quadrants are COPIED from the inputs, never recomputed,
// so they are bit-identical to them and removing the k rows again is an
// exact truncation; the upper-right (n0, k) blocks are zero.  An appended
// S that is not positive definite gives NaN (no pivot clamp), as the
// reference's Cholesky does.
//
// Bound on the H100: bytes.  At covtype width after one update round
// (P = 4,096, n0 = 128, k = 13, f32) it reads 537 MB (lo and linv) and
// writes 651 MB (the two extended factors), ~0.355 ms at 3.35 TB/s;
// its ~2 k n0^2 flops per leaf are negligible beside them.
//
// Design: one block per leaf, in five steps.  B^T is staged in shared
// memory, one column per appended row (row stride k | 1, odd):
//   1. L21^T = Linv B^T: one warp per row of Linv, lanes over its
//      columns, the row read once from device memory and coalesced
//      (leaf_products.cuh rows_times); Linv's zero upper triangle adds 0;
//   2. S = C - L21 L21^T, one thread per entry of S;
//   3. L22 = chol(S) in place (chol_smem.cuh);
//   4. X = L22^-1 by forward substitution, one row at a time, threads over
//      its columns: X[i][c] = (delta_ic - sum_{c<=t<i} L22[i][t] X[t][c])
//      / L22[i][i];
//   5. T^T = Linv^T L21^T (cols_times: one thread per column of Linv, its
//      rows in turn), then Linv21 = -X T, one thread per entry.
// Then the block writes both extended factors row by row, neighbouring
// threads on neighbouring addresses: the old quadrant from the input, the
// border from shared memory.  Shared memory holds 3 n0 (k | 1) + 2 k (k +
// 1) values: at n0 + k = 208 (k = 16) about 40 KB in f32; the wrapper
// raises where a block would need more than 227 KB.
#include <cuda_runtime.h>

#include "chol_smem.cuh"
#include "kernel_epilogue.cuh"
#include "leaf_products.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
leaf_update_kernel(const T* __restrict__ lo, const T* __restrict__ linv,
                   const T* __restrict__ b, const T* __restrict__ c,
                   T* __restrict__ lo_ext, T* __restrict__ linv_ext, int n0,
                   int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = k | 1;
  T* bt = reinterpret_cast<T*>(smem_raw);             // (n0, ldk): B^T
  T* l21t = bt + static_cast<size_t>(n0) * ldk;       // (n0, ldk): L21^T
  T* tt = l21t + static_cast<size_t>(n0) * ldk;       // (n0, ldk): T^T
  T* s = tt + static_cast<size_t>(n0) * ldk;          // (k, k + 1): S, L22
  T* x = s + k * (k + 1);                             // (k, k + 1): L22^-1
  const size_t leaf = blockIdx.x;
  const int tid = threadIdx.x;
  const T* L = lo + leaf * n0 * n0;
  const T* Li = linv + leaf * n0 * n0;
  const T* B = b + leaf * k * n0;
  const T* C = c + leaf * k * k;

  for (int e = tid; e < k * n0; e += blockDim.x) {
    const int i = e / n0, j = e - (e / n0) * n0;
    bt[j * ldk + i] = B[e];
  }
  __syncthreads();
  // 1. L21^T[j][i] = sum_t Linv[j][t] B[i][t]
  rows_times(Li, n0, n0, bt, ldk, l21t, ldk, k, false);
  __syncthreads();
  // 2. S = C - L21 L21^T
  for (int e = tid; e < k * k; e += blockDim.x) {
    const int i = e / k, j = e - (e / k) * k;
    T acc = T(0);
    for (int t = 0; t < n0; ++t) acc += l21t[t * ldk + i] * l21t[t * ldk + j];
    s[i * (k + 1) + j] = C[e] - acc;
  }
  // 3. L22 = chol(S) (synchronises first)
  chol_smem(s, k, k + 1);
  // 4. X = L22^-1, row by row
  for (int i = 0; i < k; ++i) {
    const T pivot = s[i * (k + 1) + i];
    for (int col = tid; col <= i; col += blockDim.x) {
      T acc = (col == i) ? T(1) : T(0);
      for (int t = col; t < i; ++t)
        acc -= s[i * (k + 1) + t] * x[t * (k + 1) + col];
      x[i * (k + 1) + col] = acc / pivot;
    }
    for (int col = i + 1 + tid; col < k; col += blockDim.x)
      x[i * (k + 1) + col] = T(0);
    __syncthreads();                    // row i of X is complete
  }
  // 5. T^T[m][i] = sum_j Linv[j][m] L21^T[j][i]  (T = L21 Linv)
  cols_times(Li, n0, n0, l21t, ldk, tt, ldk, k);
  __syncthreads();

  const int ne = n0 + k;
  T* Lo = lo_ext + leaf * ne * ne;
  T* Lio = linv_ext + leaf * ne * ne;
  for (size_t e = tid; e < static_cast<size_t>(ne) * ne; e += blockDim.x) {
    const int row = static_cast<int>(e / ne);
    const int col = static_cast<int>(e - static_cast<size_t>(row) * ne);
    T vl, vi;
    if (row < n0) {
      const bool old = col < n0;
      vl = old ? L[static_cast<size_t>(row) * n0 + col] : T(0);
      vi = old ? Li[static_cast<size_t>(row) * n0 + col] : T(0);
    } else {
      const int i = row - n0;
      if (col < n0) {
        vl = l21t[col * ldk + i];
        // Linv21[i][col] = -sum_{t <= i} X[i][t] T[t][col]
        T acc = T(0);
        for (int t = 0; t <= i; ++t) acc += x[i * (k + 1) + t] * tt[col * ldk + t];
        vi = -acc;
      } else {
        vl = s[i * (k + 1) + col - n0];
        vi = x[i * (k + 1) + col - n0];
      }
    }
    Lo[e] = vl;
    Lio[e] = vi;
  }
}

template <typename T>
int launch(const void* lo, const void* linv, const void* b, const void* c,
           void* lo_ext, void* linv_ext, int p, int n0, int k, void* stream) {
  if (p == 0) return 0;
  const size_t smem = (3 * static_cast<size_t>(n0) * (k | 1)
                       + 2 * static_cast<size_t>(k) * (k + 1)) * sizeof(T);
  const int err = launch_with_smem(leaf_update_kernel<T>, smem);
  if (err) return err;
  leaf_update_kernel<T><<<p, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lo), static_cast<const T*>(linv),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(lo_ext), static_cast<T*>(linv_ext), n0, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int leaf_update_f32(const void* lo, const void* linv,
                               const void* b, const void* c, void* lo_ext,
                               void* linv_ext, int p, int n0, int k,
                               void* stream) {
  return launch<float>(lo, linv, b, c, lo_ext, linv_ext, p, n0, k, stream);
}

extern "C" int leaf_update_f64(const void* lo, const void* linv,
                               const void* b, const void* c, void* lo_ext,
                               void* linv_ext, int p, int n0, int k,
                               void* stream) {
  return launch<double>(lo, linv, b, c, lo_ext, linv_ext, p, n0, k, stream);
}

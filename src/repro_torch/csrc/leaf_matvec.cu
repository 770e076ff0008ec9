// Fused leaf stage of the HCK matvec (Algorithm 1, repro.core.hmatrix
// matvec), per leaf p:
//
//   y_p = A_p b_p   (n0, k)        c_p = U_p^T b_p   (r, k)
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hck_leaf/hck_leaf.py::hck_leaf_matvec (_matvec_body).
//
// Shapes: adiag (P, n0, n0), u (P, n0, r), b (P, n0, k) -> y (P, n0, k),
// c (P, r, k); row-major and contiguous; T is float or double and every
// sum is taken in T.  A is not assumed symmetric.
//
// Bound on the H100: bytes.  A and U are read once and dominate: at the
// covtype shape (P = 4,096, n0 = r = 128, k = 7, f32) 581 MB, ~0.17 ms at
// 3.35 TB/s, against 0.06 GFLOP.
//
// Design: one block per leaf; b_p is staged in shared memory (row stride
// k | 1).  The TPU grid tiles the leaf's rows and carries c across the row
// tiles; on the card no state crosses blocks, so the block walks all rows
// itself: y = A b one warp per row of A, c = U^T b one thread per column
// of U (leaf_products.cuh), each written straight to device memory.
#include <cuda_runtime.h>

#include "kernel_epilogue.cuh"
#include "leaf_products.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
leaf_matvec_kernel(const T* __restrict__ adiag, const T* __restrict__ u,
                   const T* __restrict__ b, T* __restrict__ y,
                   T* __restrict__ c, int n0, int r, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = k | 1;
  T* bs = reinterpret_cast<T*>(smem_raw);             // (n0, ld)
  const size_t p = blockIdx.x;
  const T* B = b + p * n0 * k;
  for (int e = threadIdx.x; e < n0 * k; e += blockDim.x)
    bs[(e / k) * ld + e % k] = B[e];
  __syncthreads();
  rows_times(adiag + p * n0 * n0, n0, n0, bs, ld, y + p * n0 * k, k, k,
             false);
  cols_times(u + p * n0 * r, n0, r, bs, ld, c + p * r * k, k, k);
}

template <typename T>
int launch(const void* adiag, const void* u, const void* b, void* y,
           void* c, int p, int n0, int r, int k, void* stream) {
  if (p == 0 || k == 0) return 0;
  const size_t smem = static_cast<size_t>(n0) * (k | 1) * sizeof(T);
  const int err = launch_with_smem(leaf_matvec_kernel<T>, smem);
  if (err) return err;
  leaf_matvec_kernel<T><<<p, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(adiag), static_cast<const T*>(u),
      static_cast<const T*>(b), static_cast<T*>(y), static_cast<T*>(c), n0,
      r, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int leaf_matvec_f32(const void* adiag, const void* u,
                               const void* b, void* y, void* c, int p, int n0,
                               int r, int k, void* stream) {
  return launch<float>(adiag, u, b, y, c, p, n0, r, k, stream);
}

extern "C" int leaf_matvec_f64(const void* adiag, const void* u,
                               const void* b, void* y, void* c, int p, int n0,
                               int r, int k, void* stream) {
  return launch<double>(adiag, u, b, y, c, p, n0, r, k, stream);
}

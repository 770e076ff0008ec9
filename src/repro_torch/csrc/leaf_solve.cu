// Fused leaf stage of the structured-inverse apply (Algorithm 2 solve,
// repro.core.hmatrix apply_inverse), per leaf p:
//
//   c_p = U_p^T b_p                                       (r, k)
//   x_p = Linv_p^T (Linv_p b_p) + U_p (Sig_p c_p)         (n0, k)
//
// with Linv_p the inverse Cholesky factor of the leaf Schur complement
// and Sig_p the corrected middle factor of the leaf's parent.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hck_leaf/hck_leaf.py::hck_leaf_solve (_solve_body).
//
// Shapes: linv (P, n0, n0), u (P, n0, r), sig (S, r, r), b (P, n0, k) ->
// x (P, n0, k), c (P, r, k); row-major and contiguous; T is float or
// double and every sum is taken in T.  S = P (one Sig per leaf) or
// S = P / 2 (one per parent: leaf p reads block p >> 1 in place, so the
// per-leaf copy the reference makes with _rep2 never reaches memory).
// Sig is not assumed symmetric.
//
// Bound on the H100: bytes.  Linv and U dominate: at the covtype shape
// (P = 4,096, n0 = r = 128, k = 7, f32) ~0.57 GB with b, x, c and the
// 2,048 parent Sig blocks, ~0.17 ms at 3.35 TB/s, against 0.12 GFLOP.
//
// Design: one block per leaf; b, t = Linv b, x, c and v = Sig c live in
// shared memory (row stride k | 1).  Every product reads its big operand
// with neighbouring threads on neighbouring addresses (leaf_products.cuh):
// t = Linv b, v = Sig c and U v one warp per row, x = Linv^T t and
// c = U^T b one thread per column.
// Linv and U are each read twice; the second read of a leaf's 128 KB
// (f32) follows the first within the block and mostly hits L2.
#include <cuda_runtime.h>

#include "kernel_epilogue.cuh"
#include "leaf_products.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
leaf_solve_kernel(const T* __restrict__ linv, const T* __restrict__ u,
                  const T* __restrict__ sig, const T* __restrict__ b,
                  T* __restrict__ x, T* __restrict__ c, int n0, int r, int k,
                  int sig_shift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = k | 1;
  T* bs = reinterpret_cast<T*>(smem_raw);             // (n0, ld)
  T* ts = bs + static_cast<size_t>(n0) * ld;          // (n0, ld)
  T* xs = ts + static_cast<size_t>(n0) * ld;          // (n0, ld)
  T* cs = xs + static_cast<size_t>(n0) * ld;          // (r, ld)
  T* vs = cs + static_cast<size_t>(r) * ld;           // (r, ld)
  const size_t p = blockIdx.x;
  const T* Li = linv + p * n0 * n0;
  const T* U = u + p * n0 * r;
  const T* S = sig + (p >> sig_shift) * r * r;
  const T* B = b + p * n0 * k;
  const int tid = threadIdx.x;

  for (int e = tid; e < n0 * k; e += blockDim.x)
    bs[(e / k) * ld + e % k] = B[e];
  __syncthreads();
  rows_times(Li, n0, n0, bs, ld, ts, ld, k, false);   // t = Linv b
  cols_times(U, n0, r, bs, ld, cs, ld, k);            // c = U^T b
  __syncthreads();
  cols_times(Li, n0, n0, ts, ld, xs, ld, k);          // x = Linv^T t
  rows_times(S, r, r, cs, ld, vs, ld, k, false);      // v = Sig c
  __syncthreads();
  rows_times(U, n0, r, vs, ld, xs, ld, k, true);      // x += U v
  __syncthreads();
  T* X = x + p * n0 * k;
  for (int e = tid; e < n0 * k; e += blockDim.x)
    X[e] = xs[(e / k) * ld + e % k];
  T* C = c + p * r * k;
  for (int e = tid; e < r * k; e += blockDim.x)
    C[e] = cs[(e / k) * ld + e % k];
}

template <typename T>
int launch(const void* linv, const void* u, const void* sig, const void* b,
           void* x, void* c, int p, int n0, int r, int k, int sig_shift,
           void* stream) {
  if (p == 0 || k == 0) return 0;
  const size_t smem =
      (3 * static_cast<size_t>(n0) + 2 * static_cast<size_t>(r)) * (k | 1)
      * sizeof(T);
  const int err = launch_with_smem(leaf_solve_kernel<T>, smem);
  if (err) return err;
  leaf_solve_kernel<T><<<p, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(linv), static_cast<const T*>(u),
      static_cast<const T*>(sig), static_cast<const T*>(b),
      static_cast<T*>(x), static_cast<T*>(c), n0, r, k, sig_shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int leaf_solve_f32(const void* linv, const void* u,
                              const void* sig, const void* b, void* x,
                              void* c, int p, int n0, int r, int k,
                              int sig_shift, void* stream) {
  return launch<float>(linv, u, sig, b, x, c, p, n0, r, k, sig_shift, stream);
}

extern "C" int leaf_solve_f64(const void* linv, const void* u,
                              const void* sig, const void* b, void* x,
                              void* c, int p, int n0, int r, int k,
                              int sig_shift, void* stream) {
  return launch<double>(linv, u, sig, b, x, c, p, n0, r, k, sig_shift,
                        stream);
}

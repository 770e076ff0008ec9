// Leaf projection c_p = U_p^T b_p for every leaf p (HCK Algorithm 3,
// phase 1: the leaf level of the common-upward pass in oos.prepare).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hck_leaf/hck_leaf.py::hck_leaf_project (_project_body).
//
// Shapes: u (P, n0, r), b (P, n0, k) -> c (P, r, k), all row-major and
// contiguous; T is float or double and the sums are taken in T.
//
// Bound on the H100: bytes.  The kernel reads every element of u and b
// once and writes c once, 2 flops per u element: at the covtype shape
// (P = 4096, n0 = r = 128, k = 7, f32) that is ~298 MB, ~89 us at
// 3.35 TB/s, against 0.06 GFLOP.
//
// Design: one block per (leaf, 128-column tile of U_p); thread `col` owns
// column col of U_p and row col of c_p.  The loop over the n0 rows reads
// one row of U_p per step with neighbouring threads on neighbouring
// addresses (coalesced), and the matching row of b_p, which every thread
// of the block reads at the same address (a broadcast).  The k outputs of
// a thread are accumulated in registers in tiles of KT columns.  Nothing
// is staged in shared memory, so no shape limit besides the grid.
#include <cuda_runtime.h>

#include "kernel_epilogue.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int KT = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
leaf_project_kernel(const T* __restrict__ u, const T* __restrict__ b,
                    T* __restrict__ c, int n0, int r, int k) {
  const int p = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= r) return;
  const T* up = u + static_cast<size_t>(p) * n0 * r + col;
  const T* bp = b + static_cast<size_t>(p) * n0 * k;
  T* cp = c + (static_cast<size_t>(p) * r + col) * k;
  for (int c0 = 0; c0 < k; c0 += KT) {
    const int kt = min(KT, k - c0);
    T acc[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) acc[j] = T(0);
#pragma unroll 4
    for (int n = 0; n < n0; ++n) {
      const T un = up[static_cast<size_t>(n) * r];
      const T* bn = bp + static_cast<size_t>(n) * k + c0;
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (j < kt) acc[j] += un * bn[j];
    }
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (j < kt) cp[c0 + j] = acc[j];
  }
}

template <typename T>
int launch(const void* u, const void* b, void* c, int p, int n0, int r,
           int k, void* stream) {
  if (p == 0 || r == 0 || k == 0) return 0;
  const dim3 grid(p, (r + kThreads - 1) / kThreads);
  leaf_project_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b), static_cast<T*>(c),
      n0, r, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hck_leaf_project_f32(const void* u, const void* b, void* c,
                                    int p, int n0, int r, int k,
                                    void* stream) {
  return launch<float>(u, b, c, p, n0, r, k, stream);
}

extern "C" int hck_leaf_project_f64(const void* u, const void* b, void* c,
                                    int p, int n0, int r, int k,
                                    void* stream) {
  return launch<double>(u, b, c, p, n0, r, k, stream);
}

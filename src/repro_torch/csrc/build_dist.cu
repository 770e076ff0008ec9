// The per-sigma stages of the hyperparameter sweep engine
// (repro.core.hck.sweep_factors): the factors at one bandwidth from
// metric distances cached once per grid (SweepPlan), one launch per tree
// level:
//
//   gram_chol_dist   D_b (m, m) -> G_b = kappa_sigma(D_b) + jitter*m I and
//                    its lower Cholesky factor L_b (Sigma per level);
//   gram_dist        the same Gram without a factor (the leaf Adiag blocks);
//   cross_solve_dist D_b (m, r), Linv_b (r, r) ->
//                    U_b = kappa_sigma(D_b) Linv_b^T Linv_b (U and W).
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/build_stage/build_stage.py::gram_chol_dist_kernel
//   (_gram_chol_dist_body; gram_chol_dist and gram_dist are its want_chol
//   and Gram-only forms) and ::cross_solve_dist_kernel
//   (_cross_solve_dist_body).
//
// All arrays row-major and contiguous; T is float or double and every sum
// is taken in T (no TF32).  The epilogue is kernel_epilogue.cuh's, as in
// the fused gram_chol / cross_solve kernels (build_stage.cu).
//
// Bounds on the H100 at the covtype shapes (f32, n0 = r = 128, L = 12):
//   gram_dist (4,096 Adiag blocks) is bound by bytes: 268 MB read and
//   268 MB written, ~0.16 ms.  gram_chol_dist over the 12 Sigma levels
//   (4,095 blocks in all) is bound by bytes too (~0.24 ms together), but
//   its top levels have 1, 2, 4 ... blocks and wait on the latency of one
//   block's m-step Cholesky.  cross_solve_dist for U (2,048 parents x 256
//   rows) is bound by operations: two products with the lower triangular
//   Linv, r(r + 1)/2 multiply-adds each per row, ~17 GFLOP, ~0.26 ms at
//   67 TFLOP/s; no distance work is left.
//
// Design.  gram_chol_dist: one block per node.  The (m, m) distance tile
// is read with coalesced loads, turned into kernel values in a shared
// tile of row stride m + 1 (jitter*m on its diagonal) and written as the
// Gram; the tile is then factored in place by chol_smem.cuh, the routine
// of gram_chol and leaf_factor, with no pivot clamp (a block that is not
// positive definite gives NaN, build_stage.py:85-86), and written again.
// m(m + 1) values must fit the 227 KB a block can have: m <= 240 in f32,
// m <= 169 in f64 (the wrapper raises beyond).  gram_dist is a pure
// elementwise pass: a grid-stride loop with one warp per row of the
// stacked blocks, no shared memory.  cross_solve_dist: grid (node, tile of
// bm = 16, 32, 64 or 128 rows); the node's Linv and the tile's kernel
// values (epilogue applied as the distances are loaded) are staged in
// shared memory and cross_products.cuh runs the two register-tiled
// products of cross_solve.  r <= 128; (r + bm)(r + 1) values must fit:
// bm = 128 in f32, 64 in f64 at r = 128 (the wrapper picks and raises).
#include <cuda_runtime.h>

#include "chol_smem.cuh"
#include "cross_products.cuh"
#include "kernel_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowWarps = kThreads / 32;      // gram_dist: rows per step
using cross_tile::NR;
using cross_tile::TX;
using cross_tile::TY;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_chol_dist_kernel(const T* __restrict__ dist, T* __restrict__ gram,
                      T* __restrict__ chol, int m, int kind, T sigma,
                      T diag_add) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = m + 1;
  T* a = reinterpret_cast<T*>(smem_raw);              // (m, lda)
  const size_t base = static_cast<size_t>(blockIdx.x) * m * m;
  const T* D = dist + base;
  T* G = gram + base;
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
    const int i = e / m;
    const int c = e - i * m;
    T v = kernel_epilogue<T>(kind, D[e], sigma);
    if (i == c) v += diag_add;
    a[i * lda + c] = v;
    G[e] = v;
  }
  chol_smem(a, m, lda);                  // synchronises before reading a
  T* L = chol + base;
  for (int e = threadIdx.x; e < m * m; e += blockDim.x)
    L[e] = a[(e / m) * lda + e % m];
}

// rows = B * m rows of m values; row i of a block gets diag_add at column
// i % m.  One warp per row, lanes over columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_dist_kernel(const T* __restrict__ dist, T* __restrict__ gram,
                 long long rows, int m, int kind, T sigma, T diag_add) {
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kRowWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kRowWarps
                       + (threadIdx.x >> 5);
       row < rows; row += step) {
    const int diag = static_cast<int>(row % m);
    const T* d = dist + row * m;
    T* g = gram + row * m;
#pragma unroll 4
    for (int c = lane; c < m; c += 32) {
      T v = kernel_epilogue<T>(kind, d[c], sigma);
      if (c == diag) v += diag_add;
      g[c] = v;
    }
  }
}

template <typename T, int MR>
__global__ void __launch_bounds__(cross_tile::kThreads)
cross_solve_dist_kernel(const T* __restrict__ dist,
                        const T* __restrict__ linv, T* __restrict__ out,
                        int m, int r, int kind, T sigma) {
  constexpr int BM = TY * MR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldr = r + 1;
  T* li = reinterpret_cast<T*>(smem_raw);             // (r, ldr): Linv
  T* ka = li + static_cast<size_t>(r) * ldr;          // (BM, ldr): K, then Y
  const size_t node = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, m - row0);
  const T* D = dist + (node * m + row0) * r;
  int col[NR];
  cross_tile::columns(col, r);

  cross_tile::stage_linv(li, linv + node * r * r, r);
  // kernel values of the tile; rows past its end are zero
  for (int e = threadIdx.x; e < BM * r; e += blockDim.x) {
    const int i = e / r;
    const int c = e - i * r;
    ka[i * ldr + c] = i < rows ? kernel_epilogue<T>(kind, D[e], sigma) : T(0);
  }
  T acc[MR][NR];
  cross_tile::products<T, MR>(ka, li, r, col, acc);
  cross_tile::store<T, MR>(out + (node * m + row0) * r, rows, r, acc);
}

template <typename T>
int launch_gram_chol(const void* dist, void* gram, void* chol, int b, int m,
                     int kind, double sigma, double diag_add, void* stream) {
  if (b == 0 || m == 0) return 0;
  const size_t smem = static_cast<size_t>(m) * (m + 1) * sizeof(T);
  const int err = launch_with_smem(gram_chol_dist_kernel<T>, smem);
  if (err) return err;
  gram_chol_dist_kernel<T><<<b, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dist), static_cast<T*>(gram),
      static_cast<T*>(chol), m, kind, static_cast<T>(sigma),
      static_cast<T>(diag_add));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gram(const void* dist, void* gram, int b, int m, int kind,
                double sigma, double diag_add, void* stream) {
  if (b == 0 || m == 0) return 0;
  const long long rows = static_cast<long long>(b) * m;
  // enough blocks to fill every SM (8 blocks of 256 threads each) twice
  const long long want = (rows + kRowWarps - 1) / kRowWarps;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  gram_dist_kernel<T><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dist), static_cast<T*>(gram), rows, m, kind,
      static_cast<T>(sigma), static_cast<T>(diag_add));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MR>
int launch_cross_tile(const T* dist, const T* linv, T* out, int b, int m,
                      int r, int kind, T sigma, cudaStream_t stream) {
  constexpr int BM = TY * MR;
  const size_t smem = static_cast<size_t>(r + BM) * (r + 1) * sizeof(T);
  const int err = launch_with_smem(cross_solve_dist_kernel<T, MR>, smem);
  if (err) return err;
  const dim3 grid(b, (m + BM - 1) / BM);
  cross_solve_dist_kernel<T, MR><<<grid, cross_tile::kThreads, smem,
                                   stream>>>(dist, linv, out, m, r, kind,
                                             sigma);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cross(const void* dist, const void* linv, void* out, int b, int m,
                 int r, int bm, int kind, double sigma, void* stream) {
  if (b == 0 || m == 0 || r == 0) return 0;
  if (r > TX * NR) return static_cast<int>(cudaErrorInvalidValue);
  const T* d = static_cast<const T*>(dist);
  const T* li = static_cast<const T*>(linv);
  T* o = static_cast<T*>(out);
  const T s = static_cast<T>(sigma);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case TY * 8:
      return launch_cross_tile<T, 8>(d, li, o, b, m, r, kind, s, st);
    case TY * 4:
      return launch_cross_tile<T, 4>(d, li, o, b, m, r, kind, s, st);
    case TY * 2:
      return launch_cross_tile<T, 2>(d, li, o, b, m, r, kind, s, st);
    case TY:
      return launch_cross_tile<T, 1>(d, li, o, b, m, r, kind, s, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int gram_chol_dist_f32(const void* dist, void* gram, void* chol,
                                  int b, int m, int kind, double sigma,
                                  double diag_add, void* stream) {
  return launch_gram_chol<float>(dist, gram, chol, b, m, kind, sigma,
                                 diag_add, stream);
}

extern "C" int gram_chol_dist_f64(const void* dist, void* gram, void* chol,
                                  int b, int m, int kind, double sigma,
                                  double diag_add, void* stream) {
  return launch_gram_chol<double>(dist, gram, chol, b, m, kind, sigma,
                                  diag_add, stream);
}

extern "C" int gram_dist_f32(const void* dist, void* gram, int b, int m,
                             int kind, double sigma, double diag_add,
                             void* stream) {
  return launch_gram<float>(dist, gram, b, m, kind, sigma, diag_add, stream);
}

extern "C" int gram_dist_f64(const void* dist, void* gram, int b, int m,
                             int kind, double sigma, double diag_add,
                             void* stream) {
  return launch_gram<double>(dist, gram, b, m, kind, sigma, diag_add, stream);
}

extern "C" int cross_solve_dist_f32(const void* dist, const void* linv,
                                    void* out, int b, int m, int r, int bm,
                                    int kind, double sigma, void* stream) {
  return launch_cross<float>(dist, linv, out, b, m, r, bm, kind, sigma,
                             stream);
}

extern "C" int cross_solve_dist_f64(const void* dist, const void* linv,
                                    void* out, int b, int m, int r, int bm,
                                    int kind, double sigma, void* stream) {
  return launch_cross<double>(dist, linv, out, b, m, r, bm, kind, sigma,
                              stream);
}

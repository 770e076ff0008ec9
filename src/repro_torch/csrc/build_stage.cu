// The two factor-instantiation stages of the batched HCK build engine
// (Algorithm 2, repro.core.hck.build_hck), one launch per tree level:
//
//   gram_chol    P_b (m, d) -> G_b = K(P_b, P_b) + jitter*m I (m, m) and,
//                with want_chol, its lower Cholesky factor L_b;
//   cross_solve  P_b (m, d), Z_b (r, d), Linv_b (r, r) ->
//                U_b = K(P_b, Z_b) Linv_b^T Linv_b (m, r).
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/build_stage/build_stage.py::gram_chol_kernel
//   (_gram_chol_body, _cholesky_in_vmem) and ::cross_solve_kernel
//   (_cross_solve_body).
//
// All arrays row-major and contiguous; T is float or double and every sum
// is taken in T (float32 in full float32, no TF32).  Distances are summed
// directly as (p - z)^2 or |p - z| over the features, not through the
// ||p||^2 + ||z||^2 - 2 p.z identity of the plain version, which cancels
// for points far from the origin.  Summing (p_i - p_c)^2 in one order for
// both (i, c) and (c, i) keeps the Gram exactly symmetric.
//
// Bounds on the H100 at the covtype shapes (f32, n0 = r = 128, d = 54):
//   gram_chol for the 4,096 leaf Adiag blocks is bound by bytes (382 MB
//   written, ~0.11 ms); the 12 Sigma launches have 1 .. 2,048 blocks and
//   the top levels are bound by the latency of one block's m-step
//   Cholesky.  cross_solve for U (2,048 parents x 256 rows) is bound by
//   operations: ~45 GFLOP, two full r x r products per row plus the
//   distances, ~0.67 ms at 67 TFLOP/s.
//
// Design.  gram_chol: one block per node.  The (m, m) distance tile lives
// in shared memory (row stride m + 1) and is accumulated over feature
// chunks of DC columns of the node's points, staged with coalesced copies
// into rows of odd stride DC + 1; the epilogue turns it into kernel
// values, adds jitter*m on the diagonal and writes the Gram; with
// want_chol the tile is factored in place (chol_smem.cuh) and written
// again.  m(m + 1) + m(DC + 1) values must fit the 227 KB a block can
// have: m <= 224 in f32, m <= 154 in f64 (the wrapper raises beyond).
// cross_solve: grid (node, tile of bm = 16, 32, 64 or 128 rows).  The
// node's whole Linv (r x r) is staged in shared memory once per block.
// Each thread owns an MR x NR register tile of the (bm, r) output, rows and
// columns interleaved at strides 16, and walks three products with it:
// the distances over staged feature chunks of points and landmarks, then
// Y = K Linv^T and U = Y Linv through one shared (bm, r + 1) tile (Y is
// written over K), the two products of cross_products.cuh, which
// cross_solve_dist (build_dist.cu) shares.  r <= 128; (r + bm)(r + 1)
// + (bm + r)(DC + 1) values must fit: bm = 128 in f32, 32 in f64 at
// r = 128 (the wrapper picks and raises).
#include <cuda_runtime.h>

#include "chol_smem.cuh"
#include "cross_products.cuh"
#include "kernel_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int DC = 32;       // feature columns staged per chunk
using cross_tile::NR;
using cross_tile::TX;
using cross_tile::TY;

// acc[i][c] += dist(x_i, y_c) over one feature chunk, for i < rows, c < cols
template <typename T>
__device__ void accumulate_dist(T* acc, int lda, const T* xs, const T* ys,
                                int rows, int cols, int dc, bool l1) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int i = e / cols;
    const int c = e - i * cols;
    const T* xi = xs + i * (DC + 1);
    const T* yc = ys + c * (DC + 1);
    T s = acc[i * lda + c];
    for (int t = 0; t < dc; ++t) {
      const T diff = xi[t] - yc[t];
      s += l1 ? (diff < T(0) ? -diff : diff) : diff * diff;
    }
    acc[i * lda + c] = s;
  }
}

// stage rows x dc values of a row-major (., d) block, columns t0.., into
// rows of stride DC + 1
template <typename T>
__device__ void stage_chunk(T* dst, const T* src, int rows, int d, int t0,
                            int dc) {
  for (int e = threadIdx.x; e < rows * dc; e += blockDim.x) {
    const int row = e / dc;
    const int t = e - row * dc;
    dst[row * (DC + 1) + t] = src[static_cast<size_t>(row) * d + t0 + t];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_chol_kernel(const T* __restrict__ points, T* __restrict__ gram,
                 T* __restrict__ chol, int m, int d, int kind, T sigma,
                 T diag_add) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = m + 1;
  T* a = reinterpret_cast<T*>(smem_raw);              // (m, lda)
  T* ps = a + static_cast<size_t>(m) * lda;           // (m, DC + 1)
  const size_t node = blockIdx.x;
  const T* P = points + node * m * d;
  const bool l1 = kind_is_l1(kind);

  for (int e = threadIdx.x; e < m * m; e += blockDim.x)
    a[(e / m) * lda + e % m] = T(0);
  for (int t0 = 0; t0 < d; t0 += DC) {
    const int dc = min(DC, d - t0);
    __syncthreads();                     // previous chunk consumed
    stage_chunk(ps, P, m, d, t0, dc);
    __syncthreads();
    accumulate_dist(a, lda, ps, ps, m, m, dc, l1);
  }
  __syncthreads();
  T* G = gram + node * m * m;
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
    const int i = e / m;
    const int c = e - i * m;
    T v = kernel_epilogue<T>(kind, a[i * lda + c], sigma);
    if (i == c) v += diag_add;
    a[i * lda + c] = v;
    G[e] = v;
  }
  if (chol == nullptr) return;           // uniform across the block
  chol_smem(a, m, lda);
  T* L = chol + node * m * m;
  for (int e = threadIdx.x; e < m * m; e += blockDim.x)
    L[e] = a[(e / m) * lda + e % m];
}

template <typename T, int MR>
__global__ void __launch_bounds__(cross_tile::kThreads)
cross_solve_kernel(const T* __restrict__ points,
                   const T* __restrict__ landmarks,
                   const T* __restrict__ linv, T* __restrict__ out, int m,
                   int r, int d, int kind, T sigma) {
  constexpr int BM = TY * MR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldr = r + 1;
  T* li = reinterpret_cast<T*>(smem_raw);             // (r, ldr): Linv
  T* ka = li + static_cast<size_t>(r) * ldr;          // (BM, ldr): K, then Y
  T* xs = ka + BM * ldr;                              // (BM, DC + 1)
  T* zs = xs + BM * (DC + 1);                         // (r, DC + 1)
  const size_t node = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, m - row0);
  const T* P = points + (node * m + row0) * d;
  const T* Z = landmarks + node * r * d;
  const bool l1 = kind_is_l1(kind);
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  int col[NR];
  cross_tile::columns(col, r);

  cross_tile::stage_linv(li, linv + node * r * r, r);
  T acc[MR][NR];
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < NR; ++b) acc[a][b] = T(0);

  // distances of the row tile to the r landmarks, over feature chunks
  for (int t0 = 0; t0 < d; t0 += DC) {
    const int dc = min(DC, d - t0);
    __syncthreads();
    stage_chunk(xs, P, rows, d, t0, dc);
    stage_chunk(zs, Z, r, d, t0, dc);
    __syncthreads();
    for (int t = 0; t < dc; ++t) {
      T xv[MR], zv[NR];
#pragma unroll
      for (int a = 0; a < MR; ++a) xv[a] = xs[(ty + TY * a) * (DC + 1) + t];
#pragma unroll
      for (int b = 0; b < NR; ++b) zv[b] = zs[col[b] * (DC + 1) + t];
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int b = 0; b < NR; ++b) {
          const T diff = xv[a] - zv[b];
          acc[a][b] += l1 ? (diff < T(0) ? -diff : diff) : diff * diff;
        }
    }
  }
  // kernel values; rows past the tile's end are zero
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < NR; ++b) {
      const int i = ty + TY * a;
      if (tx + TX * b < r)
        ka[i * ldr + tx + TX * b] =
            i < rows ? kernel_epilogue<T>(kind, acc[a][b], sigma) : T(0);
    }
  cross_tile::products<T, MR>(ka, li, r, col, acc);
  cross_tile::store<T, MR>(out + (node * m + row0) * r, rows, r, acc);
}

template <typename T>
int launch_gram(const void* points, void* gram, void* chol, int b, int m,
                int d, int kind, double sigma, double diag_add,
                void* stream) {
  if (b == 0 || m == 0) return 0;
  const size_t smem = (static_cast<size_t>(m) * (m + 1)
                       + static_cast<size_t>(m) * (DC + 1)) * sizeof(T);
  const int err = launch_with_smem(gram_chol_kernel<T>, smem);
  if (err) return err;
  gram_chol_kernel<T><<<b, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(points), static_cast<T*>(gram),
      static_cast<T*>(chol), m, d, kind, static_cast<T>(sigma),
      static_cast<T>(diag_add));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MR>
int launch_cross_tile(const T* points, const T* landmarks, const T* linv,
                      T* out, int b, int m, int r, int d, int kind, T sigma,
                      cudaStream_t stream) {
  constexpr int BM = TY * MR;
  const size_t smem = (static_cast<size_t>(r + BM) * (r + 1)
                       + static_cast<size_t>(BM + r) * (DC + 1)) * sizeof(T);
  const int err = launch_with_smem(cross_solve_kernel<T, MR>, smem);
  if (err) return err;
  const dim3 grid(b, (m + BM - 1) / BM);
  cross_solve_kernel<T, MR><<<grid, cross_tile::kThreads, smem, stream>>>(
      points, landmarks, linv, out, m, r, d, kind, sigma);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cross(const void* points, const void* landmarks, const void* linv,
                 void* out, int b, int m, int r, int d, int bm, int kind,
                 double sigma, void* stream) {
  if (b == 0 || m == 0 || r == 0) return 0;
  if (r > TX * NR) return static_cast<int>(cudaErrorInvalidValue);
  const T* p = static_cast<const T*>(points);
  const T* z = static_cast<const T*>(landmarks);
  const T* li = static_cast<const T*>(linv);
  T* o = static_cast<T*>(out);
  const T s = static_cast<T>(sigma);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case TY * 8:
      return launch_cross_tile<T, 8>(p, z, li, o, b, m, r, d, kind, s, st);
    case TY * 4:
      return launch_cross_tile<T, 4>(p, z, li, o, b, m, r, d, kind, s, st);
    case TY * 2:
      return launch_cross_tile<T, 2>(p, z, li, o, b, m, r, d, kind, s, st);
    case TY:
      return launch_cross_tile<T, 1>(p, z, li, o, b, m, r, d, kind, s, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int gram_chol_f32(const void* points, void* gram, void* chol,
                             int b, int m, int d, int kind, double sigma,
                             double diag_add, void* stream) {
  return launch_gram<float>(points, gram, chol, b, m, d, kind, sigma,
                            diag_add, stream);
}

extern "C" int gram_chol_f64(const void* points, void* gram, void* chol,
                             int b, int m, int d, int kind, double sigma,
                             double diag_add, void* stream) {
  return launch_gram<double>(points, gram, chol, b, m, d, kind, sigma,
                             diag_add, stream);
}

extern "C" int cross_solve_f32(const void* points, const void* landmarks,
                               const void* linv, void* out, int b, int m,
                               int r, int d, int bm, int kind, double sigma,
                               void* stream) {
  return launch_cross<float>(points, landmarks, linv, out, b, m, r, d, bm,
                             kind, sigma, stream);
}

extern "C" int cross_solve_f64(const void* points, const void* landmarks,
                               const void* linv, void* out, int b, int m,
                               int r, int d, int bm, int kind, double sigma,
                               void* stream) {
  return launch_cross<double>(points, landmarks, linv, out, b, m, r, d, bm,
                              kind, sigma, stream);
}

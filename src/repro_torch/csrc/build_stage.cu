// The two factor-instantiation stages of the batched HCK build engine
// (Algorithm 2, repro.core.hck.build_hck), each one grouped launch over
// every tree level (level_groups.cuh's table, one group a level):
//
//   gram_chol_levels    per group P_b (m, d) -> G_b = K(P_b, P_b) +
//                       jitter*m I (m, m) and, in a launch that wants
//                       factors, its lower Cholesky factor L_b (every
//                       level's Sigma; the leaf Adiag in a launch
//                       without);
//   cross_solve_levels  per group P_b (m, d), Z_b (r, d), Linv_b (r, r) ->
//                       U_b = K(P_b, Z_b) Linv_b^T Linv_b (m, r) (U and
//                       every level's W), one r and one d for all groups.
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/build_stage/build_stage.py::gram_chol_kernel
//   (_gram_chol_body, _cholesky_in_vmem) and ::cross_solve_kernel
//   (_cross_solve_body).
//
// All arrays row-major and contiguous; T is float or double and every sum
// is taken in T (float32 in full float32 or in split TF32, never plain
// TF32).  Distances are summed directly as (p - z)^2 (one subtraction and
// one fused multiply-add a feature, in feature order) or |p - z|, not
// through the ||p||^2 + ||z||^2 - 2 p.z identity of the plain version,
// which cancels for points far from the origin.  That is the chain of
// policy_dist and of the sweep's cached tiles; (p_i - p_c)^2 and (p_c -
// p_i)^2 are the same number, so the Gram is exactly symmetric.
//
// Bounds on the H100 at the covtype shapes (f32, n0 = r = 128, d = 54,
// 12 levels), chip_smoke.py's gram_cost and cross_cost:
//   gram_chol_levels: the 4,095 Sigma tiles read 113 MB of landmarks and
//   write the Gram and the factor (537 MB): ~0.19 ms of bytes; the 4,096
//   Adiag tiles read 113 MB and write 268 MB, ~0.11 ms.  The direct sum
//   issues two instructions a feature and distinct pair (FSUB, FFMA):
//   ~0.11 ms each at 132 SMs x 128 lanes x 1.98 GHz.  Each Sigma tile's
//   factor is a chain of dependent panel steps, so the launch is bound by
//   that chain's latency unless many tiles run side by side.
//   cross_solve_levels (U and 11 W levels, 4,095 nodes x 256 rows): bytes
//   (points, landmarks and Linv read, U written: ~0.50 GB, 0.15 ms); three
//   TF32 passes over the two triangular products, ~0.21 ms at 495
//   TFLOP/s; the direct sum 14.5 G issue slots, ~0.43 ms: the distances
//   bound it.
//
// Design.
// gram_chol_levels: one block of 128 threads per node of every group (a
// node's tile depends only on its points, so the top levels' few blocks
// run inside the largest level's waves).  The m x m tile is computed in
// super tiles of 64 x 64, the lower triangle only (a tile above the
// diagonal is the transpose of one below): each thread holds a 4 x 8
// register tile (rows 4 ty + i, columns 4 tx + j + 32 g) and reads its
// points with 16-byte shared loads from feature-major chunks of 8
// features (the super tile's 64 row points and 64 column points, 132
// values a feature), staged with cp.async into two buffers, the next
// chunk in flight while this one is summed.  The epilogue and jitter*m on
// the diagonal are applied in registers and the Gram is written straight
// to device memory, 16 bytes a store where m % 4 == 0, both a tile and
// its transpose.  A launch with factors also puts the lower triangle in a
// shared tile of row stride m | 1 and factors it there with B3's blocked
// routine (chol_blocked.cuh: panels of 32, a warp-level diagonal factor,
// forward substitution, register-tiled trailing updates), as B8's grouped
// kernel does; no pivot clamp (a tile that is not positive definite
// gives NaN, build_stage.py:85-86).  A launch without factors runs the
// same kernel without the shared tile (the leaf Adiag:
// 8.4 KB of staging a block).  The tile, the pivots and the staging must
// fit the 227 KB a block can have: m <= 235 in f32, m <= 163 in f64 (larger
// tiles, up to 512, take the panel form: build_stage_panel.cu).
// cross_solve_levels, float32: one block of 128 threads per node of every
// group; the node's Linv is staged once (cross_tc.cuh), then the node's
// rows are walked in tiles of 64.  Per tile, the distances to the r
// landmarks are summed on the CUDA cores in 8 x 8 register tiles (rows 4
// ty + i + 32 h, columns 4 tx + j + 64 g) from feature-major chunks of 8
// features of the 64 points and 128 landmarks, double-buffered with
// cp.async across tiles too; the epilogue turns them into K in a shared
// tile (row stride 4 mod 32); then each warp runs cross_tc.cuh's split-
// TF32 mma.sync products on its 16-row strip, Y = K Linv^T and U = Y Linv
// with Linv's zero triangle skipped by 8-column k-step, and stores U.
// r <= 128 (ranks up to 256 take the panel form, build_stage_panel.cu);
// 114 KB of shared memory, two blocks an SM.
// bfloat16-data entries (gram_chol_levels_bf16, cross_solve_levels_bf16;
// a mixed-precision policy's build): the points and landmarks are
// bfloat16, Linv and every output float32.  They are the float32 kernels
// with another load type for the data (data_load.cuh): a staging thread
// loads each bfloat16 datum, converts it to float32 and stores it into the
// same float32 staging buffer (2-byte data are below cp.async's 4-byte
// copy), so from there they compute exactly what the float32 entries
// compute.  Shared memory and the limits on m and r are those of float32.
// cross_solve_levels, float64: grid (group, node, tile of bm = 16, 32, 64
// or 128 rows); the node's Linv is staged in shared memory; each thread
// owns an MR x NR register tile of the (bm, r) output and walks three
// products with it: the distances over staged feature chunks of points
// and landmarks, then Y = K Linv^T and U = Y Linv (cross_products.cuh).
// (r + bm)(r + 1) + (bm + r)(DC + 1) values must fit: bm = 32 at r = 128
// (the wrapper picks and raises).
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "chol_blocked.cuh"
#include "cross_products.cuh"
#include "cross_tc.cuh"
#include "data_load.cuh"
#include "kernel_epilogue.cuh"
#include "level_groups.cuh"

namespace {

using levels::find_group;
using levels::Table;

__device__ __forceinline__ void load4(float (&v)[8], int at, const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[at] = q.x;
  v[at + 1] = q.y;
  v[at + 2] = q.z;
  v[at + 3] = q.w;
}

__device__ __forceinline__ void load4(double (&v)[8], int at,
                                      const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[at] = a.x;
  v[at + 1] = a.y;
  v[at + 2] = b.x;
  v[at + 3] = b.y;
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// acc += (x - y)^2 (one fused multiply-add) or |x - y|
template <bool L1, typename T>
__device__ __forceinline__ T dist_step(T acc, T x, T y) {
  const T diff = x - y;
  return L1 ? acc + (diff < T(0) ? -diff : diff) : fmadd(diff, diff, acc);
}

// ---------------------------------------------------------------------------
// B1: gram_chol_levels
// ---------------------------------------------------------------------------

namespace gram {

constexpr int kThreads = chol_blocked::kThreads;   // 128
constexpr int ST = 64;            // super tile: rows and columns
constexpr int DC = 8;             // features of a staged chunk
constexpr int LDP = 2 * ST + 4;   // a staged feature: 64 row, 64 column points
constexpr int TM = 4;             // a thread's rows of a super tile
constexpr int TN = 8;             // and columns

template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
  return sizeof(T) * 2 * DC * LDP;
}

// The factor's part of a block's shared memory: the (m, m | 1) tile, the m
// reciprocal pivots and the column buffer; the staging follows it.
template <typename T>
__host__ __device__ constexpr size_t factor_bytes(int m) {
  return chol_blocked::col_offset(m, m | 1, sizeof(T)) +
         chol_blocked::NB * sizeof(T);
}

// Super tile q of the lower triangle (row-major over it: q = I (I + 1) / 2
// + J, J <= I).
__device__ __forceinline__ void super_tile(int q, int& I, int& J) {
  I = 0;
  while (q > I) {
    q -= I + 1;
    ++I;
  }
  J = q;
}

// Stage features f0 .. f0 + dc of the super tile's row points (64 from
// I ST) and, off the diagonal, its column points (from J ST) feature-major
// into buf (in T; S is the points' type); points past m are zero.
template <typename T, typename S>
__device__ __forceinline__ void stage(T* buf, const S* __restrict__ P, int m,
                                      int d, int I, int J, int f0, int dc) {
  const int k = threadIdx.x;                  // one point a thread
  if (k >= ST && I == J) return;
  const int p = k < ST ? I * ST + k : J * ST + (k - ST);
  const bool valid = p < m;
  const S* src = valid ? P + static_cast<size_t>(p) * d + f0 : P;
  for (int f = 0; f < dc; ++f)
    dload::stage(buf + f * LDP + k, valid ? src + f : P, valid);
}

template <bool L1, typename T>
__device__ __forceinline__ void accumulate(T (&acc)[TM][TN], const T* buf,
                                           int yoff, int dc) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const T* xs = buf + TM * ty;
  const T* ys = buf + yoff + 4 * tx;
#pragma unroll 2
  for (int f = 0; f < dc; ++f) {
    T xv[8], yv[8];
    load4(xv, 0, xs + f * LDP);
    load4(yv, 0, ys + f * LDP);
    load4(yv, 4, ys + f * LDP + 32);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = dist_step<L1>(acc[i][j], xv[i], yv[j]);
  }
}

// Four consecutive values at p (n of them in range), 16 bytes at a time
// where ``vec``.
__device__ __forceinline__ void put4(float* p, const float* v, int n,
                                     bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < n; ++e) p[e] = v[e];
  }
}

__device__ __forceinline__ void put4(double* p, const double* v, int n,
                                     bool vec) {
  if (vec && n == 4) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  } else {
    for (int e = 0; e < n; ++e) p[e] = v[e];
  }
}

// The finished super tile (I, J): kernel values (+ diag_add on the
// diagonal) into acc, the Gram's entries (and, off the diagonal, their
// transposes) to G, and with ``a`` the lower triangle into the shared
// tile of row stride lda.
template <typename T>
__device__ __forceinline__ void finish(T (&acc)[TM][TN], int I, int J, int m,
                                       int kind, T sigma, T diag_add, T* G,
                                       T* a, int lda) {
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int r0 = I * ST + TM * ty;
  const bool vec = m % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = J * ST + 4 * tx + (j & 3) + 32 * (j >> 2);
      T v = kernel_epilogue<T>(kind, acc[i][j], sigma);
      if (r0 + i == c) v += diag_add;
      acc[i][j] = v;
      if (a != nullptr && r0 + i < m && c <= r0 + i) a[(r0 + i) * lda + c] = v;
    }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (r0 + i >= m) break;
    T* row = G + static_cast<size_t>(r0 + i) * m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = J * ST + 4 * tx + 32 * h;
      if (c0 < m) put4(row + c0, &acc[i][4 * h], min(4, m - c0), vec);
    }
  }
  if (I == J || r0 >= m) return;
  const int nr = min(TM, m - r0);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = J * ST + 4 * tx + (j & 3) + 32 * (j >> 2);
    const T col[TM] = {acc[0][j], acc[1][j], acc[2][j], acc[3][j]};
    if (c < m) put4(G + static_cast<size_t>(c) * m + r0, col, nr, vec);
  }
}

// One block per node of every group: the Gram of its points (ptr[0], of
// type S) into ptr[1] and, with kFactor, the lower Cholesky factor into
// ptr[2].  Every step of the loop stages the next chunk (of this super
// tile or of the next), sums the current one, and after a super tile's
// last chunk writes it out.
template <typename T, typename S, bool kFactor>
__global__ void __launch_bounds__(kThreads, kFactor ? (sizeof(T) == 4 ? 3 : 1)
                                                    : (sizeof(T) == 4 ? 4 : 2))
gram_points_kernel(const __grid_constant__ Table<T> tab, int d,
                        int kind, T sigma, double jitter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m, lda = m | 1;
  const size_t off = static_cast<size_t>(node) * m * m;
  const S* P = reinterpret_cast<const S*>(tab.g[gi].ptr[0]) +
               static_cast<size_t>(node) * m * d;
  T* G = tab.g[gi].ptr[1] + off;
  // The launch passes every group's factor with kFactor.  The tests below
  // read L, not kFactor: written with kFactor, nvcc 12.8 compiles this
  // file's other kernels differently and B2's NT 16 entry spills.
  T* L = kFactor ? tab.g[gi].ptr[2] + off : nullptr;
  T* a = reinterpret_cast<T*>(smem_raw);              // (m, lda) with L
  T* buf = reinterpret_cast<T*>(
      smem_raw + (L != nullptr ? factor_bytes<T>(m) : 0));  // 2 x (DC, LDP)
  const T diag_add = static_cast<T>(jitter * m);
  const bool l1 = kind_is_l1(kind);
  const int sides = (m + ST - 1) / ST;
  const int nch = (d + DC - 1) / DC;
  const int steps = sides * (sides + 1) / 2 * nch;

  T acc[TM][TN];
  int I, J;
  super_tile(0, I, J);
  stage(buf, P, m, d, I, J, 0, min(DC, d));
  acopy::commit();
  for (int s = 0, c = 0; s < steps; ++s) {
    const int q = s / nch;
    c = s - q * nch;
    super_tile(q, I, J);
    if (s + 1 < steps) {                         // the next chunk in flight
      const int qn = (s + 1) / nch, cn = s + 1 - qn * nch;
      int In, Jn;
      super_tile(qn, In, Jn);
      stage(buf + ((s + 1) & 1) * DC * LDP, P, m, d, In, Jn, cn * DC,
            min(DC, d - cn * DC));
      acopy::commit();
      acopy::wait<1>();
    } else {
      acopy::wait<0>();
    }
    __syncthreads();                             // chunk s is staged
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
    }
    const T* cur = buf + (s & 1) * DC * LDP;
    const int yoff = I == J ? 0 : ST, dc = min(DC, d - c * DC);
    if (l1)
      accumulate<true>(acc, cur, yoff, dc);
    else
      accumulate<false>(acc, cur, yoff, dc);
    if (c == nch - 1)
      finish(acc, I, J, m, kind, sigma, diag_add, G, L ? a : nullptr, lda);
    __syncthreads();                             // chunk s is consumed
  }
  if (!kFactor) return;
  T* rdiag = a + m * lda;
  T* col = reinterpret_cast<T*>(
      smem_raw + chol_blocked::col_offset(m, lda, sizeof(T)));
  chol_blocked::factor_panels(a, lda, rdiag, col, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < m; r += chol_blocked::kWarps)
    for (int cc = lane; cc < m; cc += 32)
      L[static_cast<size_t>(r) * m + cc] = cc <= r ? a[r * lda + cc] : T(0);
}

template <typename T, typename S>
int launch(const void* table, int groups, int d, int kind, double sigma,
           double jitter, int want_chol, void* stream) {
  Table<T> tab;
  long long nodes;
  int mmax;
  int err = levels::read_table(table, groups, 3, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  if (want_chol)                                 // every group's factor
    for (int i = 0; i < groups; ++i)
      if (tab.g[i].ptr[2] == nullptr) return cudaErrorInvalidValue;
  const auto kernel = want_chol ? gram_points_kernel<T, S, true>
                                : gram_points_kernel<T, S, false>;
  const size_t smem =
      (want_chol ? factor_bytes<T>(mmax) : 0) + stage_bytes<T>();
  err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<static_cast<unsigned>(nodes), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(tab, d, kind,
                                                static_cast<T>(sigma), jitter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gram

// ---------------------------------------------------------------------------
// B2: cross_solve_levels in float32 (split TF32 on the tensor cores)
// ---------------------------------------------------------------------------

namespace cross {

constexpr int BM = 16 * tc::kWarps;   // rows of a tile: the warps' strips
constexpr int BN = 8 * tc::kMaxTiles; // landmarks a tile holds (r <= 128)
constexpr int DC = 8;                 // features of a staged chunk
constexpr int LDS = BM + BN + 4;      // a staged feature: points, landmarks

__host__ __device__ constexpr size_t smem_bytes(int r) {
  return tc::linv_bytes(r) +
         sizeof(float) * (BM * tc::linv_stride(tc::tiles(r)) + 2 * DC * LDS);
}

// Stage features f0 .. f0 + dc of the tile's points (rows row0.. of P,
// zero past m) and of the r landmarks (zero past r) feature-major, in
// float32 (S is the data's type).
template <typename S>
__device__ __forceinline__ void stage(float* buf, const S* __restrict__ P,
                                      const S* __restrict__ Z, int m,
                                      int r, int d, int row0, int f0,
                                      int dc) {
  for (int k = threadIdx.x; k < BM + BN; k += tc::kThreads) {
    const bool point = k < BM;
    const int p = point ? row0 + k : k - BM;
    const bool valid = p < (point ? m : r);
    const S* src =
        valid ? (point ? P : Z) + static_cast<size_t>(p) * d + f0 : P;
    for (int f = 0; f < dc; ++f)
      dload::stage(buf + f * LDS + k, valid ? src + f : P, valid);
  }
}

template <bool L1>
__device__ __forceinline__ void accumulate(float (&acc)[8][8],
                                           const float* buf, int dc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* xs = buf + 4 * ty;
  const float* zs = buf + BM + 4 * tx;
#pragma unroll 2
  for (int f = 0; f < dc; ++f) {
    float xv[8], zv[8];
    load4(xv, 0, xs + f * LDS);
    load4(xv, 4, xs + f * LDS + 32);
    load4(zv, 0, zs + f * LDS);
    load4(zv, 4, zs + f * LDS + 64);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = dist_step<L1>(acc[i][j], xv[i], zv[j]);
  }
}

// One block per node of every group (points ptr[0] and landmarks ptr[1],
// of type S; Linv ptr[2], U ptr[3]).  Per row tile, every step of the
// chunk loop stages the next chunk (of this tile or of the next) and sums
// the current one; then the tile's distances become K and the warps run
// the products.
template <int NT, typename S>
__global__ void __launch_bounds__(tc::kThreads, tc::kMinBlocks)
cross_points_tc_kernel(const __grid_constant__ Table<float> tab, int r,
                             int d, int kind, float sigma) {
  static_assert(NT % tc::kGroup == 0 && NT <= tc::kMaxTiles, "NT");
  constexpr int RP = 8 * NT, LDL = tc::linv_stride(NT);
  extern __shared__ __align__(16) float smem[];
  float* li = smem;                    // (RP, LDL): Linv
  float* ka = li + RP * LDL;           // (BM, LDL): K of the row tile
  float* buf = ka + BM * LDL;          // 2 x (DC, LDS)
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m;
  const S* P = reinterpret_cast<const S*>(tab.g[gi].ptr[0]) +
               static_cast<size_t>(node) * m * d;
  const S* Z = reinterpret_cast<const S*>(tab.g[gi].ptr[1]) +
               static_cast<size_t>(node) * r * d;
  const float* lsrc = tab.g[gi].ptr[2] + static_cast<size_t>(node) * r * r;
  float* U = tab.g[gi].ptr[3] + static_cast<size_t>(node) * m * r;
  const bool l1 = kind_is_l1(kind);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nch = (d + DC - 1) / DC;
  const int tiles = (m + BM - 1) / BM;

  tc::stage_linv<NT>(li, lsrc, r);
  stage(buf, P, Z, m, r, d, 0, 0, min(DC, d));
  acopy::commit();
  for (int tile = 0, s = 0; tile < tiles; ++tile) {
    const int row0 = tile * BM;
    float acc[8][8];                   // dead before the products begin
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < nch; ++c, ++s) {
      // the next chunk in flight: this tile's next, or the next tile's first
      const bool last = c + 1 == nch;
      if (!last || tile + 1 < tiles) {
        const int cn = last ? 0 : c + 1;
        stage(buf + ((s + 1) & 1) * DC * LDS, P, Z, m, r, d,
              row0 + (last ? BM : 0), cn * DC, min(DC, d - cn * DC));
        acopy::commit();
        acopy::wait<1>();
      } else {
        acopy::wait<0>();
      }
      __syncthreads();                           // chunk s (and Linv) staged
      const float* cur = buf + (s & 1) * DC * LDS;
      if (l1)
        accumulate<true>(acc, cur, min(DC, d - c * DC));
      else
        accumulate<false>(acc, cur, min(DC, d - c * DC));
      __syncthreads();                           // chunk s is consumed
    }
    // K of the tile: zero past m, past r and up to RP columns (the last
    // tile's products, which read K, ended before the barrier above)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 4 * ty + i + 32 * h;
        const bool live = row0 + row < m;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c0 = 4 * tx + 64 * q;
          if (c0 >= RP) continue;
          const float* a = acc[4 * h + i] + 4 * q;
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = live && c0 + j < r ? kernel_epilogue<float>(kind, a[j],
                                                               sigma)
                                      : 0.f;
          *reinterpret_cast<float4*>(ka + row * LDL + c0) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    __syncthreads();                             // K is in shared memory
    if (row0 + 16 * warp < m) {                  // this warp's strip
      const int srow = 16 * warp + g;
      float y[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const float* kp = ka + srow * LDL + 8 * kk + t;
        uint32_t ah[4], al[4];
        tf32x3::split(kp[0], ah[0], al[0]);
        tf32x3::split(kp[8 * LDL], ah[1], al[1]);
        tf32x3::split(kp[4], ah[2], al[2]);
        tf32x3::split(kp[8 * LDL + 4], ah[3], al[3]);
        tc::y_step<NT>(y, kk, ah, al, li, g, t);
      }
      float u[NT][4];
      tc::u_product<NT>(u, y, li, g, t);
      tc::store_u<NT>(U + static_cast<size_t>(row0) * r, u, srow, m - row0,
                      r, t);
    }
  }
}

template <int NT, typename S>
int launch_tc(const Table<float>& tab, long long nodes, int r, int d,
              int kind, double sigma, cudaStream_t stream) {
  const auto kernel = cross_points_tc_kernel<NT, S>;
  const size_t smem = smem_bytes(r);
  const int err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<static_cast<unsigned>(nodes), tc::kThreads, smem, stream>>>(
      tab, r, d, kind, static_cast<float>(sigma));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cross

// ---------------------------------------------------------------------------
// B2: cross_solve_levels in float64 (CUDA cores, cross_products.cuh)
// ---------------------------------------------------------------------------

namespace cross64 {

constexpr int DC = 32;       // feature columns staged per chunk
using cross_tile::NR;
using cross_tile::TX;
using cross_tile::TY;

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

// One block per (group, node, tile of BM rows).
template <typename T, int MR>
__global__ void __launch_bounds__(cross_tile::kThreads)
cross_points_kernel(const __grid_constant__ Table<T> tab, int r, int d,
                    int kind, T sigma) {
  constexpr int BM = TY * MR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int b = blockIdx.x;
  int gi = 0;
  while (true) {                       // tiles per node differ by group
    const int blocks = tab.g[gi].nodes * ((tab.g[gi].m + BM - 1) / BM);
    if (b < blocks) break;
    b -= blocks;
    ++gi;
  }
  const int m = tab.g[gi].m, tiles = (m + BM - 1) / BM;
  const size_t node = b / tiles;
  const int row0 = (b % tiles) * BM;
  const int rows = min(BM, m - row0);
  const T* P = tab.g[gi].ptr[0] + (node * m + row0) * d;
  const T* Z = tab.g[gi].ptr[1] + node * r * d;
  const int ldr = r + 1;
  T* li = reinterpret_cast<T*>(smem_raw);             // (r, ldr): Linv
  T* ka = li + static_cast<size_t>(r) * ldr;          // (BM, ldr): K, then Y
  T* xs = ka + BM * ldr;                              // (BM, DC + 1)
  T* zs = xs + BM * (DC + 1);                         // (r, DC + 1)
  const bool l1 = kind_is_l1(kind);
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  int col[NR];
  cross_tile::columns(col, r);

  cross_tile::stage_linv(li, tab.g[gi].ptr[2] + node * r * r, r);
  T acc[MR][NR];
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int c = 0; c < NR; ++c) acc[a][c] = T(0);

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
      for (int c = 0; c < NR; ++c) zv[c] = zs[col[c] * (DC + 1) + t];
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int c = 0; c < NR; ++c)
          acc[a][c] = l1 ? dist_step<true>(acc[a][c], xv[a], zv[c])
                         : dist_step<false>(acc[a][c], xv[a], zv[c]);
    }
  }
  // kernel values; rows past the tile's end are zero
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      const int i = ty + TY * a;
      if (tx + TX * c < r)
        ka[i * ldr + tx + TX * c] =
            i < rows ? kernel_epilogue<T>(kind, acc[a][c], sigma) : T(0);
    }
  cross_tile::products<T, MR>(ka, li, r, col, acc);
  cross_tile::store<T, MR>(tab.g[gi].ptr[3] + (node * m + row0) * r, rows, r,
                           acc);
}

template <typename T, int MR>
int launch_tile(const Table<T>& tab, int groups, int r, int d, int kind,
                T sigma, cudaStream_t stream) {
  constexpr int BM = TY * MR;
  long long blocks = 0;
  for (int i = 0; i < groups; ++i)
    blocks += static_cast<long long>(tab.g[i].nodes) *
              ((tab.g[i].m + BM - 1) / BM);
  if (blocks == 0) return 0;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const size_t smem = (static_cast<size_t>(r + BM) * (r + 1)
                       + static_cast<size_t>(BM + r) * (DC + 1)) * sizeof(T);
  const int err = launch_with_smem(cross_points_kernel<T, MR>, smem);
  if (err) return err;
  cross_points_kernel<T, MR><<<static_cast<unsigned>(blocks),
                               cross_tile::kThreads, smem, stream>>>(
      tab, r, d, kind, sigma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cross64

}  // namespace

// Grouped launches: ``table`` is a host array of ``groups`` int64 rows,
// (points, gram, chol, nodes, m) for gram_chol_levels (chol 0 in a launch
// without factors, ``want_chol`` 0) and (points, landmarks, linv, out,
// nodes, m) for cross_solve_levels.  The _bf16 entries take bfloat16
// points and landmarks, float32 Linv and outputs.  They are compiled
// apart, in build_stage_bf16.cu (REPRO_BF16_ENTRIES): instantiated in this
// translation unit they change how nvcc compiles the float32 and float64
// entries (B2's float32 NT 16 entry then spills).
namespace {

template <typename S>
int cross_levels_tc(const void* table, int groups, int r, int d, int kind,
                    double sigma, void* stream) {
  if (r <= 0) return 0;
  if (r > 8 * tc::kMaxTiles || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Table<float> tab;
  long long nodes;
  int mmax;
  const int err = levels::read_table(table, groups, 4, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc::tiles(r)) {
    case 4:
      return cross::launch_tc<4, S>(tab, nodes, r, d, kind, sigma, st);
    case 8:
      return cross::launch_tc<8, S>(tab, nodes, r, d, kind, sigma, st);
    case 12:
      return cross::launch_tc<12, S>(tab, nodes, r, d, kind, sigma, st);
    default:
      return cross::launch_tc<16, S>(tab, nodes, r, d, kind, sigma, st);
  }
}

}  // namespace

#if defined(REPRO_BF16_ENTRIES)

extern "C" int gram_chol_levels_bf16(const void* table, int groups, int d,
                                     int kind, double sigma, double jitter,
                                     int want_chol, void* stream) {
  return gram::launch<float, __nv_bfloat16>(table, groups, d, kind, sigma,
                                            jitter, want_chol, stream);
}

extern "C" int cross_solve_levels_bf16(const void* table, int groups, int r,
                                       int d, int kind, double sigma,
                                       void* stream) {
  return cross_levels_tc<__nv_bfloat16>(table, groups, r, d, kind, sigma,
                                        stream);
}

#elif defined(REPRO_PANEL_ENTRIES)

// the panel forms' entries follow this file in build_stage_panel.cu

#else

extern "C" int gram_chol_levels_f32(const void* table, int groups, int d,
                                    int kind, double sigma, double jitter,
                                    int want_chol, void* stream) {
  return gram::launch<float, float>(table, groups, d, kind, sigma, jitter,
                                    want_chol, stream);
}

extern "C" int gram_chol_levels_f64(const void* table, int groups, int d,
                                    int kind, double sigma, double jitter,
                                    int want_chol, void* stream) {
  return gram::launch<double, double>(table, groups, d, kind, sigma, jitter,
                                      want_chol, stream);
}

extern "C" int cross_solve_levels_f32(const void* table, int groups, int r,
                                      int d, int kind, double sigma,
                                      void* stream) {
  return cross_levels_tc<float>(table, groups, r, d, kind, sigma, stream);
}

extern "C" int cross_solve_levels_f64(const void* table, int groups, int r,
                                      int d, int bm, int kind, double sigma,
                                      void* stream) {
  using cross_tile::TY;
  if (r <= 0) return 0;
  if (r > cross_tile::TX * cross_tile::NR || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Table<double> tab;
  long long nodes;
  int mmax;
  const int err = levels::read_table(table, groups, 4, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case TY * 8:
      return cross64::launch_tile<double, 8>(tab, groups, r, d, kind, sigma,
                                             st);
    case TY * 4:
      return cross64::launch_tile<double, 4>(tab, groups, r, d, kind, sigma,
                                             st);
    case TY * 2:
      return cross64::launch_tile<double, 2>(tab, groups, r, d, kind, sigma,
                                             st);
    case TY:
      return cross64::launch_tile<double, 1>(tab, groups, r, d, kind, sigma,
                                             st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#endif  // REPRO_BF16_ENTRIES, REPRO_PANEL_ENTRIES

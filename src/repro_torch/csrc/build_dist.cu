// The per-sigma stages of the hyperparameter sweep engine
// (repro.core.hck.sweep_factors): the factors at one bandwidth from
// metric distances cached once per grid (SweepPlan), every level of a
// stage in one grouped launch (level_groups.cuh's table, one group a
// level):
//
//   gram_chol_dist_levels   per group D_b (m, m) -> G_b = kappa_sigma(D_b)
//                           + jitter*m I and its lower Cholesky factor L_b
//                           (every level's Sigma);
//   gram_dist               one level's Gram without a factor (the leaf
//                           Adiag blocks);
//   cross_solve_dist_levels per group D_b (m, r), Linv_b (r, r) ->
//                           U_b = kappa_sigma(D_b) Linv_b^T Linv_b (U and
//                           every level's W), one r for all groups.
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/build_stage/build_stage.py::gram_chol_dist_kernel
//   (_gram_chol_dist_body; gram_chol_dist and gram_dist are its want_chol
//   and Gram-only forms) and ::cross_solve_dist_kernel
//   (_cross_solve_dist_body).
//
// All arrays row-major and contiguous; T is float or double.  The
// epilogue is kernel_epilogue.cuh's, as in build_stage.cu's gram_chol and
// cross_solve kernels, which compute the same factors from points: on
// the same distances both give the same bits.
//
// Every Sigma level depends only on its cached tile, and U and every W
// level only on cached tiles and on Linv, which exist once Sigma is
// factored, so one launch a stage covers all levels and the top levels'
// few blocks run inside the largest level's waves:
//   gram_chol_dist_levels   one block of 128 threads a tile, staged with
//       cp.async, the epilogue applied in shared memory, then B3's blocked
//       factor (chol_blocked.cuh: panels of 32, a warp-level diagonal
//       factor, forward substitution, register-tiled trailing updates);
//       no pivot clamp (a tile that is not positive definite gives NaN,
//       build_stage.py:85-86); three n = 128 f32 tiles share an SM;
//       m <= 240 in f32, m <= 169 in f64 (larger tiles, up to 512, take
//       the panel form: build_dist_panel.cu);
//   gram_dist               a pure elementwise pass: a grid-stride loop
//       with one warp per row of the stacked blocks;
//   cross_solve_dist_levels in f32 cross_tc.cuh's split-TF32 products on
//       mma.sync with K read straight from the cached distances, Linv's
//       zero upper triangle skipped by 8-column k-step; in f64 the
//       CUDA-core tile of cross_products.cuh over every (group, node, row
//       tile of bm = 16, 32, 64 or 128 rows); r <= 128 (ranks up to 256
//       take the panel form, build_dist_panel.cu); (r + bm)(r + 1)
//       values must fit: bm = 64 in f64 at r = 128 (the wrapper picks and
//       raises).
// A block finds its group from the prefix of block counts.
//
// bfloat16-data entries (gram_dist_bf16, gram_chol_dist_levels_bf16,
// cross_solve_dist_levels_bf16; a mixed-precision policy's sweep): the
// cached distance tiles are bfloat16, Linv and every output float32.
// They are the float32 kernels with another load type for the tiles
// (data_load.cuh): each distance is converted to float32 as it is read
// (B8 stores it converted into its shared tile, a plain store where the
// float32 entry copies with cp.async), so from there they compute exactly
// what the float32 entries compute; shared memory and the limits on m and
// r are those of float32.
//
// Bounds on the H100 at the covtype shapes (f32, n0 = r = 128, L = 12):
//   gram_dist (4,096 Adiag blocks) is bound by bytes: 268 MB read and
//   268 MB written, ~0.16 ms.  gram_chol_dist over the 12 Sigma levels
//   (4,095 tiles) is bound by bytes too (~0.24 ms), but each tile is a
//   chain of dependent steps, so the kernel is bound by that chain's
//   latency unless many tiles run side by side.  cross_solve_dist for U
//   and W (4,095 nodes x 256 rows): two products with the lower
//   triangular Linv, r(r + 1)/2 multiply-adds each per row, ~34 GFLOP:
//   0.52 ms at the 67 TFLOP/s of f32 CUDA cores; three TF32 passes at 495
//   TFLOP/s take 0.21 ms, so on the tensor cores the bytes bound it (D
//   and U 537 MB each, Linv 268 MB: ~0.40 ms).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "async_copy.cuh"
#include "chol_blocked.cuh"
#include "cross_products.cuh"
#include "cross_tc.cuh"
#include "data_load.cuh"
#include "kernel_epilogue.cuh"
#include "level_groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowWarps = kThreads / 32;      // gram_dist: rows per step
using cross_tile::NR;
using cross_tile::TX;
using cross_tile::TY;

// rows = B * m rows of m values (dist of type S); row i of a block gets
// diag_add at column i % m.  One warp per row, lanes over columns.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
gram_dist_kernel(const S* __restrict__ dist, T* __restrict__ gram,
                 long long rows, int m, int kind, T sigma, T diag_add) {
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kRowWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kRowWarps
                       + (threadIdx.x >> 5);
       row < rows; row += step) {
    const int diag = static_cast<int>(row % m);
    const S* d = dist + row * m;
    T* g = gram + row * m;
#pragma unroll 4
    for (int c = lane; c < m; c += 32) {
      T v = kernel_epilogue<T>(kind, dload::load<T>(d + c), sigma);
      if (c == diag) v += diag_add;
      g[c] = v;
    }
  }
}

// U rows [row0, row0 + rows) of one node: D and out point at the tile's
// first row, linv at the node's Linv.
template <typename T, int MR>
__device__ __forceinline__ void cross_tile_rows(const T* __restrict__ D,
                                                const T* __restrict__ linv,
                                                T* __restrict__ out, int rows,
                                                int r, int kind, T sigma) {
  constexpr int BM = TY * MR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldr = r + 1;
  T* li = reinterpret_cast<T*>(smem_raw);             // (r, ldr): Linv
  T* ka = li + static_cast<size_t>(r) * ldr;          // (BM, ldr): K, then Y
  int col[NR];
  cross_tile::columns(col, r);

  cross_tile::stage_linv(li, linv, r);
  // kernel values of the tile; rows past its end are zero
  for (int e = threadIdx.x; e < BM * r; e += blockDim.x) {
    const int i = e / r;
    const int c = e - i * r;
    ka[i * ldr + c] = i < rows ? kernel_epilogue<T>(kind, D[e], sigma) : T(0);
  }
  T acc[MR][NR];
  cross_tile::products<T, MR>(ka, li, r, col, acc);
  cross_tile::store<T, MR>(out, rows, r, acc);
}

template <typename T, typename S>
int launch_gram(const void* dist, void* gram, int b, int m, int kind,
                double sigma, double diag_add, void* stream) {
  if (b == 0 || m == 0) return 0;
  const long long rows = static_cast<long long>(b) * m;
  // enough blocks to fill every SM (8 blocks of 256 threads each) twice
  const long long want = (rows + kRowWarps - 1) / kRowWarps;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  gram_dist_kernel<T, S><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(dist), static_cast<T*>(gram), rows, m, kind,
      static_cast<T>(sigma), static_cast<T>(diag_add));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Grouped launches: every level of one sigma in one launch
// ---------------------------------------------------------------------------

using levels::find_group;
using levels::Table;

// B8, grouped: one block of 128 threads per Sigma tile of every level.
// The tile (of type S) is staged with cp.async (converted by its threads
// where S is bfloat16) at an odd row stride, the epilogue (and jitter * m
// on the diagonal) applied in place and the Gram written; the tile is
// then factored by chol_blocked.cuh, B3's blocked routine, and the lower
// triangle written with zeros above it.  No pivot clamp.
template <typename T, typename S>
__global__ void __launch_bounds__(chol_blocked::kThreads,
                                  sizeof(T) == 4 ? 3 : 1)
gram_chol_levels_kernel(const __grid_constant__ Table<T> tab, int kind,
                        T sigma, double jitter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m, lda = m | 1;
  const T diag_add = static_cast<T>(jitter * m);
  T* a = reinterpret_cast<T*>(smem_raw);              // (m, lda)
  T* rdiag = a + m * lda;                             // (m,)
  T* col = reinterpret_cast<T*>(
      smem_raw + chol_blocked::col_offset(m, lda, sizeof(T)));
  const size_t off = static_cast<size_t>(node) * m * m;
  const S* D = reinterpret_cast<const S*>(tab.g[gi].ptr[0]) + off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = chol_blocked::kWarps;

  for (int r = warp; r < m; r += kWarps)
    for (int c = lane; c < m; c += 32)
      dload::stage(a + r * lda + c, D + static_cast<size_t>(r) * m + c,
                   true);
  acopy::commit();
  acopy::wait<0>();                    // each thread reads its own copies
  T* G = tab.g[gi].ptr[1] + off;
  for (int r = warp; r < m; r += kWarps)
    for (int c = lane; c < m; c += 32) {
      T v = kernel_epilogue<T>(kind, a[r * lda + c], sigma);
      if (r == c) v += diag_add;
      a[r * lda + c] = v;
      G[static_cast<size_t>(r) * m + c] = v;
    }
  __syncthreads();
  chol_blocked::factor_panels(a, lda, rdiag, col, m);
  T* L = tab.g[gi].ptr[2] + off;
  for (int r = warp; r < m; r += kWarps)
    for (int c = lane; c < m; c += 32)
      L[static_cast<size_t>(r) * m + c] = c <= r ? a[r * lda + c] : T(0);
}

// B9 in float64, grouped: cross_tile_rows (CUDA-core
// products of cross_products.cuh) over every (group, node, row tile).
template <typename T, int MR>
__global__ void __launch_bounds__(cross_tile::kThreads)
cross_levels_kernel(const __grid_constant__ Table<T> tab, int r, int kind,
                    T sigma) {
  constexpr int BM = TY * MR;
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
  const size_t first = (node * m + row0) * r;
  cross_tile_rows<T, MR>(tab.g[gi].ptr[0] + first,
                         tab.g[gi].ptr[1] + node * r * r,
                         tab.g[gi].ptr[2] + first, min(BM, m - row0), r, kind,
                         sigma);
}

// B9 in float32, grouped, on the tensor cores: cross_tc.cuh's split-TF32
// products with K read from the cached distances.
namespace b9 {

using tc::kChunk;
using tc::kThreads;
using tc::kWarps;

// The raw distances (of type S, read as float32) of k-steps kChunk c ..
// kChunk c + kChunk - 1 of this lane's rows row0 and row0 + 8, in
// A-fragment order: d[u] = (row0, col), (row0 + 8, col), (row0, col + 4),
// (row0 + 8, col + 4) with col = 8 kk + t.  Past m or r the distance is
// +inf, whose kernel value is 0 for every base kernel.
template <typename S>
__device__ __forceinline__ void load_chunk(float (&d)[kChunk][4],
                                           const S* __restrict__ D,
                                           int row0, int m, int r, int c,
                                           int t) {
  const size_t r0 = static_cast<size_t>(row0) * r;
  const size_t r1 = r0 + static_cast<size_t>(8) * r;
  const bool v0 = row0 < m, v1 = row0 + 8 < m;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int c0 = 8 * (kChunk * c + u) + t, c1 = c0 + 4;
    d[u][0] = (v0 && c0 < r) ? dload::ldg<float>(D + r0 + c0) : INFINITY;
    d[u][1] = (v1 && c0 < r) ? dload::ldg<float>(D + r1 + c0) : INFINITY;
    d[u][2] = (v0 && c1 < r) ? dload::ldg<float>(D + r0 + c1) : INFINITY;
    d[u][3] = (v1 && c1 < r) ? dload::ldg<float>(D + r1 + c1) : INFINITY;
  }
}

// One block per node (of every group), 4 warps; each warp takes strips of
// 16 rows of the node's m.  Per strip, Y = K Linv^T takes A = K's
// fragments straight from device memory (the epilogue applied and split
// in registers; every distance is read once; the next chunk of kChunk
// k-steps in flight while this one is used), then U = Y Linv
// (cross_tc.cuh).  The node's Linv stays in shared memory across its
// strips; the next strip's first loads of K are in flight while U is
// computed.
template <int NT, typename S>
__global__ void __launch_bounds__(kThreads, tc::kMinBlocks)
cross_levels_tc_kernel(const __grid_constant__ Table<float> tab, int r,
                       int kind, float sigma) {
  static_assert(NT % kChunk == 0 && NT % tc::kGroup == 0 &&
                NT <= tc::kMaxTiles, "NT");
  constexpr int NCH = NT / kChunk;
  extern __shared__ __align__(16) float li[];  // (8 NT, linv_stride(NT))
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m;
  const S* D = reinterpret_cast<const S*>(tab.g[gi].ptr[0]) +
               static_cast<size_t>(node) * m * r;
  const float* lsrc = tab.g[gi].ptr[1] + static_cast<size_t>(node) * r * r;
  float* U = tab.g[gi].ptr[2] + static_cast<size_t>(node) * m * r;
  const int tid = threadIdx.x;
  tc::stage_linv<NT>(li, lsrc, r);

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int strips = (m + 15) / 16;
  float buf[2][kChunk][4];             // chunks c and c + 1 of K
  if (warp < strips) load_chunk(buf[0], D, 16 * warp + g, m, r, 0, t);
  acopy::wait<0>();
  __syncthreads();                     // Linv is staged

  for (int st = warp; st < strips; st += kWarps) {
    const int row0 = 16 * st + g;
    float y[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] = 0.f;

#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float (&cur)[kChunk][4] = buf[c & 1];
      if (c + 1 < NCH)
        load_chunk(buf[(c + 1) & 1], D, row0, m, r, c + 1, t);
      else if (st + kWarps < strips)   // the next strip's first chunk
        load_chunk(buf[(c + 1) & 1], D, row0 + 16 * kWarps, m, r, 0, t);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32x3::split(kernel_epilogue<float>(kind, cur[u][e], sigma),
                        ah[e], al[e]);
        tc::y_step<NT>(y, kChunk * c + u, ah, al, li, g, t);
      }
    }
    if (NCH % 2 == 1) {                // the next strip starts at buf[0]
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) buf[0][u][e] = buf[1][u][e];
    }
    float acc[NT][4];
    tc::u_product<NT>(acc, y, li, g, t);
    tc::store_u<NT>(U, acc, row0, m, r, t);
  }
}

}  // namespace b9

template <typename T, typename S>
int launch_gram_levels(const void* table, int groups, int kind, double sigma,
                       double jitter, void* stream) {
  Table<T> tab;
  long long nodes;
  int mmax;
  int err = levels::read_table(table, groups, 3, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  const auto kernel = gram_chol_levels_kernel<T, S>;
  const size_t smem = chol_blocked::col_offset(mmax, mmax | 1, sizeof(T)) +
                      chol_blocked::NB * sizeof(T);
  err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<static_cast<unsigned>(nodes), chol_blocked::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(tab, kind,
                                                static_cast<T>(sigma), jitter);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MR>
int launch_cross_levels_tile(const Table<T>& tab, int groups, int r,
                             int kind, T sigma, cudaStream_t stream) {
  constexpr int BM = TY * MR;
  long long blocks = 0;
  for (int i = 0; i < groups; ++i)
    blocks += static_cast<long long>(tab.g[i].nodes) *
              ((tab.g[i].m + BM - 1) / BM);
  if (blocks == 0) return 0;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(r + BM) * (r + 1) * sizeof(T);
  const int err = launch_with_smem(cross_levels_kernel<T, MR>, smem);
  if (err) return err;
  cross_levels_kernel<T, MR><<<static_cast<unsigned>(blocks),
                               cross_tile::kThreads, smem, stream>>>(
      tab, r, kind, sigma);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, typename S>
int launch_cross_tc(const Table<float>& tab, long long nodes, int r, int kind,
                    double sigma, cudaStream_t stream) {
  const auto kernel = b9::cross_levels_tc_kernel<NT, S>;
  const size_t smem = tc::linv_bytes(r);
  const int err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<static_cast<unsigned>(nodes), tc::kThreads, smem, stream>>>(
      tab, r, kind, static_cast<float>(sigma));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int cross_dist_levels_tc(const void* table, int groups, int r, int kind,
                         double sigma, void* stream) {
  if (r <= 0) return 0;
  if (r > 8 * tc::kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  Table<float> tab;
  long long nodes;
  int mmax;
  const int err = levels::read_table(table, groups, 3, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc::tiles(r)) {
    case 4:
      return launch_cross_tc<4, S>(tab, nodes, r, kind, sigma, st);
    case 8:
      return launch_cross_tc<8, S>(tab, nodes, r, kind, sigma, st);
    case 12:
      return launch_cross_tc<12, S>(tab, nodes, r, kind, sigma, st);
    default:
      return launch_cross_tc<16, S>(tab, nodes, r, kind, sigma, st);
  }
}

}  // namespace

// The _bf16 entries take bfloat16 distance tiles, float32 Linv and
// outputs.  They are compiled apart, in build_dist_bf16.cu
// (REPRO_BF16_ENTRIES), so that the float32 and float64 entries compile
// as they do alone.  The grouped launches (one per sigma on the sweep
// path) take ``table``, a host array of ``groups`` rows of int64 values.
#if defined(REPRO_BF16_ENTRIES)

extern "C" int gram_dist_bf16(const void* dist, void* gram, int b, int m,
                              int kind, double sigma, double diag_add,
                              void* stream) {
  return launch_gram<float, __nv_bfloat16>(dist, gram, b, m, kind, sigma,
                                           diag_add, stream);
}

extern "C" int gram_chol_dist_levels_bf16(const void* table, int groups,
                                          int kind, double sigma,
                                          double jitter, void* stream) {
  return launch_gram_levels<float, __nv_bfloat16>(table, groups, kind, sigma,
                                                  jitter, stream);
}

extern "C" int cross_solve_dist_levels_bf16(const void* table, int groups,
                                            int r, int kind, double sigma,
                                            void* stream) {
  return cross_dist_levels_tc<__nv_bfloat16>(table, groups, r, kind, sigma,
                                             stream);
}

#elif defined(REPRO_PANEL_ENTRIES)

// the panel forms' entries follow this file in build_dist_panel.cu

#else

extern "C" int gram_dist_f32(const void* dist, void* gram, int b, int m,
                             int kind, double sigma, double diag_add,
                             void* stream) {
  return launch_gram<float, float>(dist, gram, b, m, kind, sigma, diag_add,
                                   stream);
}

extern "C" int gram_dist_f64(const void* dist, void* gram, int b, int m,
                             int kind, double sigma, double diag_add,
                             void* stream) {
  return launch_gram<double, double>(dist, gram, b, m, kind, sigma, diag_add,
                                     stream);
}

extern "C" int gram_chol_dist_levels_f32(const void* table, int groups,
                                         int kind, double sigma,
                                         double jitter, void* stream) {
  return launch_gram_levels<float, float>(table, groups, kind, sigma, jitter,
                                          stream);
}

extern "C" int gram_chol_dist_levels_f64(const void* table, int groups,
                                         int kind, double sigma,
                                         double jitter, void* stream) {
  return launch_gram_levels<double, double>(table, groups, kind, sigma,
                                            jitter, stream);
}

extern "C" int cross_solve_dist_levels_f32(const void* table, int groups,
                                           int r, int kind, double sigma,
                                           void* stream) {
  return cross_dist_levels_tc<float>(table, groups, r, kind, sigma, stream);
}

extern "C" int cross_solve_dist_levels_f64(const void* table, int groups,
                                           int r, int bm, int kind,
                                           double sigma, void* stream) {
  if (r <= 0) return 0;
  if (r > TX * NR) return static_cast<int>(cudaErrorInvalidValue);
  Table<double> tab;
  long long nodes;
  int mmax;
  const int err = levels::read_table(table, groups, 3, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case TY * 8:
      return launch_cross_levels_tile<double, 8>(tab, groups, r, kind, sigma,
                                                 st);
    case TY * 4:
      return launch_cross_levels_tile<double, 4>(tab, groups, r, kind, sigma,
                                                 st);
    case TY * 2:
      return launch_cross_levels_tile<double, 2>(tab, groups, r, kind, sigma,
                                                 st);
    case TY:
      return launch_cross_levels_tile<double, 1>(tab, groups, r, kind, sigma,
                                                 st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#endif  // REPRO_BF16_ENTRIES, REPRO_PANEL_ENTRIES

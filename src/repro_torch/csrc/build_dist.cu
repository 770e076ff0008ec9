// The per-sigma stages of the hyperparameter sweep engine
// (repro.core.hck.sweep_factors): the factors at one bandwidth from
// metric distances cached once per grid (SweepPlan):
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
// All arrays row-major and contiguous; T is float or double.  The
// epilogue is kernel_epilogue.cuh's, as in the fused gram_chol /
// cross_solve kernels (build_stage.cu).
//
// The sweep path launches the grouped forms, one launch per sigma for all
// levels of a stage (every Sigma level depends only on its cached tile;
// U and every W level only on cached tiles and on Linv, which exist once
// Sigma is factored), so the top levels' few blocks run inside the
// largest level's waves:
//   gram_chol_dist_levels   all L Sigma levels: one block of 128 threads a
//       tile, staged with cp.async, the epilogue applied in shared memory,
//       then B3's blocked factor (chol_blocked.cuh: panels of 32, a
//       warp-level diagonal factor, forward substitution, register-tiled
//       trailing updates) in place of the column-by-column chol_smem;
//       three n = 128 f32 tiles share an SM;
//   cross_solve_dist_levels U and the W of levels 1..L-1: in f32 on the
//       tensor cores in split TF32 (mma.sync, tc:: below), Linv's zero
//       upper triangle skipped by 8-column k-step; in f64 the CUDA-core
//       tile below over every (group, node, row tile).
// A host table of per-group pointers and shapes (read_table) is passed by
// value; a block finds its group from the prefix of block counts.
// The per-level kernels (gram_chol_dist_kernel on chol_smem.cuh,
// cross_solve_dist_kernel on cross_products.cuh, every sum in T) stay for
// the single-level wrappers and as the designs the grouped ones are timed
// against.
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
//
// Per-level designs.  gram_chol_dist: one block per node; the tile is
// turned into kernel values in a shared tile of row stride m + 1 and
// written as the Gram, then factored in place by chol_smem.cuh with no
// pivot clamp (a block that is not positive definite gives NaN,
// build_stage.py:85-86).  m <= 240 in f32, m <= 169 in f64 (both forms;
// the wrappers raise beyond).  gram_dist is a pure elementwise pass: a
// grid-stride loop with one warp per row of the stacked blocks.
// cross_solve_dist: grid (node, tile of bm = 16, 32, 64 or 128 rows); the
// node's Linv and the tile's kernel values are staged in shared memory
// and cross_products.cuh runs the two register-tiled products of
// cross_solve.  r <= 128; (r + bm)(r + 1) values must fit: bm = 128 in
// f32, 64 in f64 at r = 128 (the wrapper picks and raises).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "async_copy.cuh"
#include "chol_blocked.cuh"
#include "chol_smem.cuh"
#include "cross_products.cuh"
#include "kernel_epilogue.cuh"
#include "tf32x3.cuh"

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

template <typename T, int MR>
__global__ void __launch_bounds__(cross_tile::kThreads)
cross_solve_dist_kernel(const T* __restrict__ dist,
                        const T* __restrict__ linv, T* __restrict__ out,
                        int m, int r, int kind, T sigma) {
  constexpr int BM = TY * MR;
  const size_t node = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const size_t first = (node * m + row0) * r;
  cross_tile_rows<T, MR>(dist + first, linv + node * r * r, out + first,
                         min(BM, m - row0), r, kind, sigma);
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

// ---------------------------------------------------------------------------
// Grouped launches: every level of one sigma in one launch
// ---------------------------------------------------------------------------

// A group is one tree level's stacked tiles; the wrapper passes a host
// table of int64 rows (pointer, pointer, pointer, nodes, m) that the entry
// points copy into these structs, passed by value.  Groups need not be
// contiguous in memory (rank masks replace single levels' Linv).
constexpr int kMaxGroups = 32;
constexpr int kTableCols = 5;

template <typename T>
struct Group {
  const T* dist;
  const T* linv;        // cross: the parent's Linv; gram: unused
  T* out;               // cross: U; gram: the Cholesky factor
  T* gram;              // gram: the Gram; cross: unused
  int nodes;
  int m;
};

template <typename T>
struct Table {
  Group<T> g[kMaxGroups];
};

// The group of a kernel's node ``b`` (one block a node) and, in ``b``,
// the node's index within it: a prefix of node counts (groups of 0 nodes
// are passed over).
template <typename T>
__device__ __forceinline__ int find_group(const Table<T>& tab, int& b) {
  int gi = 0;
  while (b >= tab.g[gi].nodes) {
    b -= tab.g[gi].nodes;
    ++gi;
  }
  return gi;
}

// B8, grouped: one block of 128 threads per Sigma tile of every level.
// The tile is staged with cp.async at an odd row stride, the epilogue (and
// jitter * m on the diagonal) applied in place and the Gram written; the
// tile is then factored by chol_blocked.cuh, B3's blocked routine, and the
// lower triangle written with zeros above it.  No pivot clamp.
template <typename T>
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
  const T* D = tab.g[gi].dist + off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = chol_blocked::kWarps;

  for (int r = warp; r < m; r += kWarps)
    for (int c = lane; c < m; c += 32)
      acopy::element(a + r * lda + c, D + static_cast<size_t>(r) * m + c,
                     true);
  acopy::commit();
  acopy::wait<0>();                    // each thread reads its own copies
  T* G = tab.g[gi].gram + off;
  for (int r = warp; r < m; r += kWarps)
    for (int c = lane; c < m; c += 32) {
      T v = kernel_epilogue<T>(kind, a[r * lda + c], sigma);
      if (r == c) v += diag_add;
      a[r * lda + c] = v;
      G[static_cast<size_t>(r) * m + c] = v;
    }
  __syncthreads();
  chol_blocked::factor_panels(a, lda, rdiag, col, m);
  T* L = tab.g[gi].out + off;
  for (int r = warp; r < m; r += kWarps)
    for (int c = lane; c < m; c += 32)
      L[static_cast<size_t>(r) * m + c] = c <= r ? a[r * lda + c] : T(0);
}

// B9 in float64, grouped: cross_solve_dist_kernel's tile (CUDA-core
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
  cross_tile_rows<T, MR>(tab.g[gi].dist + first,
                         tab.g[gi].linv + node * r * r,
                         tab.g[gi].out + first, min(BM, m - row0), r, kind,
                         sigma);
}

// B9 in float32, grouped, on the tensor cores: mma.sync.m16n8k8 in split
// TF32 (tf32x3.cuh: hi hi + hi lo + lo hi, float32 accumulation).
namespace tc {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;          // registers: 3 blocks would spill
constexpr int kMaxTiles = 16;          // r <= 128: 8-column tiles
constexpr int kChunk = 4;              // k-steps of K loaded at a time
constexpr int kGroup = 4;              // output tiles whose passes interleave

// The kernel's 8-column tiles for rank r: a multiple of kChunk (the
// instantiations 4, 8, 12, 16); Linv is zero-padded to them.
__host__ __device__ constexpr int tiles(int r) {
  return kChunk * ((r + 8 * kChunk - 1) / (8 * kChunk));
}

// Shared row stride (floats) of Linv padded to 8 nt columns: 4 mod 32, so
// that both products' fragment reads fall on 32 distinct banks.
__host__ __device__ constexpr int linv_stride(int nt) {
  return 32 * ((8 * nt + 31) / 32) + 4;
}

__host__ __device__ constexpr size_t smem_bytes(int r) {
  return sizeof(float) * 8 * tiles(r) * linv_stride(tiles(r));
}

// acc[i] += A B_i in three passes (tf32x3::mma3's terms and order) for
// the tiles i0 <= i < i1 of a group, pass by pass across the group: a
// tile's three dependent products are i1 - i0 products apart.  The
// callers' loops unroll, so i0 and i1 are constants here.
__device__ __forceinline__ void mma_group(float (*acc)[4], int i0, int i1,
                                          const uint32_t* ah,
                                          const uint32_t* al,
                                          const uint32_t (*bh)[2],
                                          const uint32_t (*bl)[2]) {
#pragma unroll
  for (int i = i0; i < i1; ++i) tf32x3::mma(acc[i], al, bh[i]);
#pragma unroll
  for (int i = i0; i < i1; ++i) tf32x3::mma(acc[i], ah, bl[i]);
#pragma unroll
  for (int i = i0; i < i1; ++i) tf32x3::mma(acc[i], ah, bh[i]);
}

// The raw distances of k-steps kChunk c .. kChunk c + kChunk - 1 of this
// lane's rows row0 and row0 + 8, in A-fragment order: d[u] = (row0, col),
// (row0 + 8, col), (row0, col + 4), (row0 + 8, col + 4) with col = 8 kk +
// t.  Past m or r the distance is +inf, whose kernel value is 0 for
// every base kernel.
__device__ __forceinline__ void load_chunk(float (&d)[kChunk][4],
                                           const float* __restrict__ D,
                                           int row0, int m, int r, int c,
                                           int t) {
  const size_t r0 = static_cast<size_t>(row0) * r;
  const size_t r1 = r0 + static_cast<size_t>(8) * r;
  const bool v0 = row0 < m, v1 = row0 + 8 < m;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int c0 = 8 * (kChunk * c + u) + t, c1 = c0 + 4;
    d[u][0] = (v0 && c0 < r) ? __ldg(D + r0 + c0) : INFINITY;
    d[u][1] = (v1 && c0 < r) ? __ldg(D + r1 + c0) : INFINITY;
    d[u][2] = (v0 && c1 < r) ? __ldg(D + r0 + c1) : INFINITY;
    d[u][3] = (v1 && c1 < r) ? __ldg(D + r1 + c1) : INFINITY;
  }
}

// One block per node (of every group), 4 warps; each warp takes strips of
// 16 rows of the node's m.  Per strip:
//   Y = K Linv^T: A = K's fragments straight from device memory (the
//   epilogue applied and split in registers; every distance is read
//   once; the next chunk of kChunk k-steps in flight while this one is
//   used), B = Linv[s][t] from shared memory; tile j of Y's columns takes
//   the k-steps kk <= j only (Linv is zero above its diagonal);
//   U = Y Linv: A = Y's accumulator read as an A fragment ({c0, c2, c1,
//   c3}, split), whose logical column p of each group of 8 is real
//   column KEY_OF[p], so B = Linv's rows 8 ks + 2t and 8 ks + 2t + 1;
//   tile jc of U takes the k-steps ks >= jc only.  Y's tile ks dies after
//   step ks and U's tile jc is born at step jc.
// Linv must be lower triangular: its 8 x 8 blocks above the diagonal are
// never read (the diagonal blocks are read whole).
// NT (the 8-column tiles, r <= 8 NT) is a template argument, so every
// loop of both products unrolls with the triangle known at compile time:
// no branch between the products (design trials with a runtime guard
// around each product ran markedly slower: every guard ends a
// basic block, so loads and products could not be scheduled across).  The node's Linv stays in shared memory across its
// strips; the next strip's first loads of K are in flight while U is
// computed.
template <int NT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cross_levels_tc_kernel(const __grid_constant__ Table<float> tab, int r,
                       int kind, float sigma) {
  static_assert(NT % kChunk == 0 && NT % kGroup == 0 && NT <= kMaxTiles,
                "NT");
  constexpr int RP = 8 * NT, LDL = linv_stride(NT), NCH = NT / kChunk;
  extern __shared__ __align__(16) float li[];         // (RP, LDL)
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m;
  const float* D = tab.g[gi].dist + static_cast<size_t>(node) * m * r;
  const float* lsrc = tab.g[gi].linv + static_cast<size_t>(node) * r * r;
  float* U = tab.g[gi].out + static_cast<size_t>(node) * m * r;
  const int tid = threadIdx.x;

  // Linv zero-padded to (RP, RP), 16 bytes a copy where rows allow it
  if (r % 4 == 0 && reinterpret_cast<size_t>(lsrc) % 16 == 0) {
    constexpr int Q4 = RP / 4;
    for (int e = tid; e < RP * Q4; e += kThreads) {
      const int s = e / Q4, c = 4 * (e - s * Q4);
      const bool ok = s < r && c < r;
      acopy::bytes16(li + s * LDL + c, ok ? lsrc + s * r + c : lsrc, ok);
    }
  } else {
    for (int e = tid; e < RP * RP; e += kThreads) {
      const int s = e / RP, c = e - s * RP;
      const bool ok = s < r && c < r;
      acopy::element(li + s * LDL + c, ok ? lsrc + s * r + c : lsrc, ok);
    }
  }
  acopy::commit();

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

    // ---- Y = K Linv^T ----
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float (&cur)[kChunk][4] = buf[c & 1];
      if (c + 1 < NCH)
        load_chunk(buf[(c + 1) & 1], D, row0, m, r, c + 1, t);
      else if (st + kWarps < strips)   // the next strip's first chunk
        load_chunk(buf[(c + 1) & 1], D, row0 + 16 * kWarps, m, r, 0, t);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int kk = kChunk * c + u;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32x3::split(kernel_epilogue<float>(kind, cur[u][e], sigma),
                        ah[e], al[e]);
        const float* lk = li + g * LDL + 8 * kk + t;
        // tiles j >= kk, a group at a time; the first group starts at kk
#pragma unroll
        for (int q = kk / kGroup; q < NT / kGroup; ++q) {
          const int i0 = max(0, kk - kGroup * q);
          uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
          for (int i = i0; i < kGroup; ++i) {
            const float* lp = lk + 8 * (kGroup * q + i) * LDL;
            tf32x3::split(lp[0], bh[i][0], bl[i][0]);
            tf32x3::split(lp[4], bh[i][1], bl[i][1]);
          }
          mma_group(y + kGroup * q, i0, kGroup, ah, al, bh, bl);
        }
      }
    }
    if (NCH % 2 == 1) {                // the next strip starts at buf[0]
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) buf[0][u][e] = buf[1][u][e];
    }

    // ---- U = Y Linv ----
    float acc[NT][4];
    const float* lrow = li + 2 * t * LDL + g;
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      uint32_t ah[4], al[4];
      tf32x3::acc_as_a(y[ks], ah, al);
      const float* lk = lrow + 8 * ks * LDL;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ks][e] = 0.f;
      // tiles jc <= ks, a group at a time; the last group ends at ks
#pragma unroll
      for (int q = 0; q <= ks / kGroup; ++q) {
        const int i1 = min(kGroup, ks + 1 - kGroup * q);
        uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
        for (int i = 0; i < i1; ++i) {
          const int jc = kGroup * q + i;
          tf32x3::split(lk[8 * jc], bh[i][0], bl[i][0]);
          tf32x3::split(lk[8 * jc + LDL], bh[i][1], bl[i][1]);
        }
        mma_group(acc + kGroup * q, 0, i1, ah, al, bh, bl);
      }
    }
    // c0, c1 at row0, columns 8 jc + 2t (+1); c2, c3 at row0 + 8
#pragma unroll
    for (int jc = 0; jc < NT; ++jc) {
      const int col = 8 * jc + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= m || col >= r) continue;
        float* o = U + static_cast<size_t>(row) * r + col;
        if (r % 2 == 0) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[jc][2 * h], acc[jc][2 * h + 1]);
        } else {
          o[0] = acc[jc][2 * h];
          if (col + 1 < r) o[1] = acc[jc][2 * h + 1];
        }
      }
    }
  }
}

}  // namespace tc

// The host table (groups x kTableCols int64: for gram dist, gram, chol,
// nodes, m; for cross dist, linv, out, nodes, m) as the kernels' struct;
// the number of nodes and the largest m.
template <typename T>
int read_table(const void* table, int groups, bool gram, Table<T>& tab,
               long long& nodes, int& mmax) {
  if (groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  const long long* row = static_cast<const long long*>(table);
  nodes = 0;
  mmax = 0;
  for (int i = 0; i < groups; ++i, row += kTableCols) {
    Group<T>& g = tab.g[i];
    g.dist = reinterpret_cast<const T*>(row[0]);
    g.linv = gram ? nullptr : reinterpret_cast<const T*>(row[1]);
    g.gram = gram ? reinterpret_cast<T*>(row[1]) : nullptr;
    g.out = reinterpret_cast<T*>(row[2]);
    g.nodes = static_cast<int>(row[3]);
    g.m = static_cast<int>(row[4]);
    nodes += g.nodes;
    if (g.m > mmax) mmax = g.m;
  }
  for (int i = groups; i < kMaxGroups; ++i) tab.g[i] = Group<T>{};
  return 0;
}

template <typename T>
int launch_gram_levels(const void* table, int groups, int kind, double sigma,
                       double jitter, void* stream) {
  Table<T> tab;
  long long nodes;
  int mmax;
  int err = read_table(table, groups, true, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  const auto kernel = gram_chol_levels_kernel<T>;
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

template <int NT>
int launch_cross_tc(const Table<float>& tab, long long nodes, int r, int kind,
                    double sigma, cudaStream_t stream) {
  const auto kernel = tc::cross_levels_tc_kernel<NT>;
  const size_t smem = tc::smem_bytes(r);
  const int err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<static_cast<unsigned>(nodes), tc::kThreads, smem, stream>>>(
      tab, r, kind, static_cast<float>(sigma));
  return static_cast<int>(cudaGetLastError());
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

// Grouped launches (one per sigma on the sweep path): ``table`` is a host
// array of ``groups`` rows of kTableCols int64 values.
extern "C" int gram_chol_dist_levels_f32(const void* table, int groups,
                                         int kind, double sigma,
                                         double jitter, void* stream) {
  return launch_gram_levels<float>(table, groups, kind, sigma, jitter,
                                   stream);
}

extern "C" int gram_chol_dist_levels_f64(const void* table, int groups,
                                         int kind, double sigma,
                                         double jitter, void* stream) {
  return launch_gram_levels<double>(table, groups, kind, sigma, jitter,
                                    stream);
}

extern "C" int cross_solve_dist_levels_f32(const void* table, int groups,
                                           int r, int kind, double sigma,
                                           void* stream) {
  if (r <= 0) return 0;
  if (r > 8 * tc::kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  Table<float> tab;
  long long nodes;
  int mmax;
  const int err = read_table(table, groups, false, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc::tiles(r)) {
    case 4:
      return launch_cross_tc<4>(tab, nodes, r, kind, sigma, st);
    case 8:
      return launch_cross_tc<8>(tab, nodes, r, kind, sigma, st);
    case 12:
      return launch_cross_tc<12>(tab, nodes, r, kind, sigma, st);
    default:
      return launch_cross_tc<16>(tab, nodes, r, kind, sigma, st);
  }
}

extern "C" int cross_solve_dist_levels_f64(const void* table, int groups,
                                           int r, int bm, int kind,
                                           double sigma, void* stream) {
  if (r <= 0) return 0;
  if (r > TX * NR) return static_cast<int>(cudaErrorInvalidValue);
  Table<double> tab;
  long long nodes;
  int mmax;
  const int err = read_table(table, groups, false, tab, nodes, mmax);
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

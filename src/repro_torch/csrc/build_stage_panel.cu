// The panel forms of the build engine's grouped stages (build_stage.cu),
// for the tiles the resident kernels cannot hold in shared memory:
//
//   gram_chol_levels_panel    B1 with factors for m past the resident
//                             kernel's (235 in float32, 163 in float64) up
//                             to 512: each node's Gram computed as
//                             gram_points_kernel computes it, into G and its
//                             lower triangle into L (zeros above it), then L
//                             factored in panels in device memory
//                             (chol_panel.cuh);
//   cross_solve_levels_panel  B2 for ranks 128 < r <= 256: each row tile's
//                             distances to the r landmarks summed as
//                             cross_points_tc_kernel sums them (two halves
//                             of 128 landmarks), K in shared memory, then
//                             cross_panel.cuh's products (split TF32 on
//                             mma.sync in float32, CUDA cores in float64).
//
// kernels/build_stage/ops.py chooses each level's form before the launch
// (gram_route, cross_route): levels that fit the resident kernel keep it,
// the others take these.  A library of its own: build_stage.cu compiled
// with REPRO_PANEL_ENTRIES (which leaves out its own entries), so that the
// resident kernels compile as they do alone (build_stage.cu notes how
// instantiations beside them change nvcc's code for B2's NT 16 entry).
// Its bfloat16-data entries (gram_chol_levels_panel_bf16,
// cross_solve_levels_panel_bf16: a mixed-precision policy's bfloat16
// points and landmarks, float32 Linv and outputs) are this file compiled
// again with REPRO_PANEL_BF16_ENTRIES, in build_stage_panel_bf16.cu, for
// the same reason.  They load each datum through data_load.cuh into the
// float32 staging the float32 entries stage into, so from there they
// compute exactly what those compute; their shared memory and limits are
// float32's.
//
// Bounds at rank 256 (covtype width: d 54, 11 levels, 2,048 leaves of 256;
// chip_smoke.py's gram_cost and cross_cost): B1's 2,047 Sigma tiles read
// 113 MB of landmarks and write the Gram and the factor (1.07 GB), ~0.35
// ms, against m^3 / 3 flops a tile for the factor (~0.17 ms at the f32
// CUDA-core rate); B2's U and 10 W levels (2,047 nodes of 512 rows) read
// ~0.9 GB and write 1.07 GB, ~0.58 ms, against three TF32 passes of the
// two triangular products (~0.83 ms at 495 TFLOP/s: its bound) and the
// direct sum of the distances (~0.87 ms of issue slots at two
// instructions a feature and pair).
#define REPRO_PANEL_ENTRIES
#include "build_stage.cu"

#include "chol_panel.cuh"
#include "cross_panel.cuh"

namespace {

// ---------------------------------------------------------------------------
// B1: gram_chol_levels_panel
// ---------------------------------------------------------------------------

namespace gram {

// One block per node of every group: its Gram (points ptr[0], of type S)
// into ptr[1] and its lower Cholesky factor into ptr[2].  The super-tile
// loop is gram_points_kernel's (kept apart from it, see above), finish()
// writing the lower triangle straight into L; then L's upper triangle is
// zeroed and L factored in panels.  Shared memory: the panel factor's, then the
// staging of the points.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
gram_points_panel_kernel(const __grid_constant__ Table<T> tab, int d,
                         int kind, T sigma, double jitter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m;
  const size_t off = static_cast<size_t>(node) * m * m;
  const S* P = reinterpret_cast<const S*>(tab.g[gi].ptr[0]) +
               static_cast<size_t>(node) * m * d;
  T* G = tab.g[gi].ptr[1] + off;
  T* L = tab.g[gi].ptr[2] + off;
  T* pan = reinterpret_cast<T*>(smem_raw);                  // (m, LDP)
  T* rdiag = pan + m * chol_panel::LDP;
  T* col = reinterpret_cast<T*>(
      smem_raw + chol_blocked::col_offset(m, chol_panel::LDP, sizeof(T)));
  T* buf = reinterpret_cast<T*>(
      smem_raw + chol_panel::smem_bytes(m, sizeof(T)));     // 2 x (DC, LDP)
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
    if (c == nch - 1) finish(acc, I, J, m, kind, sigma, diag_add, G, L, m);
    __syncthreads();                             // chunk s is consumed
  }
  for (size_t e = threadIdx.x; e < static_cast<size_t>(m) * m; e += kThreads)
    if (static_cast<int>(e % m) > static_cast<int>(e / m)) L[e] = T(0);
  __syncthreads();                               // L's lower triangle is in
  chol_panel::factor(L, m, pan, rdiag, col);
}

template <typename T, typename S>
int launch_panel(const void* table, int groups, int d, int kind,
                 double sigma, double jitter, void* stream) {
  Table<T> tab;
  long long nodes;
  int mmax;
  int err = levels::read_table(table, groups, 3, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (d <= 0 || mmax > chol_panel::kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  for (int i = 0; i < groups; ++i)               // every group's factor
    if (tab.g[i].ptr[2] == nullptr) return cudaErrorInvalidValue;
  const auto kernel = gram_points_panel_kernel<T, S>;
  const size_t smem = chol_panel::smem_bytes(mmax, sizeof(T)) +
                      stage_bytes<T>();
  err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<static_cast<unsigned>(nodes), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(tab, d, kind,
                                                static_cast<T>(sigma), jitter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gram

// ---------------------------------------------------------------------------
// B2: cross_solve_levels_panel
// ---------------------------------------------------------------------------

namespace cross {

// One block per node of every group (points ptr[0] and landmarks ptr[1] of
// type S, Linv ptr[2], U ptr[3]); per row tile of 64, the distances to
// each half of the landmarks over double-buffered feature chunks (staged
// in the slab ring's space), K into the K / Y tile (zero past m and r),
// then the products.
static_assert(BM == cross_panel::BM, "the K tile's rows");

template <int NT1, typename S>
__global__ void __launch_bounds__(cross_panel::kThreads, 2)
cross_points_panel_kernel(const __grid_constant__ Table<float> tab, int r,
                          int d, int kind, float sigma) {
  extern __shared__ __align__(16) float smem[];
  float* ky = smem;                                   // (BM, LDK)
  float* ring = ky + cross_panel::KY_FLOATS;          // 2 x (DC, LDS) first
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m;
  const S* P = reinterpret_cast<const S*>(tab.g[gi].ptr[0]) +
               static_cast<size_t>(node) * m * d;
  const S* Z = reinterpret_cast<const S*>(tab.g[gi].ptr[1]) +
               static_cast<size_t>(node) * r * d;
  const float* L = tab.g[gi].ptr[2] + static_cast<size_t>(node) * r * r;
  float* U = tab.g[gi].ptr[3] + static_cast<size_t>(node) * m * r;
  const bool l1 = kind_is_l1(kind);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nch = (d + DC - 1) / DC;
  constexpr int LDK = cross_panel::LDK;

  for (int row0 = 0; row0 < m; row0 += BM) {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {                // landmarks 128 h ..
      const S* zh = Z + static_cast<size_t>(BN) * h * d;
      const int rh = min(BN, r - BN * h);
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      stage(ring, P, zh, m, rh, d, row0, 0, min(DC, d));
      acopy::commit();
      for (int c = 0; c < nch; ++c) {
        if (c + 1 < nch) {
          stage(ring + ((c + 1) & 1) * DC * LDS, P, zh, m, rh, d, row0,
                (c + 1) * DC, min(DC, d - (c + 1) * DC));
          acopy::commit();
          acopy::wait<1>();
        } else {
          acopy::wait<0>();
        }
        __syncthreads();                         // chunk c is staged
        const float* cur = ring + (c & 1) * DC * LDS;
        if (l1)
          accumulate<true>(acc, cur, min(DC, d - c * DC));
        else
          accumulate<false>(acc, cur, min(DC, d - c * DC));
        __syncthreads();                         // chunk c is consumed
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = 4 * ty + i + 32 * hh;
          const bool live = row0 + row < m;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int c0 = BN * h + 4 * tx + 64 * q;
            const float* a = acc[4 * hh + i] + 4 * q;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = live && c0 + j < r
                         ? kernel_epilogue<float>(kind, a[j], sigma)
                         : 0.f;
            *reinterpret_cast<float4*>(ky + row * LDK + c0) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
    }
    __syncthreads();                             // K is in shared memory
    cross_panel::products<NT1>(ky, ring, L, r,
                               U + static_cast<size_t>(row0) * r,
                               min(BM, m - row0));
  }
}

template <int NT1, typename S>
int launch_panel(const Table<float>& tab, long long nodes, int r, int d,
                 int kind, double sigma, cudaStream_t stream) {
  const auto kernel = cross_points_panel_kernel<NT1, S>;
  const size_t smem = cross_panel::smem_bytes();
  const int err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<static_cast<unsigned>(nodes), cross_panel::kThreads, smem,
           stream>>>(tab, r, d, kind, static_cast<float>(sigma));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cross

namespace cross64_panel {

using cross_panel::f64::LDK;
using cross_panel::f64::TX;
using cross_panel::f64::TY;
constexpr int BM = cross_panel::f64::BM;
constexpr int DF = 8;            // features of a staged chunk
constexpr int LDF = DF + 1;

// B2 in float64: one block per node; per row tile of 32, the distances to
// each half of the landmarks over feature chunks staged by the threads
// (in the slab ring's space), K into the K / Y tile, then the products.
__global__ void __launch_bounds__(cross_panel::f64::kThreads)
cross_points_panel_kernel(const __grid_constant__ Table<double> tab, int r,
                          int d, int kind, double sigma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ky = reinterpret_cast<double*>(smem_raw);   // (BM, LDK)
  double* ring = ky + cross_panel::f64::KY_DOUBLES;
  double* xs = ring;                                  // (BM, LDF)
  double* zs = ring + BM * LDF;                       // (128, LDF)
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m;
  const double* P = tab.g[gi].ptr[0] + static_cast<size_t>(node) * m * d;
  const double* Z = tab.g[gi].ptr[1] + static_cast<size_t>(node) * r * d;
  const double* L = tab.g[gi].ptr[2] + static_cast<size_t>(node) * r * r;
  double* U = tab.g[gi].ptr[3] + static_cast<size_t>(node) * m * r;
  const bool l1 = kind_is_l1(kind);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  constexpr int NL = cross_panel::kPanel;             // landmarks a half

  for (int row0 = 0; row0 < m; row0 += BM) {
    const int rows = min(BM, m - row0);
    for (int h = 0; h < 2; ++h) {
      double acc[2][8];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.0;
      for (int f0 = 0; f0 < d; f0 += DF) {
        const int dc = min(DF, d - f0);
        __syncthreads();                         // the last chunk is read
        for (int e = threadIdx.x; e < BM * dc; e += blockDim.x) {
          const int i = e / dc, f = e - i * dc;
          xs[i * LDF + f] =
              i < rows ? P[static_cast<size_t>(row0 + i) * d + f0 + f] : 0.0;
        }
        for (int e = threadIdx.x; e < NL * dc; e += blockDim.x) {
          const int l = e / dc, f = e - l * dc, z = NL * h + l;
          zs[l * LDF + f] = z < r ? Z[static_cast<size_t>(z) * d + f0 + f]
                                  : 0.0;
        }
        __syncthreads();
        for (int f = 0; f < dc; ++f) {
          const double x0 = xs[ty * LDF + f], x1 = xs[(ty + TY) * LDF + f];
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const double z = zs[(tx + TX * b) * LDF + f];
            acc[0][b] = l1 ? dist_step<true>(acc[0][b], x0, z)
                           : dist_step<false>(acc[0][b], x0, z);
            acc[1][b] = l1 ? dist_step<true>(acc[1][b], x1, z)
                           : dist_step<false>(acc[1][b], x1, z);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int i = ty + TY * a, c = NL * h + tx + TX * b;
          ky[i * LDK + c] = i < rows && c < r
                                ? kernel_epilogue<double>(kind, acc[a][b],
                                                          sigma)
                                : 0.0;
        }
    }
    __syncthreads();                             // K is in shared memory
    cross_panel::f64::products(ky, ring, L, r,
                               U + static_cast<size_t>(row0) * r, rows);
  }
}

}  // namespace cross64_panel

// The panel launches of B2: ranks 128 < r <= 256 (``table`` as
// cross_solve_levels', 4 pointers a row; S the data's type).
template <typename T, typename S>
int cross_levels_panel(const void* table, int groups, int r, int d, int kind,
                       double sigma, void* stream) {
  if (r <= 0) return 0;
  if (r <= cross_panel::kPanel || r > cross_panel::kMaxRank || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Table<T> tab;
  long long nodes;
  int mmax;
  const int err = levels::read_table(table, groups, 4, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 8) {
    const size_t smem = cross_panel::f64::smem_bytes();
    const int e = launch_with_smem(cross64_panel::cross_points_panel_kernel, smem);
    if (e) return e;
    cross64_panel::cross_points_panel_kernel<<<static_cast<unsigned>(nodes),
                                         cross_panel::f64::kThreads, smem,
                                         st>>>(tab, r, d, kind, sigma);
    return static_cast<int>(cudaGetLastError());
  } else {
    switch (cross_panel::tiles2(r)) {
      case 4:
        return cross::launch_panel<4, S>(tab, nodes, r, d, kind, sigma,
                                         st);
      case 8:
        return cross::launch_panel<8, S>(tab, nodes, r, d, kind, sigma,
                                         st);
      case 12:
        return cross::launch_panel<12, S>(tab, nodes, r, d, kind, sigma,
                                          st);
      default:
        return cross::launch_panel<16, S>(tab, nodes, r, d, kind, sigma,
                                          st);
    }
  }
}

}  // namespace

// Grouped launches of the panel forms, ``table`` as the resident entries'
// (points, gram, chol, nodes, m for gram_chol_levels_panel, every group
// with a factor; points, landmarks, linv, out, nodes, m for
// cross_solve_levels_panel).  The _bf16 entries take bfloat16 points and
// landmarks, float32 Linv and outputs.

#if defined(REPRO_PANEL_BF16_ENTRIES)

extern "C" int gram_chol_levels_panel_bf16(const void* table, int groups,
                                           int d, int kind, double sigma,
                                           double jitter, void* stream) {
  return gram::launch_panel<float, __nv_bfloat16>(table, groups, d, kind,
                                                  sigma, jitter, stream);
}

extern "C" int cross_solve_levels_panel_bf16(const void* table, int groups,
                                             int r, int d, int kind,
                                             double sigma, void* stream) {
  return cross_levels_panel<float, __nv_bfloat16>(table, groups, r, d, kind,
                                                  sigma, stream);
}

#else

extern "C" int gram_chol_levels_panel_f32(const void* table, int groups,
                                          int d, int kind, double sigma,
                                          double jitter, void* stream) {
  return gram::launch_panel<float, float>(table, groups, d, kind, sigma,
                                          jitter, stream);
}

extern "C" int gram_chol_levels_panel_f64(const void* table, int groups,
                                          int d, int kind, double sigma,
                                          double jitter, void* stream) {
  return gram::launch_panel<double, double>(table, groups, d, kind, sigma,
                                            jitter, stream);
}

extern "C" int cross_solve_levels_panel_f32(const void* table, int groups,
                                            int r, int d, int kind,
                                            double sigma, void* stream) {
  return cross_levels_panel<float, float>(table, groups, r, d, kind, sigma,
                                          stream);
}

extern "C" int cross_solve_levels_panel_f64(const void* table, int groups,
                                            int r, int d, int kind,
                                            double sigma, void* stream) {
  return cross_levels_panel<double, double>(table, groups, r, d, kind, sigma,
                                            stream);
}

#endif  // REPRO_PANEL_BF16_ENTRIES

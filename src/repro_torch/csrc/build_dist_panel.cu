// The panel forms of the sweep engine's grouped stages (build_dist.cu), for
// the tiles the resident kernels cannot hold in shared memory:
//
//   gram_chol_dist_levels_panel    B8 for m past the resident kernel's (240
//                                  in float32, 169 in float64) up to 512:
//                                  each cached distance tile's Gram into G
//                                  and its lower triangle into L (zeros
//                                  above it), then L factored in panels in
//                                  device memory (chol_panel.cuh);
//   cross_solve_dist_levels_panel  B9 for ranks 128 < r <= 256: each row
//                                  tile of K from the cached distances into
//                                  shared memory (zero past m and r), then
//                                  cross_panel.cuh's products (split TF32
//                                  on mma.sync in float32, CUDA cores in
//                                  float64).
//
// kernels/build_stage/ops.py chooses each level's form before the launch
// (gram_route, cross_route).  A library of its own: build_dist.cu compiled
// with REPRO_PANEL_ENTRIES (which leaves out its own entries), so that the
// resident kernels compile as they do alone.  Its bfloat16-data entries
// (gram_chol_dist_levels_panel_bf16, cross_solve_dist_levels_panel_bf16: a
// mixed-precision policy's bfloat16 distance tiles, float32 Linv and
// outputs) are this file compiled again with REPRO_PANEL_BF16_ENTRIES, in
// build_dist_panel_bf16.cu.  They convert each distance to float32 as it
// is loaded (data_load.cuh; B9's tile by the threads, 2-byte values being
// below cp.async's 4), so from there they compute exactly what the float32
// entries compute; shared memory and limits are float32's.
//
// Bounds at rank 256 (one sweep sigma at covtype width: 11 levels, 2,048
// leaves of 256; chip_smoke.py's gram_dist_cost and cross_dist_cost): B8's
// 2,047 Sigma tiles read 537 MB and write 1.07 GB, ~0.48 ms, against m^3 /
// 3 flops a tile (~0.17 ms at the f32 CUDA-core rate); B9's 2,047 nodes of
// 512 rows read 1.61 GB and write 1.07 GB, ~0.80 ms, against three TF32
// passes of the two triangular products, ~0.83 ms at 495 TFLOP/s.
#define REPRO_PANEL_ENTRIES
#include "build_dist.cu"

#include "chol_panel.cuh"
#include "cross_panel.cuh"

namespace {

// B8's panel form: one block of 128 threads per Sigma tile of every group
// (distances ptr[0] of type S, Gram ptr[1], factor ptr[2]): the epilogue
// and jitter * m on the diagonal applied as the tile is read, the Gram
// written whole and the factor's lower triangle (zeros above it), then L
// factored in panels.
template <typename T, typename S>
__global__ void __launch_bounds__(chol_blocked::kThreads)
gram_chol_levels_panel_kernel(const __grid_constant__ Table<T> tab, int kind,
                              T sigma, double jitter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m;
  const T diag_add = static_cast<T>(jitter * m);
  const size_t mm = static_cast<size_t>(m) * m;
  const size_t off = static_cast<size_t>(node) * mm;
  const S* D = reinterpret_cast<const S*>(tab.g[gi].ptr[0]) + off;
  T* G = tab.g[gi].ptr[1] + off;
  T* L = tab.g[gi].ptr[2] + off;
  T* pan = reinterpret_cast<T*>(smem_raw);            // (m, LDP)
  T* rdiag = pan + m * chol_panel::LDP;
  T* col = reinterpret_cast<T*>(
      smem_raw + chol_blocked::col_offset(m, chol_panel::LDP, sizeof(T)));
  // four neighbouring values a thread a step, their loads issued together
  for (size_t e0 = 4 * threadIdx.x; e0 < mm; e0 += 4 * chol_blocked::kThreads) {
    T dv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dv[q] = e0 + q < mm ? dload::load<T>(D + e0 + q) : T(0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t e = e0 + q;
      if (e >= mm) break;
      const int r = static_cast<int>(e / m), c = static_cast<int>(e % m);
      T v = kernel_epilogue<T>(kind, dv[q], sigma);
      if (r == c) v += diag_add;
      G[e] = v;
      L[e] = c <= r ? v : T(0);
    }
  }
  __syncthreads();
  chol_panel::factor(L, m, pan, rdiag, col);
}

template <typename T, typename S>
int launch_gram_levels_panel(const void* table, int groups, int kind,
                             double sigma, double jitter, void* stream) {
  Table<T> tab;
  long long nodes;
  int mmax;
  int err = levels::read_table(table, groups, 3, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (mmax > chol_panel::kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  const auto kernel = gram_chol_levels_panel_kernel<T, S>;
  const size_t smem = chol_panel::smem_bytes(mmax, sizeof(T));
  err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<static_cast<unsigned>(nodes), chol_blocked::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(tab, kind,
                                                static_cast<T>(sigma), jitter);
  return static_cast<int>(cudaGetLastError());
}

// B9's panel form in float32: one block of 128 threads per node of every
// group (distances ptr[0] of type S, Linv ptr[1], U ptr[2]); per row tile
// of 64, the cached distances copied into the K / Y tile with cp.async
// (all of a thread's copies in flight at once; zero past m and up to 256
// columns), the epilogue applied there by the thread that copied each
// value, then the products.  (Read by the threads, 16 loads in flight a
// thread, the tile took 1.78 of the 4.03 ms of U's level at rank 256.)
// bfloat16 distances go the same way where D's rows allow 16-byte copies
// (r a multiple of 8): 8 values a copy into the slab ring's space (free
// until the products), then converted, the epilogue applied and stored
// into the K / Y tile by the thread that copied them; else the threads
// read them one at a time.
template <int NT1, typename S>
__global__ void __launch_bounds__(cross_panel::kThreads, 2)
cross_levels_panel_kernel(const __grid_constant__ Table<float> tab, int r,
                          int kind, float sigma) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = cross_panel::BM, LDK = cross_panel::LDK;
  constexpr int W = 2 * cross_panel::kPanel;          // K's staged columns
  float* ky = smem;                                   // (BM, LDK)
  float* ring = ky + cross_panel::KY_FLOATS;
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m;
  const S* D = reinterpret_cast<const S*>(tab.g[gi].ptr[0]) +
               static_cast<size_t>(node) * m * r;
  const float* L = tab.g[gi].ptr[1] + static_cast<size_t>(node) * r * r;
  float* U = tab.g[gi].ptr[2] + static_cast<size_t>(node) * m * r;
  // 16-byte copies where D's rows allow them, else one value a copy
  [[maybe_unused]] const int vw =
      (r % 4 == 0 && reinterpret_cast<size_t>(D) % 16 == 0) ? 4 : 1;
  for (int row0 = 0; row0 < m; row0 += BM) {
    const int rows = min(BM, m - row0);
    const S* Dt = D + static_cast<size_t>(row0) * r;
    if constexpr (std::is_same_v<S, float>) {
      for (int e = threadIdx.x; e < BM * W / vw; e += cross_panel::kThreads) {
        const int i = e / (W / vw), c = vw * (e % (W / vw));
        const bool ok = i < rows && c < r;
        const float* src = ok ? Dt + static_cast<size_t>(i) * r + c : Dt;
        if (vw == 4)
          acopy::bytes16(ky + i * LDK + c, src, ok);
        else
          acopy::element(ky + i * LDK + c, src, ok);
      }
      acopy::commit();
      acopy::wait<0>();                            // this thread's copies
      for (int e = threadIdx.x; e < BM * W / vw; e += cross_panel::kThreads) {
        const int i = e / (W / vw), c = vw * (e % (W / vw));
        if (i >= rows || c >= r) continue;         // zero-filled
        for (int q = 0; q < vw; ++q)
          ky[i * LDK + c + q] =
              kernel_epilogue<float>(kind, ky[i * LDK + c + q], sigma);
      }
    } else if (vw == 4 && r % 8 == 0) {
      S* raw = reinterpret_cast<S*>(ring);            // (BM, W) values
      constexpr int V = 8;                            // values a copy
      static_assert(BM * W * sizeof(S) <=
                        cross_panel::RING_FLOATS * sizeof(float),
                    "a row tile of bf16 distances fits the ring");
      for (int e = threadIdx.x; e < BM * W / V; e += cross_panel::kThreads) {
        const int i = e / (W / V), c = V * (e % (W / V));
        const bool ok = i < rows && c < r;
        acopy::bytes16(raw + i * W + c,
                       ok ? Dt + static_cast<size_t>(i) * r + c : Dt, ok);
      }
      acopy::commit();
      acopy::wait<0>();                            // this thread's copies
      for (int e = threadIdx.x; e < BM * W / V; e += cross_panel::kThreads) {
        const int i = e / (W / V), c = V * (e % (W / V));
        const bool ok = i < rows && c < r;
#pragma unroll
        for (int q = 0; q < V; ++q)
          ky[i * LDK + c + q] =
              ok ? kernel_epilogue<float>(
                       kind, dload::load<float>(raw + i * W + c + q), sigma)
                 : 0.f;
      }
    } else {
      for (int e = threadIdx.x; e < BM * W; e += cross_panel::kThreads) {
        const int i = e / W, c = e % W;
        ky[i * LDK + c] =
            i < rows && c < r
                ? kernel_epilogue<float>(
                      kind,
                      dload::load<float>(Dt + static_cast<size_t>(i) * r + c),
                      sigma)
                : 0.f;
      }
    }
    __syncthreads();                             // K is in shared memory
    cross_panel::products<NT1>(ky, ring, L, r,
                               U + static_cast<size_t>(row0) * r, rows);
  }
}

// B9's panel form in float64 (CUDA cores): as above, a row tile of 32.
__global__ void __launch_bounds__(cross_panel::f64::kThreads)
cross_levels_panel64_kernel(const __grid_constant__ Table<double> tab, int r,
                            int kind, double sigma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int BM = cross_panel::f64::BM, LDK = cross_panel::f64::LDK;
  constexpr int W = 2 * cross_panel::kPanel;
  double* ky = reinterpret_cast<double*>(smem_raw);   // (BM, LDK)
  double* ring = ky + cross_panel::f64::KY_DOUBLES;
  int node = blockIdx.x;
  const int gi = find_group(tab, node);
  const int m = tab.g[gi].m;
  const double* D = tab.g[gi].ptr[0] + static_cast<size_t>(node) * m * r;
  const double* L = tab.g[gi].ptr[1] + static_cast<size_t>(node) * r * r;
  double* U = tab.g[gi].ptr[2] + static_cast<size_t>(node) * m * r;
  for (int row0 = 0; row0 < m; row0 += BM) {
    const int rows = min(BM, m - row0);
    const double* Dt = D + static_cast<size_t>(row0) * r;
#pragma unroll 8
    for (int k = 0; k < BM * W / cross_panel::f64::kThreads; ++k) {
      const int e = threadIdx.x + k * cross_panel::f64::kThreads;
      const int i = e / W, c = e % W;
      ky[i * LDK + c] = i < rows && c < r
                            ? kernel_epilogue<double>(
                                  kind, Dt[static_cast<size_t>(i) * r + c],
                                  sigma)
                            : 0.0;
    }
    __syncthreads();
    cross_panel::f64::products(ky, ring, L, r,
                               U + static_cast<size_t>(row0) * r, rows);
  }
}

template <int NT1, typename S>
int launch_cross_panel(const Table<float>& tab, long long nodes, int r,
                       int kind, double sigma, cudaStream_t stream) {
  const auto kernel = cross_levels_panel_kernel<NT1, S>;
  const size_t smem = cross_panel::smem_bytes();
  const int err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<static_cast<unsigned>(nodes), cross_panel::kThreads, smem,
           stream>>>(tab, r, kind, static_cast<float>(sigma));
  return static_cast<int>(cudaGetLastError());
}

// The panel launches of B9: ranks 128 < r <= 256 (``table`` as
// cross_solve_dist_levels', 3 pointers a row; S the distances' type).
template <typename T, typename S>
int cross_dist_levels_panel(const void* table, int groups, int r, int kind,
                            double sigma, void* stream) {
  if (r <= 0) return 0;
  if (r <= cross_panel::kPanel || r > cross_panel::kMaxRank)
    return static_cast<int>(cudaErrorInvalidValue);
  Table<T> tab;
  long long nodes;
  int mmax;
  const int err = levels::read_table(table, groups, 3, tab, nodes, mmax);
  if (err || nodes == 0) return err;
  if (nodes > 2147483647LL) return cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 8) {
    const size_t smem = cross_panel::f64::smem_bytes();
    const int e = launch_with_smem(cross_levels_panel64_kernel, smem);
    if (e) return e;
    cross_levels_panel64_kernel<<<static_cast<unsigned>(nodes),
                                  cross_panel::f64::kThreads, smem, st>>>(
        tab, r, kind, sigma);
    return static_cast<int>(cudaGetLastError());
  } else {
    switch (cross_panel::tiles2(r)) {
      case 4:
        return launch_cross_panel<4, S>(tab, nodes, r, kind, sigma, st);
      case 8:
        return launch_cross_panel<8, S>(tab, nodes, r, kind, sigma, st);
      case 12:
        return launch_cross_panel<12, S>(tab, nodes, r, kind, sigma, st);
      default:
        return launch_cross_panel<16, S>(tab, nodes, r, kind, sigma, st);
    }
  }
}

}  // namespace

// Grouped launches of the panel forms, ``table`` as the resident entries'
// (dist, gram, chol, nodes, m; dist, linv, out, nodes, m).  The _bf16
// entries take bfloat16 distance tiles, float32 Linv and outputs.

#if defined(REPRO_PANEL_BF16_ENTRIES)

extern "C" int gram_chol_dist_levels_panel_bf16(const void* table,
                                                int groups, int kind,
                                                double sigma, double jitter,
                                                void* stream) {
  return launch_gram_levels_panel<float, __nv_bfloat16>(
      table, groups, kind, sigma, jitter, stream);
}

extern "C" int cross_solve_dist_levels_panel_bf16(const void* table,
                                                  int groups, int r, int kind,
                                                  double sigma,
                                                  void* stream) {
  return cross_dist_levels_panel<float, __nv_bfloat16>(table, groups, r,
                                                       kind, sigma, stream);
}

#else

extern "C" int gram_chol_dist_levels_panel_f32(const void* table, int groups,
                                               int kind, double sigma,
                                               double jitter, void* stream) {
  return launch_gram_levels_panel<float, float>(table, groups, kind, sigma,
                                                jitter, stream);
}

extern "C" int gram_chol_dist_levels_panel_f64(const void* table, int groups,
                                               int kind, double sigma,
                                               double jitter, void* stream) {
  return launch_gram_levels_panel<double, double>(table, groups, kind,
                                                  sigma, jitter, stream);
}

extern "C" int cross_solve_dist_levels_panel_f32(const void* table,
                                                 int groups, int r, int kind,
                                                 double sigma, void* stream) {
  return cross_dist_levels_panel<float, float>(table, groups, r, kind,
                                               sigma, stream);
}

extern "C" int cross_solve_dist_levels_panel_f64(const void* table,
                                                 int groups, int r, int kind,
                                                 double sigma, void* stream) {
  return cross_dist_levels_panel<double, double>(table, groups, r, kind,
                                                 sigma, stream);
}

#endif  // REPRO_PANEL_BF16_ENTRIES

// The panel form of B3 leaf_factor: leaf_factor_panel_f32 and _f64,
// leaves of n0 up to 512 factored and inverted in device memory
// (chol_panel.cuh), for the shapes whose tile the resident kernel
// (leaf_factor.cu) cannot hold in shared memory (n0 > 240 in float32, >
// 169 in float64; kernels/hck_leaf/ops.py::factor_route chooses).  A
// library of its own: leaf_factor.cu compiled with REPRO_PANEL_ENTRIES
// (which leaves out the resident entries), so that the resident kernel
// compiles as it does alone.
//
// Bound at rank 256 (2,048 leaves of 256, float32; chip_smoke.py's
// factor_cost): D's lower triangle read and L and L^-1 written whole
// (1.34 GB, ~0.40 ms at 3.35 TB/s) against 2 n0^3 / 3 flops a leaf (22.9
// GFLOP, ~0.34 ms at the f32 CUDA-core rate), so bytes by a little; each
// leaf is a chain of dependent panel steps, so the launch is bound by that
// chain's latency unless many leaves run side by side.  The trailing
// updates re-read each tile from L2 (and from device memory where the
// tiles in flight outgrow the 50 MB L2).
#define REPRO_PANEL_ENTRIES
#include "leaf_factor.cu"

#include "chol_panel.cuh"

namespace {

// One block per leaf, n0 up to chol_panel::kMaxM: D's lower triangle is
// copied into L (zeros above it, and above X's diagonal), then L is
// factored and X = L^-1 formed in panels of 32 columns in device memory
// (chol_panel.cuh), only the current panel and the pivots in shared
// memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
leaf_factor_panel_kernel(const T* __restrict__ dleaf, T* lo, T* linv,
                         int n0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pan = reinterpret_cast<T*>(smem_raw);            // (n0, LDP)
  T* rdiag = pan + n0 * chol_panel::LDP;              // (n0,)
  T* col = reinterpret_cast<T*>(
      smem_raw + col_offset(n0, chol_panel::LDP, sizeof(T)));
  const size_t nn = static_cast<size_t>(n0) * n0;
  const size_t off = static_cast<size_t>(blockIdx.x) * nn;
  const T* src = dleaf + off;
  T* L = lo + off;
  T* X = linv + off;
#pragma unroll 8                      // many loads of the leaf in flight
  for (size_t e = threadIdx.x; e < nn; e += kThreads) {
    const int r = static_cast<int>(e / n0), c = static_cast<int>(e % n0);
    L[e] = c <= r ? src[e] : T(0);
    if (c > r) X[e] = T(0);
  }
  __syncthreads();
  chol_panel::factor(L, n0, pan, rdiag, col);
  chol_panel::inverse(L, X, n0, pan, rdiag);
}

template <typename T>
int launch_panel(const void* dleaf, void* lo, void* linv, int p, int n0,
                 void* stream) {
  if (p == 0 || n0 == 0) return 0;
  if (n0 > chol_panel::kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = leaf_factor_panel_kernel<T>;
  const size_t smem = chol_panel::smem_bytes(n0, sizeof(T));
  const int err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dleaf), static_cast<T*>(lo),
      static_cast<T*>(linv), n0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int leaf_factor_panel_f32(const void* dleaf, void* lo, void* linv,
                                     int p, int n0, void* stream) {
  return launch_panel<float>(dleaf, lo, linv, p, n0, stream);
}

extern "C" int leaf_factor_panel_f64(const void* dleaf, void* lo, void* linv,
                                     int p, int n0, void* stream) {
  return launch_panel<double>(dleaf, lo, linv, p, n0, stream);
}


// Batched metric distances of the landmark policies (repro.landmarks.
// policy: k-means assignments and medoid snaps, the leverage pilot):
//
//   dist[b][i][j] = sum_t (x[b][i][t] - y[b][j][t])^2   ("l2", squared)
//                 = sum_t |x[b][i][t] - y[b][j][t]|      ("l1")
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/policy_stage/policy_stage.py::policy_dist_kernel
//   (_policy_dist_body).
//
// Shapes: x (B, m, d), y (B, r, d) -> dist (B, m, r), all row-major and
// contiguous, f32 or f64, and every sum is taken in that type.  The
// distance is the raw sum: no kernel epilogue, no bandwidth, so a policy's
// selection does not depend on sigma.  The sum is direct, one fused
// multiply-add (or one add of |x - y|) per feature in feature order, not
// through the ||x||^2 + ||y||^2 - 2 x.y identity of the reference's plain
// version, which cancels for points far from the origin (the port's
// convention for every distance it computes on the card).  Both kernels
// below take that chain, so their outputs are equal bit for bit.
//
// Bound on the H100: bytes.  A k-means level at covtype width (m =
// 524,288 / 2^l rows per node, r = 128, d = 54, f32) writes 268 MB of
// distances and reads 113 MB of points, ~0.114 ms at 3.35 TB/s.  The
// direct sum issues two instructions a feature and pair (FSUB, FFMA):
// 7.25 G a level, ~0.217 ms at 132 SMs x 128 lanes x 1.98 GHz.
//
// Two kernels, chosen by the wrapper (kernels/policy_stage/ops.py::
// route):
//
// "tiled" (policy_dist_tiled_f32, f32 with d <= 64, the path; in f64
// its 8 x 8 tile of doubles would not fit in 255 registers): dist_tiled.cuh
// with no epilogue (persistent blocks of 256 threads, two an SM, 128-row
// tiles of x in a two-buffer cp.async ring against 128 resident centers,
// an 8 x 8 register tile a thread, 16-byte evict-first stores; the
// distances are 2.4x the 50 MB L2 at level 0).
//
// "pair_tile" (policy_dist_*, the design "tiled" replaced; f64 and any
// d): B11's distance tile (pair_tile.cuh: 64 x 64 tiles, features staged
// 32 at a time) without the epilogue, batched over nodes on the grid's z
// axis.
#include <cuda_runtime.h>

#include <algorithm>

#include "dist_tiled.cuh"
#include "kernel_epilogue.cuh"
#include "pair_tile.cuh"

namespace {

// B12's raw distances: no epilogue.
struct Identity {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

using pair_tile::BM;
using pair_tile::BN;
using pair_tile::kThreads;
using pair_tile::TM;
using pair_tile::TN;

template <typename T, bool L1>
__global__ void __launch_bounds__(kThreads)
policy_dist_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   T* __restrict__ out, int m, int r, int d) {
  __shared__ T staged[pair_tile::kStageElems];
  T* xs = staged;
  T* ys = staged + pair_tile::DC * pair_tile::LDX;
  const size_t node = blockIdx.z;
  const T* xb = x + node * m * d;
  const T* yb = y + node * r * d;
  T* ob = out + node * m * r;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  T dist[TM][TN];
  pair_tile::distances<T, L1>(xb, yb, m, r, d, r0, c0, xs, ys, dist);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < r) ob[static_cast<size_t>(row) * r + col] = dist[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int b, int m, int r,
           int d, int l1, void* stream) {
  if (b == 0 || m == 0 || r == 0) return 0;
  const dim3 grid((r + BN - 1) / BN, (m + BM - 1) / BM, b);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const T*>(x);
  const auto* yp = static_cast<const T*>(y);
  auto* op = static_cast<T*>(out);
  if (l1)
    policy_dist_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, yp, op, m, r,
                                                          d);
  else
    policy_dist_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, yp, op, m, r,
                                                           d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int policy_dist_tiled_f32(const void* x, const void* y, void* out,
                                     int b, int m, int r, int d, int l1,
                                     void* stream) {
  return l1 ? dist_tiled::launch<true>(x, y, out, b, m, r, d, Identity{},
                                       stream)
            : dist_tiled::launch<false>(x, y, out, b, m, r, d, Identity{},
                                        stream);
}

extern "C" int policy_dist_f32(const void* x, const void* y, void* out, int b,
                               int m, int r, int d, int l1, void* stream) {
  return launch<float>(x, y, out, b, m, r, d, l1, stream);
}

extern "C" int policy_dist_f64(const void* x, const void* y, void* out, int b,
                               int m, int r, int d, int l1, void* stream) {
  return launch<double>(x, y, out, b, m, r, d, l1, stream);
}

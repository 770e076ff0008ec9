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
// its 8 x 8 tile of doubles would not fit in 255 registers): persistent
// blocks of 256 threads, two an SM, each walking a contiguous range of
// tiles (node, chunk of 128 centers, 128 rows), so consecutive tiles
// mostly share a node.
// The node's 128 centers are staged once per node and chunk, feature-
// major (row stride 132), with the whole d resident; each 128-row tile of
// x (contiguous in device memory) is staged feature-major by cp.async
// into one of two buffers while the block computes on the other.  A
// thread holds an 8 x 8 register tile (rows 4 ty + i + 64 h, columns
// 4 tx + j + 64 g) and reads x and y with 16-byte shared loads: 4 loads
// per 128 instructions of arithmetic a feature.  Rows and centers past m
// and r are staged as zeros and not stored; a row of the output tile is
// stored 16 bytes a thread (256 contiguous bytes a half-warp) where r is
// a multiple of 4, with evict-first stores (the distances are 2.4x the
// 50 MB L2 at level 0).  Offsets are 64-bit.
//
// "pair_tile" (policy_dist_*, the design "tiled" replaced; f64 and any
// d): B11's distance tile (pair_tile.cuh: 64 x 64 tiles, features staged
// 32 at a time) without the epilogue, batched over nodes on the grid's z
// axis.
#include <cuda_runtime.h>

#include <algorithm>

#include "async_copy.cuh"
#include "kernel_epilogue.cuh"
#include "pair_tile.cuh"

namespace {

namespace tiled {

constexpr int kThreads = 256;   // 16 x 16
constexpr int BM = 128;         // rows of x per tile
constexpr int BN = 128;         // centers per chunk
constexpr int LD = BM + 4;      // stride of a staged feature row (x and y)
constexpr int DMAX = 64;        // features held whole

__host__ __device__ constexpr size_t smem_bytes(int d) {
  return static_cast<size_t>(3) * d * LD * sizeof(float);  // 2 x tiles + y
}

// rows [r0, r0 + 128) of the (n, d) array a (feature-major into s, row
// stride LD); rows at or past n are zero-filled.  The rows are contiguous
// in memory, so element e of the tile is a[r0 * d + e].
__device__ __forceinline__ void stage(const float* __restrict__ a, int n,
                                      int d, int r0, float* s) {
  const int total = BM * d;
  const int step_row = kThreads / d, step_f = kThreads % d;
  int row = threadIdx.x / d, f = threadIdx.x % d;
  const float* base = a + static_cast<size_t>(r0) * d;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const bool valid = r0 + row < n;
    acopy::element(s + f * LD + row, valid ? base + e : a, valid);
    row += step_row;
    f += step_f;
    if (f >= d) {
      f -= d;
      ++row;
    }
  }
}

__device__ __forceinline__ void load4(float (&v)[8], int at, const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[at] = q.x;
  v[at + 1] = q.y;
  v[at + 2] = q.z;
  v[at + 3] = q.w;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

template <bool L1>
__global__ void __launch_bounds__(kThreads, 2)
policy_dist_tiled_kernel(const float* __restrict__ x,
                         const float* __restrict__ y, float* __restrict__ out,
                         int m, int r, int d, long long tiles_m,
                         long long tiles_r, long long ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ys = reinterpret_cast<float*>(smem_raw);
  float* xs0 = ys + d * LD;
  float* xs1 = xs0 + d * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long begin = ntiles * blockIdx.x / gridDim.x;
  const long long end = ntiles * (blockIdx.x + 1) / gridDim.x;
  const bool vec = (r & 3) == 0;
  // tile t: node t / (tiles_r tiles_m), center chunk, then row tile
  auto node_of = [&](long long t) { return t / (tiles_r * tiles_m); };
  auto chunk_of = [&](long long t) { return (t / tiles_m) % tiles_r; };
  auto rows_of = [&](long long t) { return static_cast<int>(t % tiles_m); };
  auto x_of = [&](long long t) {
    return x + static_cast<size_t>(node_of(t)) * m * d;
  };
  auto y_of = [&](long long t) {
    return y + (static_cast<size_t>(node_of(t)) * r +
                static_cast<size_t>(chunk_of(t)) * BN) * d;
  };
  auto r_left = [&](long long t) {
    return r - static_cast<int>(chunk_of(t)) * BN;
  };

  if (begin < end) {
    stage(y_of(begin), r_left(begin), d, 0, ys);
    stage(x_of(begin), m, d, rows_of(begin) * BM, xs0);
    acopy::commit();
  }
  int buf = 0;
  for (long long t = begin; t < end; ++t) {
    const bool more = t + 1 < end;
    const bool same = more && node_of(t + 1) == node_of(t) &&
                      chunk_of(t + 1) == chunk_of(t);
    float* xs = buf ? xs1 : xs0;
    float* xn = buf ? xs0 : xs1;
    if (same) {                       // next x tile behind this one's math
      stage(x_of(t + 1), m, d, rows_of(t + 1) * BM, xn);
      acopy::commit();
      acopy::wait<1>();
    } else {
      acopy::wait<0>();
    }
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    const float* xp = xs + 4 * ty;
    const float* yp = ys + 4 * tx;
#pragma unroll 2
    for (int f = 0; f < d; ++f) {
      float xv[8], yv[8];
      load4(xv, 0, xp + f * LD);
      load4(xv, 4, xp + f * LD + 64);
      load4(yv, 0, yp + f * LD);
      load4(yv, 4, yp + f * LD + 64);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float diff = xv[i] - yv[j];
          if (L1)
            acc[i][j] += fabsf(diff);
          else
            acc[i][j] = fmaf(diff, diff, acc[i][j]);
        }
    }
    __syncthreads();                  // xs and ys are free
    if (more && !same) {              // a new node or chunk: restage both
      stage(y_of(t + 1), r_left(t + 1), d, 0, ys);
      stage(x_of(t + 1), m, d, rows_of(t + 1) * BM, xn);
      acopy::commit();
    }

    const int r0 = rows_of(t) * BM;
    const int c0 = static_cast<int>(chunk_of(t)) * BN;
    float* ob = out + static_cast<size_t>(node_of(t)) * m * r;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 64 * h + 4 * ty + i;
        if (row >= m) continue;
        float* orow = ob + static_cast<size_t>(row) * r;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int col = c0 + 64 * g + 4 * tx;
          const int ai = 4 * h + i, aj = 4 * g;
          if (vec && col + 3 < r) {
            store4(orow + col, acc[ai][aj], acc[ai][aj + 1], acc[ai][aj + 2],
                   acc[ai][aj + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (col + j < r) orow[col + j] = acc[ai][aj + j];
          }
        }
      }
    buf ^= 1;
  }
}

int launch(const void* x, const void* y, void* out, int b, int m, int r,
           int d, int l1, void* stream) {
  if (b == 0 || m == 0 || r == 0) return 0;
  if (d < 1 || d > DMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d);
  const auto kernel = l1 ? policy_dist_tiled_kernel<true>
                         : policy_dist_tiled_kernel<false>;
  int err = launch_with_smem(kernel, smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)))
    return err;
  const long long tiles_m = (m + BM - 1) / BM, tiles_r = (r + BN - 1) / BN;
  const long long ntiles = static_cast<long long>(b) * tiles_m * tiles_r;
  const long long grid =
      std::min<long long>(ntiles, static_cast<long long>(sms) *
                                      (per_sm > 0 ? per_sm : 1));
  kernel<<<static_cast<unsigned>(grid), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), m, r, d, tiles_m, tiles_r, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tiled

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
  return tiled::launch(x, y, out, b, m, r, d, l1, stream);
}

extern "C" int policy_dist_f32(const void* x, const void* y, void* out, int b,
                               int m, int r, int d, int l1, void* stream) {
  return launch<float>(x, y, out, b, m, r, d, l1, stream);
}

extern "C" int policy_dist_f64(const void* x, const void* y, void* out, int b,
                               int m, int r, int d, int l1, void* stream) {
  return launch<double>(x, y, out, b, m, r, d, l1, stream);
}

// Register-tiled float32 distance tiles, summed directly over the
// features, with an epilogue applied to each distance as it is stored:
//
//   out[b][i][j] = epi(sum_t (x[b][i][t] - y[b][j][t])^2)   (L2, squared)
//                = epi(sum_t |x[b][i][t] - y[b][j][t]|)      (L1)
//
// Shared by policy_dist.cu (B12's "tiled" kernel: the identity, raw
// distances) and kernel_tile.cu (B11's CUDA-core kernel for d <= 64: the
// base-kernel epilogue of kernel_epilogue.cuh).  x (B, m, d), y (B, r, d),
// out (B, m, r), row-major and contiguous, d <= 64.
//
// Persistent blocks of 256 threads, two an SM, each walking a contiguous
// range of tiles (node, chunk of 128 centers, 128 rows), so consecutive
// tiles mostly share a node.  The node's 128 centers are staged once per
// node and chunk, feature-major (row stride 132), with the whole d
// resident; each 128-row tile of x (contiguous in device memory) is staged
// feature-major by cp.async into one of two buffers while the block
// computes on the other.  A thread holds an 8 x 8 register tile (rows 4 ty
// + i + 64 h, columns 4 tx + j + 64 g) and reads x and y with 16-byte
// shared loads: 4 loads per 128 instructions of arithmetic a feature.
// Rows and centers past m and r are staged as zeros and not stored; a row
// of the output tile is stored 16 bytes a thread (256 contiguous bytes a
// half-warp) where r is a multiple of 4, with evict-first stores (B12's
// distances are 2.4x the 50 MB L2 at level 0; B11's tiles 21x at
// 16,384^2).  Offsets are 64-bit.  The sum is one fused multiply-add (or
// one add of |x - y|) per feature in feature order, as pair_tile.cuh
// takes it, so the two forms give equal distances bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "async_copy.cuh"
#include "kernel_epilogue.cuh"

namespace dist_tiled {

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

template <bool L1, typename Epilogue>
__global__ void __launch_bounds__(kThreads, 2)
dist_tiled_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ out, int m, int r, int d,
                  long long tiles_m, long long tiles_r, long long ntiles,
                  Epilogue epi) {
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
            store4(orow + col, epi(acc[ai][aj]), epi(acc[ai][aj + 1]),
                   epi(acc[ai][aj + 2]), epi(acc[ai][aj + 3]));
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (col + j < r) orow[col + j] = epi(acc[ai][aj + j]);
          }
        }
      }
    buf ^= 1;
  }
}

template <bool L1, typename Epilogue>
int launch(const void* x, const void* y, void* out, int b, int m, int r,
           int d, Epilogue epi, void* stream) {
  if (b == 0 || m == 0 || r == 0) return 0;
  if (d < 1 || d > DMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d);
  const auto kernel = dist_tiled_kernel<L1, Epilogue>;
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
      static_cast<float*>(out), m, r, d, tiles_m, tiles_r, ntiles, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dist_tiled

// Fused per-query cross-kernel evaluation and weight contraction of HCK
// Algorithm 3, phase 2 (the oos_local and oos_walk stages):
//
//   z_i = W[widx_i]^T k(P[pidx_i], x_i)
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/oos_stage/oos_stage.py::oos_contract_kernel
//   (_contract_body).
//
// Shapes: points (Bp, m, d), weights (Bw, m, k), queries (q, d), pidx and
// widx (q,) int64 -> z (q, k).  All row-major and contiguous; T is float
// or double and every sum is taken in T.  The TPU kernel took per-query
// blocks gathered beforehand ((q, m, d) and (q, m, k) copies in device
// memory); this kernel reads each query's block in place through the
// block indices, so the gather never reaches device memory.  A query
// whose index lies outside [0, Bp) or [0, Bw) gets a NaN row instead of
// an out-of-bounds read.
//
// Bound on the H100: bytes.  Per query it does m * (3d + 2k) flops on
// m * (d + k) values it reads; the leaf blocks of a leaf-sorted batch are
// shared by neighbouring queries, so the least traffic is the distinct
// blocks the batch touches plus the queries and the output.
//
// Design: one block of 128 threads per query.  The query row is staged in
// shared memory, then the point block in chunks of `chunk` rows, copied
// with neighbouring threads on neighbouring addresses (coalesced) into
// rows padded to an odd stride, so that the thread-per-row distance loop
// reads distinct banks.  Distances are summed directly as (p - x)^2 or
// |p - x| (not through the ||p||^2 + ||x||^2 - 2 p.x identity of the
// reference, which cancels for points far from the origin), the epilogue
// turns them into kernel values kept in shared memory, and each warp
// reduces the length-m weighted sums of its output columns with shuffles.
#include <cuda_runtime.h>

#include <math_constants.h>

#include "kernel_epilogue.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() { return CUDART_NAN_F; }
template <>
__device__ __forceinline__ double quiet_nan<double>() { return CUDART_NAN; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
oos_contract_kernel(const T* __restrict__ points, const T* __restrict__ weights,
                    const T* __restrict__ queries,
                    const long long* __restrict__ pidx,
                    const long long* __restrict__ widx, T* __restrict__ out,
                    long long bp, long long bw, int m, int d, int k, int chunk,
                    int kind, T sigma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = d | 1;
  T* xs = reinterpret_cast<T*>(smem_raw);      // (d,)
  T* ps = xs + d;                              // (chunk, stride)
  T* kv = ps + static_cast<size_t>(chunk) * stride;   // (m,)

  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const long long pb = pidx[qi];
  const long long wb = widx[qi];
  T* o = out + static_cast<size_t>(qi) * k;
  if (pb < 0 || pb >= bp || wb < 0 || wb >= bw) {
    for (int c = tid; c < k; c += kThreads) o[c] = quiet_nan<T>();
    return;
  }
  const T* P = points + static_cast<size_t>(pb) * m * d;
  const T* W = weights + static_cast<size_t>(wb) * m * k;
  const T* x = queries + static_cast<size_t>(qi) * d;
  const bool l1 = kind_is_l1(kind);

  for (int t = tid; t < d; t += kThreads) xs[t] = x[t];
  for (int j0 = 0; j0 < m; j0 += chunk) {
    const int rows = min(chunk, m - j0);
    __syncthreads();                      // previous chunk fully consumed
    const T* src = P + static_cast<size_t>(j0) * d;
    for (int i = tid; i < rows * d; i += kThreads) {
      const int row = i / d;
      ps[row * stride + (i - row * d)] = src[i];
    }
    __syncthreads();
    for (int row = tid; row < rows; row += kThreads) {
      const T* pr = ps + row * stride;
      T acc = T(0);
      for (int t = 0; t < d; ++t) {
        const T diff = pr[t] - xs[t];
        acc += l1 ? (diff < T(0) ? -diff : diff) : diff * diff;
      }
      kv[j0 + row] = kernel_epilogue<T>(kind, acc, sigma);
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c = warp; c < k; c += kThreads / 32) {
    T s = T(0);
    for (int j = lane; j < m; j += 32)
      s += kv[j] * W[static_cast<size_t>(j) * k + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) o[c] = s;
  }
}

template <typename T>
int launch(const void* points, const void* weights, const void* queries,
           const void* pidx, const void* widx, void* out, long long bp,
           long long bw, int q, int m, int d, int k, int chunk, int kind,
           double sigma, void* stream) {
  if (q == 0 || k == 0) return 0;
  const size_t smem =
      (static_cast<size_t>(d) + static_cast<size_t>(chunk) * (d | 1) + m) *
      sizeof(T);
  oos_contract_kernel<T><<<q, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(points), static_cast<const T*>(weights),
      static_cast<const T*>(queries), static_cast<const long long*>(pidx),
      static_cast<const long long*>(widx), static_cast<T*>(out), bp, bw, m, d,
      k, chunk, kind, static_cast<T>(sigma));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int oos_contract_f32(const void* points, const void* weights,
                                const void* queries, const void* pidx,
                                const void* widx, void* out, long long bp,
                                long long bw, int q, int m, int d, int k,
                                int chunk, int kind, double sigma,
                                void* stream) {
  return launch<float>(points, weights, queries, pidx, widx, out, bp, bw, q,
                       m, d, k, chunk, kind, sigma, stream);
}

extern "C" int oos_contract_f64(const void* points, const void* weights,
                                const void* queries, const void* pidx,
                                const void* widx, void* out, long long bp,
                                long long bw, int q, int m, int d, int k,
                                int chunk, int kind, double sigma,
                                void* stream) {
  return launch<double>(points, weights, queries, pidx, widx, out, bp, bw, q,
                        m, d, k, chunk, kind, sigma, stream);
}

// Fused exact-kernel matvec: z = K(Xc, Y) V, without ever writing K
// (the operator of the matvec-free solvers, repro.solvers.operators.
// ExactKernelOp, and of exact-kernel prediction).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/matvec_stage/matvec_stage.py::kernel_matvec_kernel
//   (_matvec_body).
//
// Shapes: xc (b, d), y (m, d), v (m, ld), z (b, ld), row-major and
// contiguous; the launch covers columns [0, kc) of v and z (the wrapper
// offsets the pointers for wider right-hand sides).  T is float or double
// and every sum is taken in T.  No TF32, no tensor cores: the f32 gates
// need IEEE float32.
//
// Bound on the H100: operations.  Each of the b * m pairs costs its
// distance over d features and 2 k flops of contraction, and nothing of
// size b * m reaches device memory: at covtype width (b = m = 464,809,
// d = 54, k = 7, f32) 2.16e11 pairs, ~2.7e13 flops, ~0.41 s at 67 TFLOP/s,
// against ~0.2 GB of inputs.
//
// Design: one block owns BM = 64 rows of Xc and keeps their (64, k)
// accumulators in shared memory for the whole sweep over Y, so no state
// crosses blocks.  Per tile of BN = 64 rows of Y it forms the 64 x 64
// distance tile in registers (pair_tile.cuh), applies the epilogue and
// parks the kernel tile in shared memory; the tile is then contracted at
// once against the matching rows of V, staged KC columns at a time, so
// the distances are computed once whatever k is.  Y rows past m give
// kernel values and V rows of 0; rows past b are computed and not
// written.  The TPU grid's sequential contraction axis becomes the loop
// over Y inside the block.
#include <cuda_runtime.h>

#include <type_traits>

#include "kernel_epilogue.cuh"
#include "pair_tile.cuh"

namespace {

using pair_tile::BM;
using pair_tile::BN;
using pair_tile::kThreads;
using pair_tile::TM;
using pair_tile::TN;

constexpr int KC = 32;          // columns of V staged per contraction pass
constexpr int LDK = BN + 1;     // row stride of the kernel tile
constexpr int LDV = KC + 1;     // row stride of a staged V chunk

template <typename T, bool L1>
__global__ void __launch_bounds__(kThreads)
kernel_matvec_kernel(const T* __restrict__ xc, const T* __restrict__ y,
                     const T* __restrict__ v, T* __restrict__ z, int b,
                     int m, int d, int kc, int ld, int kind, T sigma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ys = xs + pair_tile::DC * pair_tile::LDX;
  T* ks = ys + pair_tile::DC * pair_tile::LDY;      // (BM, LDK)
  T* vs = ks + BM * LDK;                            // (BN, LDV)
  T* acc = vs + BN * LDV;                           // (BM, kc)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * BM;

  for (int e = threadIdx.x; e < BM * kc; e += kThreads) acc[e] = T(0);
  for (int c0 = 0; c0 < m; c0 += BN) {
    T dist[TM][TN];
    pair_tile::distances<T, L1>(xc, y, b, m, d, r0, c0, xs, ys, dist);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx + 16 * j;
        ks[(ty + 16 * i) * LDK + col] =
            c0 + col < m ? kernel_epilogue(kind, dist[i][j], sigma) : T(0);
      }
    for (int k0 = 0; k0 < kc; k0 += KC) {
      const int kw = min(KC, kc - k0);
      __syncthreads();        // the kernel tile is written; vs is free
      for (int e = threadIdx.x; e < BN * kw; e += kThreads) {
        const int j = e / kw, c = e % kw;
        vs[j * LDV + c] = c0 + j < m
                              ? v[static_cast<size_t>(c0 + j) * ld + k0 + c]
                              : T(0);
      }
      __syncthreads();
      // each (row, column) output belongs to one thread, the same one on
      // every tile, so the accumulator needs no atomics
      for (int o = threadIdx.x; o < BM * kw; o += kThreads) {
        const int i = o / kw, c = o % kw;
        const T* krow = ks + i * LDK;
        T s = T(0);
#pragma unroll 8
        for (int j = 0; j < BN; ++j)
          s = pair_tile::fused_ma(krow[j], vs[j * LDV + c], s);
        acc[i * kc + k0 + c] += s;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * kc; e += kThreads) {
    const int i = e / kc, c = e % kc;
    if (r0 + i < b) z[static_cast<size_t>(r0 + i) * ld + c] = acc[e];
  }
}

// Shared memory of one block (ops.matvec_smem mirrors it): the two staged
// feature chunks, the kernel tile, a V chunk and the accumulators.
template <typename T>
size_t smem_bytes(int kc) {
  return (static_cast<size_t>(pair_tile::kStageElems) + BM * LDK + BN * LDV +
          static_cast<size_t>(BM) * kc) * sizeof(T);
}

template <typename T, bool L1>
int launch_kind(const T* xc, const T* y, const T* v, T* z, int b, int m,
                int d, int kc, int ld, int kind, T sigma,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(kc);
  const int err = launch_with_smem(kernel_matvec_kernel<T, L1>, smem);
  if (err) return err;
  const unsigned grid = static_cast<unsigned>((b + BM - 1) / BM);
  kernel_matvec_kernel<T, L1><<<grid, kThreads, smem, stream>>>(
      xc, y, v, z, b, m, d, kc, ld, kind, sigma);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xc, const void* y, const void* v, void* z, int b,
           int m, int d, int kc, int ld, int kind, double sigma,
           void* stream) {
  if (b == 0 || kc == 0) return 0;
  const auto args = [&](auto l1) {
    return launch_kind<T, decltype(l1)::value>(
        static_cast<const T*>(xc), static_cast<const T*>(y),
        static_cast<const T*>(v), static_cast<T*>(z), b, m, d, kc, ld, kind,
        static_cast<T>(sigma), static_cast<cudaStream_t>(stream));
  };
  return kind == KIND_LAPLACE ? args(std::true_type{})
                              : args(std::false_type{});
}

}  // namespace

extern "C" int kernel_matvec_f32(const void* xc, const void* y, const void* v,
                                 void* z, int b, int m, int d, int kc, int ld,
                                 int kind, double sigma, void* stream) {
  return launch<float>(xc, y, v, z, b, m, d, kc, ld, kind, sigma, stream);
}

extern "C" int kernel_matvec_f64(const void* xc, const void* y, const void* v,
                                 void* z, int b, int m, int d, int kc, int ld,
                                 int kind, double sigma, void* stream) {
  return launch<double>(xc, y, v, z, b, m, d, kc, ld, kind, sigma, stream);
}

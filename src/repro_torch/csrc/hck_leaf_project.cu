// Leaf projection c_p = U_p^T b_p for every leaf p (HCK Algorithm 3,
// phase 1: the leaf level of the common-upward pass in oos.prepare).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hck_leaf/hck_leaf.py::hck_leaf_project (_project_body).
//
// Shapes: u (P, n0, r), b (P, n0, k) -> c (P, r, k), all row-major and
// contiguous; T is float or double and the sums are taken in T.
//
// Bound on the H100: bytes.  The kernel reads every element of u and b
// once and writes c once, 2 flops per u element: at the covtype shape
// (P = 4096, n0 = r = 128, k = 7, f32) that is ~298 MB, ~89 us at
// 3.35 TB/s, against 0.06 GFLOP.
//
// Design: enough bytes in flight per SM.  A block of 256 threads takes
// `lpb` leaves (more than one only where a leaf has fewer rows than the
// block has row groups, so small leaves do not leave threads idle).  Per
// leaf, `ct` column threads each own W neighbouring columns of U_p and
// `groups` row groups split the n0 rows: thread (g, cq) reads rows g,
// g + groups, ... of columns W cq .. W cq + W - 1, RB rows' loads issued
// before their sums, with one 16-byte load a row (W = 4 floats or 2 doubles) where r % W == 0 and u is 16-byte
// aligned, else W = 1 (the scalar path of the same kernel; the wrapper
// chooses by shape and address).  Neighbouring threads read neighbouring
// addresses.  b_p is staged in shared memory once per block (KT columns,
// up to 256 rows at a time) and read as a broadcast.  Each thread sums its
// rows into W x KT registers; the row groups' partial sums meet in shared
// memory (laid out [group][output column][U column], so a warp's stores
// and the final reads fall on distinct banks) and are added in group
// order.
#include <cuda_runtime.h>

#include "kernel_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int KT = 8;                   // output columns per register tile
constexpr int RB = 8;                   // rows of U loaded per batch

template <typename T, int W>
struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<double, 2> { using type = double2; };

template <typename T, int W>
__device__ __forceinline__ void load_row(const T* __restrict__ src, T* out) {
  const auto v = *reinterpret_cast<const typename Vec<T, W>::type*>(src);
  if constexpr (W == 1) {
    out[0] = v;
  } else {
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = e[w];
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_row(T* dst, const T* vals) {
  typename Vec<T, W>::type v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int w = 0; w < W; ++w) e[w] = vals[w];
  *reinterpret_cast<typename Vec<T, W>::type*>(dst) = v;
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
leaf_project_kernel(const T* __restrict__ u, const T* __restrict__ b,
                    T* __restrict__ c, int p, int n0, int r, int k, int ct,
                    int groups, int lpb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);         // lpb x nb x KT
  T* red = bs + kThreads * KT;                    // lpb x groups x KT x ct W
  const int span = ct * W;                        // columns per pass
  const int nb = kThreads / lpb;                  // staged rows per leaf
  const int slot = threadIdx.x / (groups * ct);
  const int g = threadIdx.x % (groups * ct) / ct;
  const int cq = threadIdx.x % ct;
  const int leaf0 = blockIdx.x * lpb;
  const int leaf = leaf0 + slot;
  const bool mine = slot < lpb && leaf < p;
  for (int c0 = 0; c0 < k; c0 += KT) {
    const int kt = min(KT, k - c0);
    for (int cb = 0; cb < r; cb += span) {
      const int col = cb + cq * W;
      const bool live = mine && col < r;
      T acc[W][KT];
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int j = 0; j < KT; ++j) acc[w][j] = T(0);
      for (int n1 = 0; n1 < n0; n1 += nb) {
        const int rows = min(nb, n0 - n1);
        __syncthreads();                          // bs and red free again
        T staged[KT];                   // KT independent loads in flight
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const int e = threadIdx.x + i * kThreads;
          const int sl = e / KT / nb, rr = e / KT - sl * nb, j = e % KT;
          staged[i] = T(0);
          if (sl < lpb && leaf0 + sl < p && rr < rows && j < kt)
            staged[i] = b[(static_cast<size_t>(leaf0 + sl) * n0 + n1 + rr) *
                              k + c0 + j];
        }
#pragma unroll
        for (int i = 0; i < KT; ++i) bs[threadIdx.x + i * kThreads] = staged[i];
        __syncthreads();
        if (live) {
          const T* up = u + (static_cast<size_t>(leaf) * n0 + n1) * r + col;
          const T* bl = bs + slot * nb * KT;
          for (int n = g; n < rows; n += RB * groups) {
            T un[RB][W];                // RB rows' loads in flight at once
#pragma unroll
            for (int i = 0; i < RB; ++i)
              if (n + i * groups < rows)
                load_row<T, W>(up + static_cast<size_t>(n + i * groups) * r,
                               un[i]);
#pragma unroll
            for (int i = 0; i < RB; ++i) {
              if (n + i * groups >= rows) break;
              const T* bn = bl + (n + i * groups) * KT;
#pragma unroll
              for (int j = 0; j < KT; ++j) {
                const T bv = bn[j];
#pragma unroll
                for (int w = 0; w < W; ++w) acc[w][j] += un[i][w] * bv;
              }
            }
          }
        }
      }
      __syncthreads();
      if (live) {                 // neighbouring threads, neighbouring words
        T* rp = red + (slot * groups + g) * KT * span + cq * W;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          T row[W];
#pragma unroll
          for (int w = 0; w < W; ++w) row[w] = acc[w][j];
          store_row<T, W>(rp + j * span, row);
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < lpb * kt * span; e += kThreads) {
        const int sl = e / (kt * span), j = e / span % kt, cr = e % span;
        const int lf = leaf0 + sl, cc = cb + cr;
        if (lf >= p || cc >= r) continue;
        const T* rp = red + (sl * groups * KT + j) * span + cr;
        T sum = T(0);
        for (int gg = 0; gg < groups; ++gg) sum += rp[gg * KT * span];
        c[(static_cast<size_t>(lf) * r + cc) * k + c0 + j] = sum;
      }
    }
  }
}

template <typename T, int W>
int launch_width(const void* u, const void* b, void* c, int p, int n0,
                 int r, int k, void* stream) {
  const int ct = min(kThreads, (r + W - 1) / W);
  const int all = kThreads / ct;                  // row groups of one leaf
  const int lpb = n0 < all ? all / max(n0, 1) : 1;
  const int groups = all / lpb;
  const size_t smem =
      sizeof(T) * KT * (kThreads + static_cast<size_t>(lpb) * groups * ct * W);
  const int err = launch_with_smem(leaf_project_kernel<T, W>, smem);
  if (err) return err;
  const unsigned blocks = static_cast<unsigned>((p + lpb - 1) / lpb);
  leaf_project_kernel<T, W><<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(b), static_cast<T*>(c),
      p, n0, r, k, ct, groups, lpb);
  return static_cast<int>(cudaGetLastError());
}

// ``width`` is 16 / sizeof(T) (16-byte loads: r % width == 0 and u 16-byte
// aligned, else an invalid-value error) or 1.
template <typename T>
int launch(const void* u, const void* b, void* c, int p, int n0, int r,
           int k, int width, void* stream) {
  if (p == 0 || r == 0 || k == 0) return 0;
  constexpr int V = 16 / sizeof(T);
  if (width == 1)
    return launch_width<T, 1>(u, b, c, p, n0, r, k, stream);
  if (width != V || r % V || reinterpret_cast<size_t>(u) % 16)
    return cudaErrorInvalidValue;
  return launch_width<T, V>(u, b, c, p, n0, r, k, stream);
}

}  // namespace

extern "C" int hck_leaf_project_f32(const void* u, const void* b, void* c,
                                    int p, int n0, int r, int k, int width,
                                    void* stream) {
  return launch<float>(u, b, c, p, n0, r, k, width, stream);
}

extern "C" int hck_leaf_project_f64(const void* u, const void* b, void* c,
                                    int p, int n0, int r, int k, int width,
                                    void* stream) {
  return launch<double>(u, b, c, p, n0, r, k, width, stream);
}

// The panel form of B13 leaf_update (leaf_update.cu): the bordered
// extension of a leaf's Schur-complement factors for the shapes whose
// resident plan passes the shared memory a block can have, every (n0, k)
// with n0 + k <= 512 (chol_panel::kMaxM, the leaves B3's panel form
// factors).  A model.update at leaf 256 in float64 reaches it at k > 8
// (the resident form holds three n0 x k buffers, B^T, the k x k sums and
// two panels of L and Linv), and leaves past 292 rows in float32.
//
// Replaces, as leaf_update.cu does, the Pallas TPU kernel
//   src/repro/kernels/update_stage/update_stage.py::hck_leaf_update
//   (_update_body),
// with its semantics: the leading (n0, n0) quadrants COPIED bit for bit,
// the upper-right blocks zero, the products over Linv's whole rows, and an
// S that is not positive definite gives NaN (no clamp).
//
// Shapes as leaf_update.cu's, plus ``work`` (P, 2, k, k) of device memory
// that the wrapper allocates: S, then L22 = chol(S), and X = L22^-1.
//
// Design: one block of 128 threads a leaf; only a slab of KS = 8 border
// rows is in shared memory at a time, the k x k blocks live in device
// memory (k reaches 511 at n0 1), and L and Linv are read in place
// through L1 / L2 (each leaf's Linv is read twice per slab).
//   1. the leading n0 rows of both extended factors: the old quadrants and
//      k zeros a row;
//   2. per slab of KS border rows q0..: B's rows staged; L21[q][j] =
//      sum_m B[q][m] Linv[j][m] (a warp a row j, lanes over m, the KS sums
//      reduced across the warp), written to shared memory and straight to
//      its place in lo_ext's row n0 + q; then T[q][j] = sum_m L21[q][m]
//      Linv[m][j] (a thread a column, a chain in ascending m) into
//      linv_ext's row n0 + q, where -X T replaces it in step 4;
//   3. S = C - L21 L21^T (lower triangle, a thread an entry, L21 read back
//      from lo_ext, a chain in ascending m), factored in device memory by
//      chol_panel.cuh (S -> L22, its reciprocal pivots staged), then X =
//      L22^-1 by its block columns from the right;
//   4. the k new rows: [L21, L22, 0] and [-X T, X, 0], -X T in place (a
//      thread a column of T, bottom row first: row q reads T's rows <= q
//      only).
// Bound on the H100: bytes, as the resident form's (lo and linv read,
// both extended factors written); the latency of the factor's panel
// chain and the L2 reads of Linv per slab keep it well above.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "chol_panel.cuh"
#include "kernel_epilogue.cuh"

namespace {

constexpr int kThreads = chol_blocked::kThreads;  // 128
constexpr int kWarps = kThreads / 32;
constexpr int KS = 8;                             // border rows a slab
constexpr unsigned kFull = 0xffffffffu;

using chol_blocked::fmadd;

template <typename T>
struct Args {
  const T* lo;
  const T* linv;
  const T* b;
  const T* c;
  T* lo_ext;
  T* linv_ext;
  T* work;
  int n0, k;
};

// Shared memory: the slab's B and L21 rows (2 KS n0 values), or, later and
// in the same space, chol_panel's panel of a k x k tile.
template <typename T>
__host__ __device__ size_t smem_bytes(int n0, int k) {
  const size_t slab = sizeof(T) * 2 * KS * static_cast<size_t>(n0);
  const size_t chol = k > 0 ? chol_panel::smem_bytes(k, sizeof(T)) : 0;
  return slab > chol ? slab : chol;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
leaf_update_panel_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = a.n0, k = a.k, ne = n0 + k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t leaf = blockIdx.x;
  const T* Lo = a.lo + leaf * n0 * n0;
  const T* Li = a.linv + leaf * n0 * n0;
  const T* B = a.b + leaf * k * n0;
  const T* C = a.c + leaf * k * k;
  T* LoE = a.lo_ext + leaf * ne * ne;
  T* LiE = a.linv_ext + leaf * ne * ne;
  T* S = a.work + leaf * 2 * k * k;                  // S, then L22
  T* X = S + static_cast<size_t>(k) * k;            // L22^-1
  T* bs = reinterpret_cast<T*>(smem_raw);           // (KS, n0): B's slab
  T* l21s = bs + KS * n0;                           // (KS, n0): L21's

  // 1. the old quadrants, k zeros after each of their rows
  for (size_t e = tid; e < static_cast<size_t>(n0) * ne; e += kThreads) {
    const int i = static_cast<int>(e / ne), col = static_cast<int>(e % ne);
    const bool old = col < n0;
    LoE[e] = old ? Lo[static_cast<size_t>(i) * n0 + col] : T(0);
    LiE[e] = old ? Li[static_cast<size_t>(i) * n0 + col] : T(0);
  }

  // 2. L21 and T, a slab of KS border rows at a time
  for (int q0 = 0; q0 < k; q0 += KS) {
    const int ks = min(KS, k - q0);
    for (int e = tid; e < KS * n0; e += kThreads) {
      const int q = e / n0;
      bs[e] = q < ks ? B[static_cast<size_t>(q0) * n0 + e] : T(0);
    }
    __syncthreads();                 // B's slab is staged
    for (int j = warp; j < n0; j += kWarps) {
      const T* lj = Li + static_cast<size_t>(j) * n0;
      T acc[KS];
#pragma unroll
      for (int q = 0; q < KS; ++q) acc[q] = T(0);
#pragma unroll 4                  // loads of Linv in flight
      for (int m = lane; m < n0; m += 32) {
        const T l = lj[m];
#pragma unroll
        for (int q = 0; q < KS; ++q) acc[q] = fmadd(l, bs[q * n0 + m], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < KS; ++q) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[q] += __shfl_xor_sync(kFull, acc[q], o);
        if (lane == q && q < ks) {
          l21s[q * n0 + j] = acc[q];
          LoE[static_cast<size_t>(n0 + q0 + q) * ne + j] = acc[q];
        }
      }
    }
    __syncthreads();                 // the slab's L21 rows are staged
    for (int j = tid; j < n0; j += kThreads) {
      T acc[KS];
#pragma unroll
      for (int q = 0; q < KS; ++q) acc[q] = T(0);
#pragma unroll 8
      for (int m = 0; m < n0; ++m) {
        const T l = Li[static_cast<size_t>(m) * n0 + j];
#pragma unroll
        for (int q = 0; q < KS; ++q)
          acc[q] = fmadd(l21s[q * n0 + m], l, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < KS; ++q)
        if (q < ks) LiE[static_cast<size_t>(n0 + q0 + q) * ne + j] = acc[q];
    }
    __syncthreads();                 // the slab's buffers are free again
  }
  if (k == 0) return;

  // 3. S = C - L21 L21^T, its factor L22 and X = L22^-1 (zero above their
  // diagonals: chol_panel's inverse wants X's so)
  for (int e = tid; e < k * k; e += kThreads) {
    const int i = e / k, j = e - (e / k) * k;
    if (j > i) {
      S[e] = T(0);
      X[e] = T(0);
      continue;
    }
    const T* ri = LoE + static_cast<size_t>(n0 + i) * ne;
    const T* rj = LoE + static_cast<size_t>(n0 + j) * ne;
    T d = T(0);
#pragma unroll 8
    for (int m = 0; m < n0; ++m) d = fmadd(ri[m], rj[m], d);
    S[e] = C[e] - d;
  }
  __syncthreads();                   // S (and L21, T) are in device memory
  T* pan = reinterpret_cast<T*>(smem_raw);
  T* rdiag = pan + k * chol_panel::LDP;
  T* col = reinterpret_cast<T*>(
      smem_raw + chol_blocked::col_offset(k, chol_panel::LDP, sizeof(T)));
  chol_panel::factor(S, k, pan, rdiag, col);
  chol_panel::inverse(S, X, k, pan, rdiag);

  // 4. the k new rows: [L21, L22, 0] and [-X T, X, 0]
  for (int e = tid; e < k * k; e += kThreads) {
    const int q = e / k, c2 = e - (e / k) * k;
    const size_t at = static_cast<size_t>(n0 + q) * ne + n0 + c2;
    LoE[at] = c2 <= q ? S[e] : T(0);
    LiE[at] = c2 <= q ? X[e] : T(0);
  }
  for (int j = tid; j < n0; j += kThreads) {
    T* tj = LiE + static_cast<size_t>(n0) * ne + j;   // T[q][j] at q ne
    for (int q = k - 1; q >= 0; --q) {
      const T* xq = X + static_cast<size_t>(q) * k;
      T d = T(0);
#pragma unroll 8
      for (int m = 0; m <= q; ++m)
        d = fmadd(xq[m], tj[static_cast<size_t>(m) * ne], d);
      tj[static_cast<size_t>(q) * ne] = -d;
    }
  }
}

template <typename T>
int launch(const void* lo, const void* linv, const void* b, const void* c,
           void* lo_ext, void* linv_ext, void* work, int p, int n0, int k,
           void* stream) {
  if (p == 0 || n0 + k == 0) return 0;
  if (n0 < 1 || k < 0 || n0 + k > chol_panel::kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const T*>(lo), static_cast<const T*>(linv),
                  static_cast<const T*>(b), static_cast<const T*>(c),
                  static_cast<T*>(lo_ext), static_cast<T*>(linv_ext),
                  static_cast<T*>(work), n0, k};
  const auto kernel = leaf_update_panel_kernel<T>;
  const size_t smem = smem_bytes<T>(n0, k);
  const int err = launch_with_smem(kernel, smem);
  if (err) return err;
  kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lo, linv (P, n0, n0), b (P, k, n0), c (P, k, k) -> lo_ext, linv_ext (P,
// n0 + k, n0 + k); work (P, 2, k, k) scratch.
extern "C" int leaf_update_panel_f32(const void* lo, const void* linv,
                                     const void* b, const void* c,
                                     void* lo_ext, void* linv_ext,
                                     void* work, int p, int n0, int k,
                                     void* stream) {
  return launch<float>(lo, linv, b, c, lo_ext, linv_ext, work, p, n0, k,
                       stream);
}

extern "C" int leaf_update_panel_f64(const void* lo, const void* linv,
                                     const void* b, const void* c,
                                     void* lo_ext, void* linv_ext,
                                     void* work, int p, int n0, int k,
                                     void* stream) {
  return launch<double>(lo, linv, b, c, lo_ext, linv_ext, work, p, n0, k,
                        stream);
}

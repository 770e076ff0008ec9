// Fused leaf stage of the HCK matvec (Algorithm 1, repro.core.hmatrix
// matvec), per leaf p:
//
//   y_p = A_p b_p   (n0, k)        c_p = U_p^T b_p   (r, k)
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hck_leaf/hck_leaf.py::hck_leaf_matvec (_matvec_body).
//
// Shapes: adiag (P, n0, n0), u (P, n0, r), b (P, n0, k) -> y (P, n0, k),
// c (P, r, k); row-major and contiguous; T is float or double and every
// sum is taken in T.  A is not assumed symmetric.
//
// Bound on the H100: bytes.  A and U are read once and dominate: at the
// covtype shape (P = 4,096, n0 = r = 128, f32) 537 MB of them, ~0.16 ms at
// 3.35 TB/s at k = 1 (a Lanczos step) and ~0.17 ms at the fit's k = 7,
// against at most 0.06 GFLOP.
//
// Design (leaf_stream.cuh): persistent blocks of 256 threads stream each
// leaf's A and U once, in panels of 32 rows (16 where a block would not
// fit otherwise), through a ring of two slots (hck_leaf.ops.matvec_plan;
// at n0 = r = 128 in f32 a slot holds 32 KB of A and U rows, and a block
// 67, 83 and 96 KB at k = 1, 7 and 12 with the b buffers and the sums: two
// blocks an SM, so 64 KB of copies in flight an SM behind the panels in
// use).  A leaf's b is staged with its first panel (row stride 1 for k =
// 1, else 4 x an odd number, zero past k), in one of two buffers, so the
// next leaf's b loads while the current leaf is in use.  Rows i of A and
// of U are consumed together while their panel is resident:
//   y[i, :] = A[i, :] b     rows_times: a warp four rows (two in panels of
//                           16), lanes over j, the sums spread over the
//                           lanes (warp_sum_spread) and written straight
//                           to device memory;
//   c += U[i, :]^T b[i, :]  cols_accumulate: a thread a column of U and
//                           every other row, its chain carried across the
//                           panels in shared memory; after the leaf's last
//                           panel the two row groups are added and c
//                           written.
// The register tile comes from k at launch: KT = 1 (one instance, no
// masked accumulators, for the Lanczos steps' single column) or KT = 8,
// in tiles for any k (the wrapper splits b wider than one launch's shared
// memory holds).  The kernel issues few instructions a byte: panels of 32
// rows and four rows a warp share each panel's copy, barrier and
// bookkeeping (kept in a cursor, no division) among 8 K elements; the
// copies' alignment arithmetic takes masks, not 64-bit divisions.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "leaf_stream.cuh"

namespace {

using namespace leaf_stream;

template <typename T>
struct Args {
  const T* adiag;
  const T* u;
  const T* b;
  T* y;
  T* c;
  int p, n0, r, k;
  int ldb;          // staged b's row stride
  int va, vu;       // elements a copy of A, U (16 bytes, or 1 where the
                    // base is not 16-byte aligned)
};

template <typename T>
struct Layout {
  size_t sa, su, sb, sacc;  // elements: A and U slots, a b buffer, the sums
  __host__ __device__ Layout(int rows, int n0, int r, int k, int ldb)
      : sa(panel_elems<T>(rows, n0)),
        su(panel_elems<T>(rows, r)),
        sb(pad16<T>(static_cast<size_t>(n0) * ldb)),
        sacc(pad16<T>(static_cast<size_t>(kGroups) * k * r)) {}
  // two ring slots, two b buffers, the sums
  __host__ __device__ size_t elems() const {
    return 2 * (sa + su) + 2 * sb + sacc;
  }
};

template <int kRows, int KT, typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
leaf_matvec_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout<T> lay(kRows, a.n0, a.r, a.k, a.ldb);
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* bsm = ring + 2 * (lay.sa + lay.su);
  T* acc = bsm + 2 * lay.sb;
  const int n0 = a.n0, r = a.r, k = a.k, ldb = a.ldb;
  const int npl = (n0 + kRows - 1) / kRows;
  const long long nn = static_cast<long long>(n0) * n0;
  const long long nr = static_cast<long long>(n0) * r;
  const long long nk = static_cast<long long>(n0) * k;
  const int di = kThreads / k, dq = kThreads - di * k;  // a stride in (i, q)

  // the padding columns of the staged right-hand sides stay zero
  for (size_t e = threadIdx.x; e < 2 * lay.sb; e += kThreads) bsm[e] = T(0);
  __syncthreads();

  auto issue = [&](const Cursor& in) {
    const int i0 = in.pi * kRows, rows = min(kRows, n0 - i0);
    T* slot = ring + in.slot * (lay.sa + lay.su);
    const long long ea = in.leaf * nn + static_cast<long long>(i0) * n0;
    const long long eu = in.leaf * nr + static_cast<long long>(i0) * r;
    copy_span(slot, a.adiag, ea, ea + static_cast<long long>(rows) * n0, a.va);
    copy_span(slot + lay.sa, a.u, eu, eu + static_cast<long long>(rows) * r,
              a.vu);
    if (in.pi == 0) {
      T* bt = bsm + in.buf() * lay.sb;
      const T* src = a.b + in.leaf * nk;
      for (int e = threadIdx.x, i = e / k, q = e - i * k; e < nk;
           e += kThreads, i += di, q += dq) {
        if (q >= k) { q -= k; ++i; }          // e = i k + q
        acopy::element(bt + i * ldb + q, src + e, true);
      }
    }
  };
  auto body = [&](const Cursor& at) {
    const int i0 = at.pi * kRows, rows = min(kRows, n0 - i0);
    const T* slot = ring + at.slot * (lay.sa + lay.su);
    const T* ap =
        slot + span_offset(at.leaf * nn + static_cast<long long>(i0) * n0, a.va);
    const T* up = slot + lay.sa +
                  span_offset(at.leaf * nr + static_cast<long long>(i0) * r, a.vu);
    const T* bt = bsm + at.buf() * lay.sb;
    T* yl = a.y + at.leaf * nk + static_cast<long long>(i0) * k;
    rows_times<kRows / 8, KT>(ap, rows, n0, bt, ldb, k,
                              [=](int i, int q, T v) { yl[i * k + q] = v; });
    cols_accumulate<KT, false>(up, rows, r, bt + i0 * ldb, ldb, k, acc,
                               at.pi == 0);
    if (at.pi == npl - 1) {
      __syncthreads();             // both row groups' sums are complete
      T* cl = a.c + at.leaf * r * k;
      for (int e = threadIdx.x; e < r * k; e += kThreads) {
        const int q = e / r, j = e - (e / r) * r;
        cl[j * k + q] = acc[q * r + j] + acc[(k + q) * r + j];
      }
    }
  };
  stream_panels(a.p, npl, issue, body);
}

template <int kRows, int KT, typename T>
int launch_kernel(const Args<T>& a, int per_sm, size_t smem,
                  cudaStream_t stream) {
  return launch_persistent(leaf_matvec_kernel<kRows, KT, T>, a, a.p, per_sm,
                           smem, stream);
}

template <typename T>
int launch(const void* adiag, const void* u, const void* b, void* y, void* c,
           int p, int n0, int r, int k, int rows, int kt, int ldb, int va,
           int vu, int per_sm, int smem, void* stream) {
  if (p == 0 || k == 0 || n0 == 0) return 0;
  constexpr int v = 16 / sizeof(T);
  const bool ok =
      r >= 0 && (rows == 16 || rows == 32) &&
      (kt == 1 ? k == 1 && ldb == 1
               : kt == 8 && ldb >= (k + 7) / 8 * 8 && ldb % 4 == 0) &&
      (va == 1 || va == v) && (vu == 1 || vu == v) &&
      Layout<T>(rows, n0, r, k, ldb).elems() * sizeof(T) <=
          static_cast<size_t>(smem);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const T*>(adiag), static_cast<const T*>(u),
                  static_cast<const T*>(b), static_cast<T*>(y),
                  static_cast<T*>(c), p, n0, r, k, ldb, va, vu};
  const auto st = static_cast<cudaStream_t>(stream);
  if (rows == 16)
    return kt == 1 ? launch_kernel<16, 1>(a, per_sm, smem, st)
                   : launch_kernel<16, 8>(a, per_sm, smem, st);
  return kt == 1 ? launch_kernel<32, 1>(a, per_sm, smem, st)
                 : launch_kernel<32, 8>(a, per_sm, smem, st);
}

}  // namespace

extern "C" int leaf_matvec_f32(const void* adiag, const void* u,
                               const void* b, void* y, void* c, int p, int n0,
                               int r, int k, int rows, int kt, int ldb, int va,
                               int vu, int per_sm, int smem, void* stream) {
  return launch<float>(adiag, u, b, y, c, p, n0, r, k, rows, kt, ldb, va, vu,
                       per_sm, smem, stream);
}

extern "C" int leaf_matvec_f64(const void* adiag, const void* u,
                               const void* b, void* y, void* c, int p, int n0,
                               int r, int k, int rows, int kt, int ldb, int va,
                               int vu, int per_sm, int smem, void* stream) {
  return launch<double>(adiag, u, b, y, c, p, n0, r, k, rows, kt, ldb, va, vu,
                        per_sm, smem, stream);
}

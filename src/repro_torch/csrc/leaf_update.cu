// Bordered extension of the leaf Schur-complement factors (the online
// update, repro.core.hmatrix.invert_extend): a leaf whose ridged Schur
// complement A11 = L L^T grew by k appended rows, with cross block B
// (k, n0) and appended block C (k, k), gets
//
//   L21   = B L^-T = B Linv^T           (k, n0)
//   S     = C - L21 L21^T                (k, k)
//   L22   = chol(S),  X = L22^-1
//   L'    = [[L, 0], [L21, L22]]
//   Linv' = [[Linv, 0], [-X (L21 Linv), X]]
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/update_stage/update_stage.py::hck_leaf_update
//   (_update_body).
//
// Shapes: lo, linv (P, n0, n0) lower triangular (linv = lo^-1), b (P, k,
// n0), c (P, k, k) -> lo_ext, linv_ext (P, n0 + k, n0 + k), all row-major
// and contiguous; T is float or double and every sum is taken in T.  The
// leading (n0, n0) quadrants are COPIED from the inputs, never recomputed,
// so they are bit-identical to them, whatever lies above their diagonal,
// and removing the k rows again is an exact truncation; the upper-right
// (n0, k) blocks are zero.  The products use Linv's whole rows, as the
// reference does.  An appended S that is not positive definite gives NaN
// (no pivot clamp), as the reference's Cholesky does.
//
// Bound on the H100: bytes.  At covtype width in update round 1 (P =
// 4,096, n0 = 128, k = 14, f32; chip_smoke.py phase 8c) it reads 569 MB (lo
// and linv, B and C) and writes 661 MB (the two extended factors), ~0.37 ms
// at 3.35 TB/s; its ~2 k n0^2 flops a product and leaf are far below that.
//
// Design (leaf_stream.cuh): persistent blocks of 256 threads stream each
// leaf's L and Linv once, in panels of 32 rows (16 where two blocks an SM
// would not fit otherwise), through a ring of two slots
// (leaf_stream.stream_plan via update_stage.ops.update_plan: 103 and 112
// KB a block at both update rounds' shapes, two blocks an SM).  A leaf's B^T is staged with
// its first panel (row stride 4 x an odd number, zero past k).  While a
// panel is resident:
//   1. L21^T[j, :] = Linv[j, :] B^T for its rows j (rows_times, into
//      shared memory);
//   2. its rows of both extended factors are written straight out, at
//      stride n0 + k, with k zeros after each;
//   3. T^T += Linv[j, :]^T L21^T[j, :] (cols_accumulate: T = L21 Linv, a
//      thread a column and every other tile of 8 of its k rows, carried
//      in shared memory).
// After the leaf's last panel comes the border, while the next leaf's
// first panels load: S = C - L21 L21^T (lower triangle, a thread an
// entry); L22 = chol(S) by chol_blocked.cuh's factor_panels (B3's and
// B8's blocked factor: a warp-level diagonal block and panels of 32, so
// k > 32 takes the same path), which leaves the reciprocal pivots; X =
// L22^-1 by forward substitution, a thread a column; then the k new rows
// of both factors: [L21, L22] and [-X T, X], zero above the diagonal.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "chol_blocked.cuh"
#include "leaf_stream.cuh"

namespace {

using namespace leaf_stream;

constexpr int KT = 8;   // right-hand-side tile of both products

template <typename T>
struct Args {
  const T* lo;
  const T* linv;
  const T* b;
  const T* c;
  T* lo_ext;
  T* linv_ext;
  int p, n0, k;
  int ldk;          // staged B^T's and L21^T's row stride
  int vl, vi;       // elements a copy of lo, linv (16 bytes, or 1)
};

template <typename T>
struct Layout {
  size_t sl, sb, sacc, sk;  // elements: an L slot, a B^T buffer, the
                            // sums, a k x k tile
  int lds;                  // row stride of the k x k tiles
  __host__ __device__ Layout(int rows, int n0, int k, int ldk)
      : sl(panel_elems<T>(rows, n0)),
        sb(pad16<T>(static_cast<size_t>(n0) * ldk)),
        sacc(pad16<T>(static_cast<size_t>(k) * n0)),
        sk(pad16<T>(static_cast<size_t>(k) * (k | 1))),
        lds(k | 1) {}
  // two ring slots of L and Linv, two B^T buffers, L21^T, sums, S / L22,
  // X, reciprocal pivots, and the factor's column buffer (NB values)
  __host__ __device__ size_t elems(int k) const {
    return 2 * 2 * sl + 3 * sb + sacc + 2 * sk + pad16<T>(k) +
           chol_blocked::NB;
  }
};

template <int kRows, typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
leaf_update_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = a.n0, k = a.k, ldk = a.ldk, ne = n0 + k;
  const Layout<T> lay(kRows, n0, k, ldk);
  const int lds = lay.lds;
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* btb = ring + 2 * 2 * lay.sl;
  T* l21t = btb + 2 * lay.sb;                    // (n0, ldk): L21^T
  T* acc = l21t + lay.sb;                        // (k, n0): T
  T* sm = acc + lay.sacc;                        // (k, lds): S, then L22
  T* xm = sm + lay.sk;                           // (k, lds): X = L22^-1
  T* rdiag = xm + lay.sk;                        // 1 / L22_ii
  T* colbuf = rdiag + pad16<T>(k);               // the factor's column
  const int npl = (n0 + kRows - 1) / kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long nn = static_cast<long long>(n0) * n0;
  const long long nk = static_cast<long long>(k) * n0;
  const long long ee = static_cast<long long>(ne) * ne;
  const int di = kThreads / n0, dt = kThreads - di * n0;  // a stride in (q, t)

  // the padding columns of the staged B^T stay zero
  for (size_t e = tid; e < 2 * lay.sb; e += kThreads) btb[e] = T(0);
  __syncthreads();

  auto issue = [&](const Cursor& in) {
    const int i0 = in.pi * kRows;
    const long long e0 = in.leaf * nn + static_cast<long long>(i0) * n0;
    const long long e1 = e0 + static_cast<long long>(min(kRows, n0 - i0)) * n0;
    T* slot = ring + in.slot * 2 * lay.sl;
    copy_span(slot, a.lo, e0, e1, a.vl);
    copy_span(slot + lay.sl, a.linv, e0, e1, a.vi);
    if (in.pi == 0) {
      T* bt = btb + in.buf() * lay.sb;
      const T* src = a.b + in.leaf * nk;
      for (int e = tid, q = e / n0, t = e - q * n0; e < nk;
           e += kThreads, q += di, t += dt) {
        if (t >= n0) { t -= n0; ++q; }        // e = q n0 + t
        acopy::element(bt + t * ldk + q, src + e, true);
      }
    }
  };
  auto body = [&](const Cursor& at) {
    const int i0 = at.pi * kRows, rows = min(kRows, n0 - i0);
    const long long leaf = at.leaf;
    const long long e0 = leaf * nn + static_cast<long long>(i0) * n0;
    const T* slot = ring + at.slot * 2 * lay.sl;
    const T* lp = slot + span_offset(e0, a.vl);
    const T* ip = slot + lay.sl + span_offset(e0, a.vi);
    const T* bt = btb + at.buf() * lay.sb;
    // 1. L21^T[j][q] = sum_m Linv[j][m] B[q][m] for the panel's rows
    T* l21p = l21t + i0 * ldk;
    rows_times<kRows / 8, KT>(ip, rows, n0, bt, ldk, k,
                       [=](int i, int q, T v) { l21p[i * ldk + q] = v; });
    // 2. the panel's rows of both extended factors
    T* lo_out = a.lo_ext + leaf * ee + static_cast<long long>(i0) * ne;
    T* li_out = a.linv_ext + leaf * ee + static_cast<long long>(i0) * ne;
    for (int i = warp; i < rows; i += kWarps)
      for (int col = lane; col < ne; col += 32) {
        const bool old = col < n0;
        lo_out[i * ne + col] = old ? lp[i * n0 + col] : T(0);
        li_out[i * ne + col] = old ? ip[i * n0 + col] : T(0);
      }
    __syncthreads();               // the panel's rows of L21^T are staged
    // 3. T^T[m][q] += sum_j Linv[j][m] L21^T[j][q] over the panel's rows
    cols_accumulate<KT, true>(ip, rows, n0, l21p, ldk, k, acc, at.pi == 0);
    if (at.pi != npl - 1) return;

    // ---- the border of this leaf ----
    __syncthreads();               // L21^T and T are complete
    const T* C = a.c + leaf * k * k;
    for (int e = tid; e < k * k; e += kThreads) {
      const int i = e / k, j = e - (e / k) * k;
      if (j > i) continue;
      T d = T(0);
      for (int m = 0; m < n0; ++m)
        d = fmadd(l21t[m * ldk + i], l21t[m * ldk + j], d);
      sm[i * lds + j] = C[e] - d;
    }
    __syncthreads();
    chol_blocked::factor_panels(sm, lds, rdiag, colbuf, k);
    if (tid < k) {                 // X's column tid, top down
      const int cx = tid;
      for (int i = cx; i < k; ++i) {
        T v = i == cx ? T(1) : T(0);
        for (int m = cx; m < i; ++m)
          v = fmadd(-sm[i * lds + m], xm[m * lds + cx], v);
        xm[i * lds + cx] = v * rdiag[i];
      }
    }
    __syncthreads();
    // the k new rows: [L21, L22] and [-X T, X]
    lo_out = a.lo_ext + leaf * ee + static_cast<long long>(n0) * ne;
    li_out = a.linv_ext + leaf * ee + static_cast<long long>(n0) * ne;
    for (int q = warp; q < k; q += kWarps)
      for (int col = lane; col < ne; col += 32) {
        T vl, vi;
        if (col < n0) {
          vl = l21t[col * ldk + q];
          T d = T(0);
          for (int m = 0; m <= q; ++m)
            d = fmadd(xm[q * lds + m], acc[m * n0 + col], d);
          vi = -d;
        } else {
          const int c2 = col - n0;
          vl = c2 <= q ? sm[q * lds + c2] : T(0);
          vi = c2 <= q ? xm[q * lds + c2] : T(0);
        }
        lo_out[q * ne + col] = vl;
        li_out[q * ne + col] = vi;
      }
  };
  stream_panels(a.p, npl, issue, body);
}

template <int kRows, typename T>
int launch_kernel(const Args<T>& a, int per_sm, size_t smem,
                  cudaStream_t stream) {
  return launch_persistent(leaf_update_kernel<kRows, T>, a, a.p, per_sm, smem,
                           stream);
}

template <typename T>
int launch(const void* lo, const void* linv, const void* b, const void* c,
           void* lo_ext, void* linv_ext, int p, int n0, int k, int rows,
           int ldk, int vl, int vi, int per_sm, int smem, void* stream) {
  if (p == 0 || n0 + k == 0) return 0;
  constexpr int v = 16 / sizeof(T);
  const bool ok =
      n0 >= 1 && k >= 0 && (rows == 16 || rows == 32) &&
      ldk >= (k + KT - 1) / KT * KT && ldk % 4 == 0 &&
      (vl == 1 || vl == v) && (vi == 1 || vi == v) &&
      Layout<T>(rows, n0, k, ldk).elems(k) * sizeof(T) <=
          static_cast<size_t>(smem);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const T*>(lo), static_cast<const T*>(linv),
                  static_cast<const T*>(b), static_cast<const T*>(c),
                  static_cast<T*>(lo_ext), static_cast<T*>(linv_ext), p, n0,
                  k, ldk, vl, vi};
  const auto st = static_cast<cudaStream_t>(stream);
  return rows == 16 ? launch_kernel<16>(a, per_sm, smem, st)
                    : launch_kernel<32>(a, per_sm, smem, st);
}

}  // namespace

extern "C" int leaf_update_f32(const void* lo, const void* linv,
                               const void* b, const void* c, void* lo_ext,
                               void* linv_ext, int p, int n0, int k, int rows,
                               int ldk, int vl, int vi, int per_sm, int smem,
                               void* stream) {
  return launch<float>(lo, linv, b, c, lo_ext, linv_ext, p, n0, k, rows, ldk,
                       vl, vi, per_sm, smem, stream);
}

extern "C" int leaf_update_f64(const void* lo, const void* linv,
                               const void* b, const void* c, void* lo_ext,
                               void* linv_ext, int p, int n0, int k, int rows,
                               int ldk, int vl, int vi, int per_sm, int smem,
                               void* stream) {
  return launch<double>(lo, linv, b, c, lo_ext, linv_ext, p, n0, k, rows,
                        ldk, vl, vi, per_sm, smem, stream);
}

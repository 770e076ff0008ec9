// Fused leaf stage of the structured-inverse apply (Algorithm 2 solve,
// repro.core.hmatrix apply_inverse), per leaf p:
//
//   c_p = U_p^T b_p                                       (r, k)
//   x_p = Linv_p^T (Linv_p b_p) + U_p (Sig_p c_p)         (n0, k)
//
// with Linv_p the inverse Cholesky factor of the leaf Schur complement
// and Sig_p the corrected middle factor of the leaf's parent.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/hck_leaf/hck_leaf.py::hck_leaf_solve (_solve_body).
//
// Shapes: linv (P, n0, n0), u (P, n0, r), sig (S, r, r), b (P, n0, k) ->
// x (P, n0, k), c (P, r, k); row-major and contiguous; T is float or
// double and every sum is taken in T.  S = P (one Sig per leaf) or
// S = P / 2 (one per parent: leaf p reads block p >> 1 in place, so the
// per-leaf copy the reference makes with _rep2 never reaches memory).
// Sig is not assumed symmetric.  Linv is lower triangular: its entries
// above the diagonal are never read (every producer of the port's
// inv.linv writes exact zeros there; tests/test_torch_oos_solve_redesign.py
// holds B3's plain version, the blocked algorithm of its kernel and
// invert_extend to that).
//
// Bound on the H100: bytes.  At the covtype shape (P = 4,096, n0 = r =
// 128, k = 7, f32): Linv's lower triangle in the 32-byte sectors its rows
// touch (135 MB), U (268 MB), the 2,048 parent Sig blocks (134 MB), b, x
// and c (44 MB): ~0.17 ms at 3.35 TB/s, against 0.12 GFLOP.
//
// Design: one block of 128 threads a leaf; consecutive blocks are
// siblings, so the second read of a parent's Sig comes from L2 (the first
// block prefetches it into L2 while it stages).  The block copies Linv's
// lower triangle and U into shared memory once, with cp.async: the
// triangle by quads of 4 rows, each row's chunks of 4 elements up to its
// diagonal (the entries above it zero-filled by the copy), chunk c of the
// quad's 4 rows side by side; U with rows padded to an odd number of
// 16-byte chunks and row 4m + e stored at row e nq + m.  At n0 = r = 128
// in f32 that is 35.3 + 67.6 KB, and with three right-hand-side buffers
// 115 KB: two blocks an SM, one copying while the other computes.  Where
// the staged copy does not fit (f64 at 128, grown leaves past 167, n0 up
// to 512) Linv or U, or both, are read in place from device memory by the
// same code.  Leaves past 256 rows (a model.update at leaf 256 grows them
// to 256 + k) take the instance whose lanes hold four quads of x instead
// of two (MQ = 4; warps 2-3 sum U v's second half into their own x
// registers, so that float64 fits 255 registers), Linv and U read in
// place (the wrapper's plan: the staged triangle alone would leave one
// block of four warps an SM).  Right-hand sides go 8 columns at a time (b, then Sig c; Linv
// b; U^T b, then half of U Sig c: 8 columns a row, zero past k), each warp
// 4 of them, each thread a 4 x 4 register tile, in three steps:
//   1. warps 0-1: t = Linv b, a lane a quad of rows and their chunks up to
//      the diagonal (the zero triangle skipped); warps 2-3: c = U^T b, a
//      lane a quad of U's columns (one 16-byte read of U a row);
//   2. warps 0-1: x = Linv^T t, a lane a quad of Linv's columns and the
//      rows at and below it (kept in registers; lane b reads row (b + s)
//      mod 4 of a quad at step s, so lanes spread over the banks); warps
//      2-3: v = Sig c, a lane a quad of Sig's rows read from device memory,
//      16 bytes of each of its rows at a time;
//   3. x += U v, the first half of v's chunks by warps 0-1 into their
//      registers, the second by warps 2-3 into a buffer, then added.
// Conflicts left: the triangle reads of step 1 hit two banks in four
// lanes' worth of a row quad on average.  The staging is what bounds the
// kernel on the H100: two blocks an SM keep too little of it in flight
// (PERF.md section 6).
#include <cuda_runtime.h>

#include <algorithm>

#include "async_copy.cuh"
#include "kernel_epilogue.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int KG = 8;  // right-hand-side columns a group (two halves of 4)
constexpr int kMaxRows = 512;  // the largest leaf (MQ = 4), and of r: 256
constexpr int kMaxRank = 256;

struct Args {
  const void* linv;
  const void* u;
  const void* sig;
  const void* b;
  void* x;
  void* c;
  int n0, r, k, sig_shift;
  int lw, uw, sw;  // 16: 16-byte copies / loads of Linv, U, Sig rows
  int ldu;         // staged U row stride (elements; ldu / 4 odd)
  int lsize;       // staged triangle (elements)
};

// Chunk offset of quad m (rows 4m .. 4m + 3) of the staged triangle: its
// rows hold m + 1 chunks of 4 elements each, stored chunk by chunk (chunk
// c of rows 4m .. 4m + 3 at 4c .. 4c + 3), and the quad starts at a chunk
// congruent to m mod 8 (at most 5 chunks of padding).
__device__ __forceinline__ int quad_off(int m) {
  return 2 * m * (m + 1) + 5 * ((m + 1) >> 1) + (m >> 1);
}

// Element offset of chunk c of row i of the staged triangle.
__device__ __forceinline__ int tri_chunk(int i, int c) {
  return 4 * (quad_off(i >> 2) + 4 * c + (i & 3));
}

__device__ __forceinline__ void ld4s(const float* p, float v[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void ld4s(const double* p, double v[4]) {
  const double2 f = reinterpret_cast<const double2*>(p)[0];
  const double2 g = reinterpret_cast<const double2*>(p)[1];
  v[0] = f.x; v[1] = f.y; v[2] = g.x; v[3] = g.y;
}

// Four elements j0 .. j0 + 3 of a row in device memory, zero at j >= n;
// 16-byte loads where `vec` (row and j0 aligned) and all four are in.
__device__ __forceinline__ void ld4g(const float* row, int j0, int n,
                                     bool vec, float v[4]) {
  if (vec && j0 + 4 <= n) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(row + j0));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = j0 + e < n ? __ldg(row + j0 + e) : 0.f;
  }
}
__device__ __forceinline__ void ld4g(const double* row, int j0, int n,
                                     bool vec, double v[4]) {
  if (vec && j0 + 4 <= n) {
    const double2 f = __ldg(reinterpret_cast<const double2*>(row + j0));
    const double2 g = __ldg(reinterpret_cast<const double2*>(row + j0) + 1);
    v[0] = f.x; v[1] = f.y; v[2] = g.x; v[3] = g.y;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = j0 + e < n ? __ldg(row + j0 + e) : 0.0;
  }
}

// Four elements from an aligned address in device memory.
__device__ __forceinline__ void ld4s_g(const float* p, float v[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void ld4s_g(const double* p, double v[4]) {
  const double2 f = __ldg(reinterpret_cast<const double2*>(p));
  const double2 g = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = f.x; v[1] = f.y; v[2] = g.x; v[3] = g.y;
}

// A chunk (4 elements from `j0`) of a row into shared memory: n of them
// valid (0 to 4), the rest zero-filled.  Whole 16-byte pieces where `wide`
// (the row and j0 16-byte aligned), else one element a copy.
template <typename T>
__device__ __forceinline__ void copy4(T* dst, const T* row, int j0, int n,
                                      bool wide) {
  if (wide) {
    constexpr int per = 16 / sizeof(T);  // elements a piece
#pragma unroll
    for (int h = 0; h < 4 / per; ++h) {
      const int valid = min(max(n - h * per, 0), per);
      acopy::bytes16_n(dst + h * per, valid ? row + j0 + h * per : row,
                       valid * static_cast<int>(sizeof(T)));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acopy::element(dst + e, e < n ? row + j0 + e : row, e < n);
  }
}

// acc[e][q] += l[f] * r[f][q]: a 4 x 4 register tile from a chunk of 4
// reduction entries of each of 4 rows (`rows[e][f]`) and 4 rows of 4
// right-hand sides (`rhs[f][q]`)
template <typename T>
__device__ __forceinline__ void tile44(T acc[4][4], const T rows[4][4],
                                       const T rhs[4][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[e][q] += rows[e][f] * rhs[f][q];
}

// v = Sig c for the row quads lane, lane + 32, ... of Sig (rows past r
// zero) and right-hand sides h4 .. h4 + 3: Sig read from device memory,
// 16 / sizeof(T) chunks of each of the quad's rows in flight at once; with
// VEC (r a multiple of 4, rows 16-byte aligned) 16-byte loads of clamped
// rows, no masks.
template <typename T, bool VEC>
__device__ __forceinline__ void sig_times(const T* Sg, const T* C, T* V,
                                          int r, int cu, int lane, int h4) {
  constexpr int SB = 16 / sizeof(T);
  for (int m = lane; m < cu; m += 32) {
    T acc[4][4] = {};
    const T* rows[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      rows[e] = Sg + static_cast<size_t>(min(4 * m + e, r - 1)) * r;
    for (int jc0 = 0; jc0 < cu; jc0 += SB) {
      T s4[SB][4][4];
#pragma unroll
      for (int u = 0; u < SB; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (VEC) {
            const int j = 4 * min(jc0 + u, cu - 1);
            ld4s_g(rows[e] + j, s4[u][e]);
          } else {
            ld4g(rows[e], 4 * (jc0 + u), r, false, s4[u][e]);
          }
        }
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        if (jc0 + u < cu) {
          T cq[4][4];
#pragma unroll
          for (int f = 0; f < 4; ++f)
            ld4s(C + (4 * (jc0 + u) + f) * KG + h4, cq[f]);
          tile44(acc, s4[u], cq);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        V[(4 * m + e) * KG + h4 + q] = 4 * m + e < r ? acc[e][q] : T(0);
  }
}

// MQ: the 4-row quads of x a lane of warps 0-1 holds in registers, 2 for
// n0 <= 256 and 4 up to kMaxRows (the leaves a model.update grows past
// 256: B3's panel form factors them, or B13 extends them); steps 1 and 2
// of warps 2-3 loop over any r.
template <typename T, bool SL, bool SU, int MQ>
__global__ void __launch_bounds__(kThreads, 1)
leaf_solve_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = a.n0, r = a.r, k = a.k;
  const int nq = (n0 + 3) >> 2;   // 4-row quads of a leaf
  const int cu = (r + 3) >> 2;    // 4-element chunks of a U or Sig row
  const int ld = max(nq, cu) * 4 * KG;  // elements of a buffer
  const size_t p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h4 = 4 * (warp & 1);  // the warp's right-hand sides h4 .. h4 + 3
  const bool role0 = warp < 2;

  const T* Lg = static_cast<const T*>(a.linv) + p * n0 * n0;
  const T* Ug = static_cast<const T*>(a.u) + p * n0 * r;
  const T* Sg = static_cast<const T*>(a.sig) + (p >> a.sig_shift) * r * r;
  const T* Bg = static_cast<const T*>(a.b) + p * n0 * k;
  T* Xg = static_cast<T*>(a.x) + p * n0 * k;
  T* Cg = static_cast<T*>(a.c) + p * r * k;

  T* Ls = reinterpret_cast<T*>(smem_raw);
  T* Us = Ls + (SL ? a.lsize : 0);
  T* A = Us + (SU ? static_cast<size_t>(4 * nq) * a.ldu : 0);  // b, then v
  T* B = A + ld;                                                // t
  T* C = B + ld;                                 // c, then half of U v

  // the parent's Sig into L2 while the block stages (step 2 reads it)
  for (size_t o = static_cast<size_t>(tid) * 128; o < sizeof(T) * r * r;
       o += kThreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        reinterpret_cast<const char*>(Sg) + o));

  // Linv's triangle and U, once (a warp a row at a time, lanes over its
  // chunks; rows past n0 zero, so the loops below need no guards); U's
  // row i = 4 m + e is
  // stored at row e nq + m, so lanes that read rows 4 m + e of
  // neighbouring m read neighbouring stored rows
  if constexpr (SL) {
    for (int i = warp; i < 4 * nq; i += kThreads / 32)
      for (int ch = lane; ch <= (i >> 2); ch += 32)
        copy4(Ls + tri_chunk(i, ch), Lg + static_cast<size_t>(min(i, n0 - 1))
              * n0, 4 * ch, i < n0 ? min(4, i + 1 - 4 * ch) : 0, a.lw == 16);
  }
  if constexpr (SU) {
    for (int i = warp; i < 4 * nq; i += kThreads / 32)
      for (int ch = lane; ch < cu; ch += 32)
        copy4(Us + static_cast<size_t>((i & 3) * nq + (i >> 2)) * a.ldu +
                  4 * ch,
              Ug + static_cast<size_t>(min(i, n0 - 1)) * r, 4 * ch,
              i < n0 ? min(4, r - 4 * ch) : 0, a.uw == 16);
  }

  // Linv[i][4ch .. 4ch + 3] and U[i][4ch .. 4ch + 3], i < 4 nq (zero past
  // n0, past the diagonal and past r)
  auto L4 = [&](int i, int ch, T v[4]) {
    if constexpr (SL) {
      ld4s(Ls + tri_chunk(i, ch), v);
    } else {
      ld4g(Lg + static_cast<size_t>(min(i, n0 - 1)) * n0, 4 * ch,
           i < n0 ? i + 1 : 0, false, v);
    }
  };
  auto U4 = [&](int i, int ch, T v[4]) {
    if constexpr (SU) {
      ld4s(Us + static_cast<size_t>((i & 3) * nq + (i >> 2)) * a.ldu + 4 * ch,
           v);
    } else {
      ld4g(Ug + static_cast<size_t>(min(i, n0 - 1)) * r, 4 * ch,
           i < n0 ? r : 0, a.uw == 16, v);
    }
  };

  for (int g0 = 0; g0 < k; g0 += KG) {
    // b's group into A (rows past n0 and columns past k zero)
    for (int e = tid; e < ld; e += kThreads) {
      const int i = e / KG, q = e % KG;
      const bool valid = i < n0 && g0 + q < k;
      acopy::element(A + e, valid ? Bg + static_cast<size_t>(i) * k + g0 + q
                                  : Bg, valid);
    }
    acopy::commit();
    acopy::wait<0>();
    __syncthreads();

    // ---- step 1: t = Linv b (warps 0-1: a lane a quad of rows, its chunks
    // below the diagonal only) | c = U^T b (warps 2-3: a lane a quad of U's
    // columns); a thread a 4 x 4 tile, its warp's half of the columns ----
    if (role0) {
      for (int m = lane; m < nq; m += 32) {
        T acc[4][4] = {};
        for (int ch = 0; ch <= m; ++ch) {
          T l[4][4], bq[4][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            L4(4 * m + e, ch, l[e]);
            ld4s(A + (4 * ch + e) * KG + h4, bq[e]);
          }
          tile44(acc, l, bq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q) B[(4 * m + e) * KG + h4 + q] = acc[e][q];
      }
    } else {
      for (int jq = lane; jq < cu; jq += 32) {
        T acc[4][4] = {};
        for (int i = 0; i < n0; ++i) {
          T uq[4], bq[4];
          U4(i, jq, uq);
          ld4s(A + i * KG + h4, bq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[e][q] += uq[e] * bq[q];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * jq + e;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            C[j * KG + h4 + q] = acc[e][q];
            const int col = g0 + h4 + q;
            if (j < r && col < k)
              Cg[static_cast<size_t>(j) * k + col] = acc[e][q];
          }
        }
      }
    }
    __syncthreads();

    // ---- step 2: x = Linv^T t (warps 0-1: a lane a quad of Linv's
    // columns, the rows at and below it; in a quad of rows lane b starts
    // at row (b + s) mod 4, so neighbouring lanes hit distinct banks; kept
    // in registers) | v = Sig c into A (warps 2-3: a lane a quad of Sig's
    // rows, read from device memory, SB chunks in flight) ----
    T xq[MQ][4][4] = {};
    if (role0) {
#pragma unroll
      for (int mq = 0; mq < MQ; ++mq) {
        const int b = lane + 32 * mq;
        for (int qa = b; qa < nq; ++qa) {
          T l[4][4], tq[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int i = 4 * qa + ((b + s) & 3);
            L4(i, b, l[s]);
            ld4s(B + i * KG + h4, tq[s]);
          }
#pragma unroll
          for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int q = 0; q < 4; ++q) xq[mq][e][q] += l[s][e] * tq[s][q];
        }
      }
    } else {
      if (a.sw == 16 && r % 4 == 0)
        sig_times<T, true>(Sg, C, A, r, cu, lane, h4);
      else
        sig_times<T, false>(Sg, C, A, r, cu, lane, h4);
    }
    __syncthreads();

    // ---- step 3: x += U v for the rows and columns warps 0-1 hold, their
    // first half of v's chunks; warps 2-3 the second half, into C ----
    {
      const int half = (cu + 1) >> 1;
      const int j0 = role0 ? 0 : half, j1 = role0 ? half : cu;
#pragma unroll
      for (int mq = 0; mq < MQ; ++mq) {
        const int b = lane + 32 * mq;
        if (b < nq) {
          T acc[4][4] = {};
          for (int jc = j0; jc < j1; ++jc) {
            T uq[4][4], vq[4][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ld4s(A + (4 * jc + e) * KG + h4, vq[e]);
              U4(4 * b + e, jc, uq[e]);
            }
            // MQ 4: warps 2-3 sum into their own (zero) xq, so that no
            // second tile is live beside the four quads (float64 spilled)
            if (role0 || MQ > 2)
              tile44(xq[mq], uq, vq);
            else
              tile44(acc, uq, vq);
          }
          if (!role0) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                C[(4 * b + e) * KG + h4 + q] =
                    MQ > 2 ? xq[mq][e][q] : acc[e][q];
          }
        }
      }
    }
    __syncthreads();
    if (role0) {
#pragma unroll
      for (int mq = 0; mq < MQ; ++mq) {
        const int b = lane + 32 * mq;
        if (b < nq) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * b + e;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int col = g0 + h4 + q;
              if (j < n0 && col < k)
                Xg[static_cast<size_t>(j) * k + col] =
                    xq[mq][e][q] + C[j * KG + h4 + q];
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool SL, bool SU, int MQ>
int launch_kernel(const Args& a, int p, size_t smem, cudaStream_t stream) {
  const auto kernel = leaf_solve_kernel<T, SL, SU, MQ>;
  int err = launch_with_smem(kernel, smem);
  if (err) return err;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
  if (err) return err;
  kernel<<<p, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MQ>
int launch_staged(const Args& a, int p, int stage_l, int stage_u, size_t smem,
                  cudaStream_t st) {
  if (stage_l)
    return stage_u ? launch_kernel<T, true, true, MQ>(a, p, smem, st)
                   : launch_kernel<T, true, false, MQ>(a, p, smem, st);
  return stage_u ? launch_kernel<T, false, true, MQ>(a, p, smem, st)
                 : launch_kernel<T, false, false, MQ>(a, p, smem, st);
}

template <typename T>
int launch(const void* linv, const void* u, const void* sig, const void* b,
           void* x, void* c, int p, int n0, int r, int k, int sig_shift,
           int stage_l, int stage_u, int lw, int uw, int sw, int ldu,
           int lsize, void* stream) {
  if (p == 0 || k == 0) return 0;
  if (n0 < 1 || r < 1 || n0 > kMaxRows || r > kMaxRank || ldu < r)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{linv, u, sig, b, x, c, n0, r, k, sig_shift, lw, uw, sw, ldu,
               lsize};
  const int nq = (n0 + 3) / 4, cu = (r + 3) / 4;
  const size_t smem =
      (static_cast<size_t>(stage_l ? lsize : 0) +
       (stage_u ? static_cast<size_t>(4 * nq) * ldu : 0) +
       static_cast<size_t>(3 * std::max(nq, cu) * 4) * KG) * sizeof(T);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n0 > 4 * 32 * 2)
    return launch_staged<T, 4>(a, p, stage_l, stage_u, smem, st);
  return launch_staged<T, 2>(a, p, stage_l, stage_u, smem, st);
}

}  // namespace

extern "C" int leaf_solve_f32(const void* linv, const void* u,
                              const void* sig, const void* b, void* x,
                              void* c, int p, int n0, int r, int k,
                              int sig_shift, int stage_l, int stage_u, int lw,
                              int uw, int sw, int ldu, int lsize,
                              void* stream) {
  return launch<float>(linv, u, sig, b, x, c, p, n0, r, k, sig_shift,
                       stage_l, stage_u, lw, uw, sw, ldu, lsize, stream);
}

extern "C" int leaf_solve_f64(const void* linv, const void* u,
                              const void* sig, const void* b, void* x,
                              void* c, int p, int n0, int r, int k,
                              int sig_shift, int stage_l, int stage_u, int lw,
                              int uw, int sw, int ldu, int lsize,
                              void* stream) {
  return launch<double>(linv, u, sig, b, x, c, p, n0, r, k, sig_shift,
                        stage_l, stage_u, lw, uw, sw, ldu, lsize, stream);
}

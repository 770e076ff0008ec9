// The blocked Cholesky factorization of one SPD tile held in shared
// memory by 128 threads of a block, in panels of NB = 32 columns (the last
// one ragged): the factor of the leaf_factor kernel (leaf_factor.cu, B3),
// shared with the grouped gram_chol kernels (build_stage.cu, B1;
// build_dist.cu, B8) and with leaf_update.cu (B13), whose blocks of 256
// threads run it on their first 128; its steps 1 and 2 also factor each
// panel of chol_panel.cuh, the form for tiles held in device memory.
//   1. warp 0 factors the 32 x 32 diagonal block in registers, lane i
//      holding row i: each pivot's square root and reciprocal (stored),
//      the column scaled by it and passed to every lane through a small
//      shared buffer (no block barrier); the next pivot is computed while
//      the column is in flight;
//   2. all threads compute the panel below, L21 = A21 L11^-T, by forward
//      substitution on each row (not by a product with an inverse, which
//      would lose the componentwise backward-error bound);
//   3. all threads apply A22 -= L21 L21^T to the lower triangle only, in
//      register tiles.
// A thread owns 4 rows x 4 columns of a 32-column panel (rows rg + 16 i,
// columns cg + 8 j); the 8 lanes of a row group pass each solved column by
// __shfl_sync.  Three barriers per panel, a dependent chain of O(n)
// steps.  The step loops stay loops (the fully unrolled panels do not fit
// the instruction cache).  Only the lower triangle of the tile is read
// and written; no pivot is clamped, so a tile that is not positive
// definite gives NaN.  Shared memory: the (n, lda) tile, n reciprocal
// pivots and a column buffer of NB values (col_offset).
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float chol_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double chol_sqrt(double v) { return sqrt(v); }

namespace chol_blocked {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 8;     // row groups of 8 lanes
constexpr int NB = 32;                     // panel width
constexpr int kDiagGroup = 8;              // diagonal-factor steps a trip
constexpr int kPassRows = 4 * kGroups;    // rows of one register pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// 32 values of the column buffer, 16 bytes a load (every lane reads the
// same addresses: broadcasts).
__device__ __forceinline__ void load_col(float (&cb)[NB], const float* col) {
#pragma unroll
  for (int q = 0; q < NB / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(col)[q];
    cb[4 * q] = f.x;
    cb[4 * q + 1] = f.y;
    cb[4 * q + 2] = f.z;
    cb[4 * q + 3] = f.w;
  }
}

__device__ __forceinline__ void load_col(double (&cb)[NB],
                                         const double* col) {
#pragma unroll
  for (int q = 0; q < NB / 2; ++q) {
    const double2 f = reinterpret_cast<const double2*>(col)[q];
    cb[2 * q] = f.x;
    cb[2 * q + 1] = f.y;
  }
}
// Step 1: warp 0 factors the diagonal block at (kb, kb), w <= NB wide,
// lane i holding row kb + i in registers; v[t] is its entry in column
// kDiagGroup g + t during the g-th group of steps (the row shifts down by
// kDiagGroup columns a group, so the loop over groups stays a loop and its
// code small).  Column j: l_jj = sqrt(a_jj) and l_ij = a_ij (1 / l_jj);
// lane i puts l_ij in slot i - j of the shared column buffer ``col``
// (lanes at or above j put zeros in the slots they map to), and every
// lane reads the buffer back 16 bytes a load and takes a_ic -= l_ij l_cj
// for all c > j.  Entries above the diagonal take these updates too but
// are never read or stored.  The next pivot comes ahead of that broadcast:
// lane j + 1 takes a_(j+1)(j+1) - l_(j+1)j^2 from its own l_(j+1)j (the
// same fused multiply-add the broadcast would give it), and its square
// root and reciprocal run while the column goes through shared memory.
// Writes L11 (lower triangle) column by column and rdiag[kb + i] =
// 1 / L_ii.
template <typename T>
__device__ __forceinline__ void factor_diag(T* a, int lda, T* rdiag, T* col,
                                            int kb, int w, int lane) {
  T v[NB];
  const bool live = lane < w;
  T* row = a + (kb + min(lane, w - 1)) * lda + kb;
#pragma unroll
  for (int c = 0; c < NB; ++c) v[c] = (live && c < w) ? row[c] : T(0);
  T rd = T(0);
  T piv = chol_sqrt(__shfl_sync(kFull, v[0], 0));
  T rp = T(1) / piv;
#pragma unroll 1
  for (int g = 0; kDiagGroup * g < w; ++g) {
#pragma unroll
    for (int s = 0; s < kDiagGroup; ++s) {
      const int j = kDiagGroup * g + s;
      if (j >= w) break;
      const T lj = lane > j ? v[s] * rp : (lane == j ? piv : T(0));
      if (lane == j) rd = rp;
      const T piv_next = chol_sqrt(__shfl_sync(
          kFull, fmadd(-lj, lj, v[s + 1]), (j + 1) & (NB - 1)));
      if (live && lane >= j) row[j] = lj;
      col[(lane - j) & (NB - 1)] = lane > j ? lj : T(0);
      __syncwarp();
      T cb[NB];
      load_col(cb, col);
      rp = T(1) / piv_next;
      piv = piv_next;
#pragma unroll
      for (int t = s + 1; t < NB; ++t) v[t] = fmadd(-lj, cb[t - s], v[t]);
      __syncwarp();                   // read before the next step writes
    }
#pragma unroll
    for (int t = 0; t < NB - kDiagGroup; ++t) v[t] = v[t + kDiagGroup];
#pragma unroll
    for (int t = NB - kDiagGroup; t < NB; ++t) v[t] = T(0);
  }
  if (live) rdiag[kb + lane] = rd;
}

// Step 2 on rows p0 + rg + 16 i (i < NII): y L11^T = a for the row's panel
// entries, column by column; the owner of column j (lane cg = j % 8 of the
// row group) passes y_j = a_j / L_jj to its 7 neighbours, which subtract
// y_j L_kj from their columns k > j.
template <int NII, typename T>
__device__ __forceinline__ void forward_pass(T* a, int lda, const T* rdiag,
                                             int kb, int w, int p0, int n0) {
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  const int src0 = (tid & 31) & ~7;
  T y[NII][4];
  int rows[NII];
#pragma unroll
  for (int i = 0; i < NII; ++i) {
    rows[i] = p0 + rg + kGroups * i;
    const T* r = a + min(rows[i], n0 - 1) * lda + kb;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      y[i][jj] = (cg + 8 * jj < w) ? r[cg + 8 * jj] : T(0);
  }
#pragma unroll
  for (int jo = 0; jo < 4; ++jo) {       // column j = 8 jo + j8
#pragma unroll 1
    for (int j8 = 0; j8 < 8; ++j8) {
      const int j = 8 * jo + j8;
      if (j >= w) break;
      const T rj = rdiag[kb + j];
      T lkj[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int k = cg + 8 * jj;
        lkj[jj] = (k > j && k < w) ? a[(kb + k) * lda + kb + j] : T(0);
      }
#pragma unroll
      for (int i = 0; i < NII; ++i) {
        const T yj = __shfl_sync(kFull, y[i][jo], src0 + j8) * rj;
        if (cg == j8) y[i][jo] = yj;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (cg + 8 * jj > j) y[i][jj] = fmadd(-yj, lkj[jj], y[i][jj]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NII; ++i) {
    if (rows[i] >= n0) continue;
    T* r = a + rows[i] * lda + kb;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (cg + 8 * jj < w) r[cg + 8 * jj] = y[i][jj];
  }
}

// Step 3 on rows p0 + rg + 16 i (i < NII) and columns cb + cg + 8 j:
// a[r][c] -= sum_k a[r][kb + k] a[c][kb + k] for c <= r.
template <int NII, typename T>
__device__ __forceinline__ void update_pass(T* a, int lda, int kb, int w,
                                            int cb, int p0, int n0) {
  const int tid = threadIdx.x, cg = tid & 7, rg = tid >> 3;
  int rows[NII], cols[4], pr[NII], pc[4];  // pr, pc: offsets into a
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    cols[jj] = cb + cg + 8 * jj;
    pc[jj] = min(cols[jj], n0 - 1) * lda + kb;
  }
  T acc[NII][4];
#pragma unroll
  for (int i = 0; i < NII; ++i) {
    rows[i] = p0 + rg + kGroups * i;
    const int r = min(rows[i], n0 - 1);
    pr[i] = r * lda + kb;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      acc[i][jj] = a[r * lda + min(cols[jj], n0 - 1)];
  }
#pragma unroll 4
  for (int k = 0; k < w; ++k) {
    T lc[4], li[NII];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) lc[jj] = a[pc[jj] + k];
#pragma unroll
    for (int i = 0; i < NII; ++i) li[i] = a[pr[i] + k];
#pragma unroll
    for (int i = 0; i < NII; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        acc[i][jj] = fmadd(-li[i], lc[jj], acc[i][jj]);
  }
#pragma unroll
  for (int i = 0; i < NII; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (rows[i] < n0 && cols[jj] <= rows[i])
        a[rows[i] * lda + cols[jj]] = acc[i][jj];
}

// Byte offset of the kernel's column buffer (NB values, 16-byte
// aligned) after the tile and the reciprocal pivots; the buffer ends its
// shared memory.
__host__ __device__ constexpr size_t col_offset(int n0, int lda,
                                                size_t item) {
  return ((static_cast<size_t>(n0) * lda + n0) * item + 15) / 16 * 16;
}

// Runs pass ``Pass<NII>`` with NII = the rows of each thread that rows
// [p0, n0) need (kGroups rows each), at most 4 (the same for every
// thread).
#define LEAF_PASS(pass, p0, n0, ...)                                  \
  do {                                                                \
    switch (min(4, ((n0) - (p0) + kGroups - 1) / kGroups)) {          \
      case 1: pass<1>(__VA_ARGS__); break;                            \
      case 2: pass<2>(__VA_ARGS__); break;                            \
      case 3: pass<3>(__VA_ARGS__); break;                            \
      default: pass<4>(__VA_ARGS__); break;                           \
    }                                                                 \
  } while (0)

// Steps 1-3 over every panel of the (n0, lda) tile ``a``: on return its
// lower triangle holds L and rdiag[i] = 1 / L_ii.  Every thread of the
// block calls it, after a barrier that follows the tile's staging (threads
// past the first kThreads only meet the barriers); it synchronises after
// each panel, so on return every thread sees L.
template <typename T>
__device__ __forceinline__ void factor_panels(T* a, int lda, T* rdiag,
                                              T* col, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool mine = threadIdx.x < kThreads;
  for (int kb = 0; kb < n0; kb += NB) {
    const int w = min(NB, n0 - kb);
    if (warp == 0) factor_diag(a, lda, rdiag, col, kb, w, lane);
    __syncthreads();                  // L11 and its pivots are final
    const int below = kb + w;
    if (below >= n0) break;
    if (mine)
      for (int p0 = below; p0 < n0; p0 += kPassRows)
        LEAF_PASS(forward_pass, p0, n0, a, lda, rdiag, kb, w, p0, n0);
    __syncthreads();                  // L21 is final
    if (mine)
      for (int cb = below; cb < n0; cb += NB)
        for (int p0 = cb; p0 < n0; p0 += kPassRows)
          LEAF_PASS(update_pass, p0, n0, a, lda, kb, w, cb, p0, n0);
    __syncthreads();                  // A22 is updated
  }
}

}  // namespace chol_blocked

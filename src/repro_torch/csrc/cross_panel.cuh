// The panel form of the cross products U = K Linv^T Linv for ranks past
// the resident forms' 128, up to kMaxRank = 256: the products of B2's
// cross_solve_levels_panel (build_stage.cu, K from the distances it
// computes) and B9's cross_solve_dist_levels_panel (build_dist.cu, K from
// cached distances).  Their callers put a row tile of K in shared memory
// (zero past m and past r) and call products() (float32) or
// f64::products() (float64).
//
// Why the resident forms stop at r 128: cross_tc.cuh keeps Y = K Linv^T
// of a warp's 16-row strip in registers (r / 8 tiles of 4 a lane, beside
// U's) and the node's whole Linv in shared memory, 256 KB in float32 at r
// 256; cross_products.cuh keeps Linv whole too (526 KB in float64).  Here
// neither is held:
//   * Y is formed in shared memory, over K: Y's column s needs K's
//     columns t <= s only, so Y's tiles are formed from the last to the
//     first and each is written over K's tile of the same columns once
//     no later tile needs it;
//   * U = Y Linv is formed in column panels of at most kPanel = 128 (16
//     tiles of 8: 64 registers a lane in float32), Y read back from
//     shared memory;
//   * Linv is streamed through shared memory in slabs of rows, each read
//     by every warp: for Y, 16 rows s (two 8-column tiles of Y), their
//     columns t <= s; for U, 16 rows s (two k-steps) of the panel's
//     columns.  float32 stages the next slabs with cp.async while this one
//     is used (two Y slabs, three U slabs in flight).
// Linv must be lower triangular: float32 skips its 8 x 8 blocks above the
// diagonal (it reads the diagonal blocks whole), as cross_tc.cuh does,
// and float64 its 16-row slabs' columns past their last row and, for a U
// panel, the rows above the panel.  Slabs are a runtime loop (each ends
// in a barrier), so the register tiles are indexed by constants and the
// triangle is a guard on each product within a U panel's diagonal block
// (uniform across the warp), none below it: a loop unrolled over slabs,
// as cross_tc.cuh unrolls its k-steps, did not unroll around the
// barriers, and its tiles, indexed at run time, went to local memory.
//
// float32 (split TF32 on mma.sync.m16n8k8, tf32x3.cuh's three passes, as
// cross_tc.cuh): 128 threads, a row tile of BM = 64 rows, a warp a strip
// of 16.  Y's slab reads fragments B(k = t, n = s) = Linv[s][t] at row
// stride LY = 4 mod 32 and U's slab B(k = s, n = c) = Linv[s][c] at LU = 8
// mod 32, so both fall on 32 distinct banks; K and Y at LDK = 4 mod 32.
// Y's two tiles of a slab accumulate in four chains (two a tile, k-steps
// by parity) so that the dependent passes of one chain overlap the
// others'.  Shared memory: K/Y 64 x 260 and two Y slabs of 16 x 260
// floats (or three U slabs of 16 x 136), 99,840 bytes: two blocks an SM.
//
// float64 (CUDA cores, as cross_products.cuh): 256 threads, a row tile of
// 32 rows, a thread 2 rows x 8 columns of a U panel (or 2 entries of a Y
// slab); slabs staged by the threads, one buffer.  Shared memory: K/Y 32 x
// 257 and one Y slab of 16 x 257 doubles, 98,688 bytes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "cross_tc.cuh"
#include "tf32x3.cuh"

namespace cross_panel {

constexpr int kMaxRank = 256;
constexpr int kPanel = 128;            // columns of a U panel
constexpr int PT = kPanel / 8;         // its 8-column tiles

// The second U panel's 8-column tiles at rank r (128 < r <= 256): a
// multiple of 4 (the instances 4, 8, 12, 16); Linv and K are zero past r.
__host__ __device__ constexpr int tiles2(int r) {
  return 4 * ((r - kPanel + 31) / 32);
}

// ---------------------------------------------------------------------------
// float32: split TF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 16 * kWarps;        // rows of a tile: the warps' strips
constexpr int LDK = 2 * kPanel + 4;    // K / Y row stride (4 mod 32)
constexpr int YS = 16;                 // Linv rows of a Y slab
constexpr int LY = 2 * kPanel + 4;     // a Y slab's row stride (4 mod 32)
constexpr int US = 16;                 // Linv rows of a U slab: 2 k-steps
constexpr int LU = kPanel + 8;         // a U slab's row stride (8 mod 32)
constexpr int UDEPTH = 3;              // U slabs in flight

// Floats of the K / Y tile and of the slab ring (two Y slabs, which also
// hold three U slabs); the caller may use the ring's space before
// products() (B2 stages its distances there).
constexpr int KY_FLOATS = BM * LDK;
constexpr int RING_FLOATS = 2 * YS * LY;
static_assert(UDEPTH * US * LU <= RING_FLOATS, "U slabs fit the ring");

__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (KY_FLOATS + RING_FLOATS);
}

// Stage rows s0 .. s0 + ns - 1, columns c0 .. c0 + nc - 1 (c0 and nc
// multiples of 4) of the (r, r) Linv into dst at row stride ld, zero past
// r: cp.async, 16 bytes a copy where ``vec`` (r % 4 == 0, Linv 16-byte
// aligned), else element by element; commits one group.
__device__ __forceinline__ void stage_slab(float* dst, int ld,
                                           const float* __restrict__ L,
                                           int r, int s0, int ns, int c0,
                                           int nc, bool vec) {
  if (vec) {
    const int q4 = nc / 4;
    for (int e = threadIdx.x; e < ns * q4; e += kThreads) {
      const int i = e / q4, c = 4 * (e - i * q4);
      const bool ok = s0 + i < r && c0 + c < r;
      acopy::bytes16(dst + i * ld + c,
                     ok ? L + static_cast<size_t>(s0 + i) * r + c0 + c : L,
                     ok);
    }
  } else {
    for (int e = threadIdx.x; e < ns * nc; e += kThreads) {
      const int i = e / nc, c = e - i * nc;
      const bool ok = s0 + i < r && c0 + c < r;
      acopy::element(dst + i * ld + c,
                     ok ? L + static_cast<size_t>(s0 + i) * r + c0 + c : L,
                     ok);
    }
  }
  acopy::commit();
}

__device__ __forceinline__ void a_frag(const float* p, uint32_t* ah,
                                       uint32_t* al) {
  tf32x3::split(p[0], ah[0], al[0]);
  tf32x3::split(p[8 * LDK], ah[1], al[1]);
  tf32x3::split(p[4], ah[2], al[2]);
  tf32x3::split(p[8 * LDK + 4], ah[3], al[3]);
}

// Two k-steps kk, kk + 1 of Y's two tiles of a slab (see y_pair): chains
// acc[2 h + u] for tile h and step kk + u, the three passes of the four
// chains interleaved; kLast leaves out the first tile's step kk + 1 (its
// k-steps end at its own diagonal block).
template <bool kLast>
__device__ __forceinline__ void y_steps(float (&acc)[4][4], const float* kr,
                                        const float* b0, const float* b1,
                                        int kk, int t) {
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int k8 = 8 * (kk + u);
    a_frag(kr + k8 + t, ah[u], al[u]);
    tf32x3::split(b0[k8], bh[u][0], bl[u][0]);
    tf32x3::split(b0[k8 + 4], bh[u][1], bl[u][1]);
    tf32x3::split(b1[k8], bh[2 + u][0], bl[2 + u][0]);
    tf32x3::split(b1[k8 + 4], bh[2 + u][1], bl[2 + u][1]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (!kLast || c != 1) tf32x3::mma(acc[c], al[c & 1], bh[c]);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (!kLast || c != 1) tf32x3::mma(acc[c], ah[c & 1], bl[c]);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (!kLast || c != 1) tf32x3::mma(acc[c], ah[c & 1], bh[c]);
}

// Y tiles 2 jp and 2 jp + 1 of a warp's strip (kr: row g of the strip in
// the K / Y tile) from the slab of Linv's rows 16 jp .. 16 jp + 15:
// Y[i][s] = sum_{t <= s} K[i][t] Linv[s][t] over K's tiles 0 .. 2 jp (+ 1
// for the second tile), in four chains (two a tile, k-steps by parity);
// then both written over K's tiles 2 jp and 2 jp + 1.
__device__ __forceinline__ void y_pair(float* kr, const float* slab, int jp,
                                       int g, int t) {
  float acc[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const float* b0 = slab + g * LY + t;         // tile 2 jp: slab row g
  const float* b1 = slab + (8 + g) * LY + t;   // tile 2 jp + 1: row 8 + g
  for (int kk = 0; kk < 2 * jp; kk += 2)
    y_steps<false>(acc, kr, b0, b1, kk, t);
  y_steps<true>(acc, kr, b0, b1, 2 * jp, t);
  __syncwarp();                          // every lane's reads of K are done
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* o = kr + 8 * (2 * jp + h) + 2 * t;
    const float* a = acc[2 * h];
    const float* b = acc[2 * h + 1];
    *reinterpret_cast<float2*>(o) = make_float2(a[0] + b[0], a[1] + b[1]);
    *reinterpret_cast<float2*>(o + 8 * LDK) =
        make_float2(a[2] + b[2], a[3] + b[3]);
  }
  __syncwarp();
}

// acc[jl] += Y[:, 8 ks .. 8 ks + 7] Linv[8 ks .., panel tile jl] for the
// tiles jl <= jmax, from Linv's rows 8 ks .. 8 ks + 7 (the panel's
// columns) at ``slab``: groups of tc::kGroup tiles, the three passes of a
// group interleaved (tc::mma_group's order).  The register tiles are
// indexed by constants only; jmax is a guard, uniform across the warp
// (NTP - 1 below the panel's diagonal block, where it folds away).
template <int NTP>
__device__ __forceinline__ void u_slab(float (&acc)[NTP][4], const float* kr,
                                       const float* slab, int ks, int jmax,
                                       int g, int t) {
  constexpr int G = tc::kGroup;
  uint32_t ah[4], al[4];
  a_frag(kr + 8 * ks + t, ah, al);
  const float* lp = slab + t * LU + g;
#pragma unroll
  for (int q = 0; q < NTP / G; ++q) {
    if (G * q > jmax) break;
    uint32_t bh[G][2], bl[G][2];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      tf32x3::split(lp[8 * (G * q + i)], bh[i][0], bl[i][0]);
      tf32x3::split(lp[8 * (G * q + i) + 4 * LU], bh[i][1], bl[i][1]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (G * q + i <= jmax) tf32x3::mma(acc[G * q + i], al, bh[i]);
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (G * q + i <= jmax) tf32x3::mma(acc[G * q + i], ah, bl[i]);
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (G * q + i <= jmax) tf32x3::mma(acc[G * q + i], ah, bh[i]);
  }
}

// U panel q (columns 128 q .. 128 q + 8 NTP) of a warp's strip: Linv's
// rows from 128 q on, in slabs of two k-steps (k-step ks feeds the panel's
// tiles jl <= ks - 16 q: Linv is zero above its diagonal), UDEPTH slabs in
// flight; stored to U (the tile's first row, row stride r) for rows below
// ``rows`` and columns below r.  Every thread calls it (``live``: the
// warp's strip has rows); it ends in a barrier.
template <int NTP>
__device__ __forceinline__ void u_panel(const float* kr, float* ring,
                                        const float* __restrict__ L, int r,
                                        bool vec, int q, int ntr, bool live,
                                        float* __restrict__ U, int rows,
                                        int srow, int g, int t) {
  const int ks0 = PT * q, c0 = kPanel * q, nslab = (ntr - ks0) / 2;
  auto buf = [&](int i) { return ring + (i % UDEPTH) * US * LU; };
  // slab i: Linv's rows 8 (ks0 + 2 i) .., the tiles its triangle reaches
  // (one group of copies a slab, an empty one past the last)
  auto stage = [&](int i) {
    if (i < nslab)
      stage_slab(buf(i), LU, L, r, 8 * (ks0 + 2 * i), US, c0,
                 8 * min(NTP, 2 * i + 2), vec);
    else
      acopy::commit();
  };
  float acc[NTP][4];
#pragma unroll
  for (int j = 0; j < NTP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int i = 0; i < UDEPTH - 1; ++i) stage(i);
#pragma unroll 1
  for (int i = 0; i < nslab; ++i) {
    stage(i + UDEPTH - 1);
    acopy::wait<UDEPTH - 1>();           // slab i has landed
    __syncthreads();
    if (live) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        u_slab<NTP>(acc, kr, buf(i) + 8 * h * LU, ks0 + 2 * i + h,
                    min(2 * i + h, NTP - 1), g, t);
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int jl = 0; jl < NTP; ++jl) {
    const int col = c0 + 8 * jl + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = srow + 8 * h;
      if (row >= rows || col >= r) continue;
      float* o = U + static_cast<size_t>(row) * r + col;
      if (r % 2 == 0) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[jl][2 * h], acc[jl][2 * h + 1]);
      } else {
        o[0] = acc[jl][2 * h];
        if (col + 1 < r) o[1] = acc[jl][2 * h + 1];
      }
    }
  }
}

// U (the tile's ``rows`` rows of a node's row-major (m, r) U, from its
// first) = K Linv^T Linv for a row tile of K in ky (BM x LDK, zero past
// the tile's rows and past r up to 128 + 8 NT1), Linv the node's (r, r)
// lower-triangular matrix in device memory, 128 < r <= 8 (16 + NT1).
// Every thread calls it after a barrier that follows K's writes; it ends
// in a barrier (ky and the ring are free again).  Not inlined: B2's caller
// holds its distances' 8 x 8 register tile in the same loop, and inlined
// the two together took all 255 registers and spilled.
template <int NT1>
__device__ __noinline__ void products(float* ky, float* ring,
                                      const float* __restrict__ L, int r,
                                      float* __restrict__ U, int rows) {
  constexpr int NTR = PT + NT1;          // Y's 8-column tiles
  constexpr int NPAIR = NTR / 2;         // Y slabs
  static_assert(NT1 % tc::kGroup == 0 && NT1 <= PT, "NT1");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, srow = 16 * warp + g;
  const bool live = 16 * warp < rows;
  const bool vec = r % 4 == 0 && reinterpret_cast<size_t>(L) % 16 == 0;
  float* kr = ky + srow * LDK;
  auto buf = [&](int i) { return ring + (i & 1) * YS * LY; };
  // Y = K Linv^T, from its last pair of tiles to its first
  stage_slab(buf(0), LY, L, r, YS * (NPAIR - 1), YS, 0, YS * NPAIR, vec);
  for (int i = 0; i < NPAIR; ++i) {
    const int jp = NPAIR - 1 - i;
    if (jp > 0) {
      stage_slab(buf(i + 1), LY, L, r, YS * (jp - 1), YS, 0, YS * jp, vec);
      acopy::wait<1>();
    } else {
      acopy::wait<0>();
    }
    __syncthreads();
    if (live) y_pair(kr, buf(i), jp, g, t);
    __syncthreads();
  }
  // U = Y Linv, panel by panel
  u_panel<PT>(kr, ring, L, r, vec, 0, NTR, live, U, rows, srow, g, t);
  u_panel<NT1>(kr, ring, L, r, vec, 1, NTR, live, U, rows, srow, g, t);
}

// ---------------------------------------------------------------------------
// float64: CUDA cores
// ---------------------------------------------------------------------------

namespace f64 {

constexpr int kThreads = 256;
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int BM = 2 * TY;             // rows of a tile: 2 a thread
constexpr int LDK = 2 * kPanel + 1;    // K / Y row stride
constexpr int YS = 16;                 // Linv rows of a Y slab
constexpr int US = 16;                 // Linv rows of a U slab
constexpr int LU = kPanel + 1;         // a U slab's row stride
constexpr int KY_DOUBLES = BM * LDK;
constexpr int RING_DOUBLES = YS * LDK;  // one Y slab (or one U slab)
static_assert(US * LU <= RING_DOUBLES, "a U slab fits the ring");

__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(double) * (KY_DOUBLES + RING_DOUBLES);
}

// Rows s0 .. s0 + ns - 1, columns c0 .. c0 + nc - 1 of the (r, r) Linv into
// dst at row stride ld, zero past r; the caller's barriers order it.
__device__ __forceinline__ void stage_slab(double* dst, int ld,
                                           const double* __restrict__ L,
                                           int r, int s0, int ns, int c0,
                                           int nc) {
  for (int e = threadIdx.x; e < ns * nc; e += kThreads) {
    const int i = e / nc, c = e - i * nc;
    dst[i * ld + c] = (s0 + i < r && c0 + c < r)
                          ? L[static_cast<size_t>(s0 + i) * r + c0 + c]
                          : 0.0;
  }
}

// U (as products()) in float64: thread (ty, tx) owns rows ty and ty + 16
// of the tile; Y's slab column s = 16 jy + tx, then U's panel columns
// c0 + tx + 16 b.  Every thread calls it after a barrier that follows K's
// writes; it ends in a barrier.
__device__ __forceinline__ void products(double* ky, double* ring,
                                         const double* __restrict__ L,
                                         int r, double* __restrict__ U,
                                         int rows) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int ns = (r + YS - 1) / YS;
  // Y = K Linv^T over K, from the last slab to the first
  for (int jy = ns - 1; jy >= 0; --jy) {
    const int kend = YS * (jy + 1);      // K's columns this slab reaches
    stage_slab(ring, LDK, L, r, YS * jy, YS, 0, kend);
    __syncthreads();
    double y[2] = {0.0, 0.0};
    const double* lr = ring + tx * LDK;
    for (int k = 0; k < kend; ++k) {
      const double l = lr[k];
      y[0] = fma(ky[ty * LDK + k], l, y[0]);
      y[1] = fma(ky[(ty + TY) * LDK + k], l, y[1]);
    }
    __syncthreads();                     // every read of these K columns
    ky[ty * LDK + kend - YS + tx] = y[0];
    ky[(ty + TY) * LDK + kend - YS + tx] = y[1];
  }
  // U = Y Linv, panel by panel, from the panel's first row of Linv on
  for (int c0 = 0; c0 < r; c0 += kPanel) {
    double acc[2][8];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.0;
    for (int s0 = c0; s0 < r; s0 += US) {
      __syncthreads();                   // the slab (or Y's last writes)
      stage_slab(ring, LU, L, r, s0, US, c0, kPanel);
      __syncthreads();
      for (int u = 0; u < US; ++u) {
        const double y0 = ky[ty * LDK + s0 + u];
        const double y1 = ky[(ty + TY) * LDK + s0 + u];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const double l = ring[u * LU + tx + TX * b];
          acc[0][b] = fma(y0, l, acc[0][b]);
          acc[1][b] = fma(y1, l, acc[1][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int row = ty + TY * a, col = c0 + tx + TX * b;
        if (row < rows && col < r)
          U[static_cast<size_t>(row) * r + col] = acc[a][b];
      }
  }
  __syncthreads();
}

}  // namespace f64

}  // namespace cross_panel

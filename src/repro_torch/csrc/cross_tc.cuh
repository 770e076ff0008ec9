// U = K Linv^T Linv on the tensor cores in split TF32 (mma.sync.m16n8k8,
// tf32x3.cuh: hi hi + hi lo + lo hi, float32 accumulation), one warp per
// strip of 16 rows: the products of the grouped float32 kernels
// cross_solve_dist_levels (build_dist.cu, B9: K from cached distances in
// device memory) and cross_solve_levels (build_stage.cu, B2: K from the
// distances it computes into shared memory).  The caller feeds Y = K
// Linv^T one 8-column k-step of K at a time (y_step), then runs U = Y
// Linv (u_product) and stores U (store_u).
//
//   Y = K Linv^T: B = Linv[s][t] from shared memory; tile j of Y's
//   columns takes the k-steps kk <= j only (Linv is zero above its
//   diagonal);
//   U = Y Linv: A = Y's accumulator read as an A fragment ({c0, c2, c1,
//   c3}, split), whose logical column p of each group of 8 is real column
//   KEY_OF[p], so B = Linv's rows 8 ks + 2t and 8 ks + 2t + 1; tile jc of
//   U takes the k-steps ks >= jc only.  Y's tile ks dies after step ks and
//   U's tile jc is born at step jc.
// Linv must be lower triangular: its 8 x 8 blocks above the diagonal are
// never read (the diagonal blocks are read whole).  NT (the 8-column
// tiles, r <= 8 NT) is a template argument, so every loop of both
// products unrolls with the triangle known at compile time: no branch
// between the products (design trials with a runtime guard around each
// product ran markedly slower: every guard ends a basic block, so loads
// and products could not be scheduled across).  A tile's three dependent
// passes interleave over groups of kGroup tiles.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "tf32x3.cuh"

namespace tc {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;          // registers: 3 blocks would spill
constexpr int kMaxTiles = 16;          // r <= 128: 8-column tiles
constexpr int kChunk = 4;              // NT is a multiple of it
constexpr int kGroup = 4;              // output tiles whose passes interleave

// The kernels' 8-column tiles for rank r: a multiple of kChunk (the
// instantiations 4, 8, 12, 16); Linv is zero-padded to them.
__host__ __device__ constexpr int tiles(int r) {
  return kChunk * ((r + 8 * kChunk - 1) / (8 * kChunk));
}

// Shared row stride (floats) of a tile padded to 8 nt columns: 4 mod 32,
// so that fragment reads (rows g, columns t) fall on 32 distinct banks.
__host__ __device__ constexpr int linv_stride(int nt) {
  return 32 * ((8 * nt + 31) / 32) + 4;
}

// Bytes of the zero-padded Linv (8 NT rows of linv_stride(NT) floats).
__host__ __device__ constexpr size_t linv_bytes(int r) {
  return sizeof(float) * 8 * tiles(r) * linv_stride(tiles(r));
}

// Stage the node's (r, r) Linv zero-padded to (8 NT, 8 NT) in ``li`` at
// row stride linv_stride(NT), 16 bytes a copy where rows allow it, with
// cp.async; commits one group (the caller waits for it).
template <int NT>
__device__ __forceinline__ void stage_linv(float* li,
                                           const float* __restrict__ lsrc,
                                           int r) {
  constexpr int RP = 8 * NT, LDL = linv_stride(NT);
  if (r % 4 == 0 && reinterpret_cast<size_t>(lsrc) % 16 == 0) {
    constexpr int Q4 = RP / 4;
    for (int e = threadIdx.x; e < RP * Q4; e += blockDim.x) {
      const int s = e / Q4, c = 4 * (e - s * Q4);
      const bool ok = s < r && c < r;
      acopy::bytes16(li + s * LDL + c, ok ? lsrc + s * r + c : lsrc, ok);
    }
  } else {
    for (int e = threadIdx.x; e < RP * RP; e += blockDim.x) {
      const int s = e / RP, c = e - s * RP;
      const bool ok = s < r && c < r;
      acopy::element(li + s * LDL + c, ok ? lsrc + s * r + c : lsrc, ok);
    }
  }
  acopy::commit();
}

// acc[i] += A B_i in three passes (tf32x3::mma3's terms and order) for
// the tiles i0 <= i < i1 of a group, pass by pass across the group: a
// tile's three dependent products are i1 - i0 products apart.  The
// callers' loops unroll, so i0 and i1 are constants here.
__device__ __forceinline__ void mma_group(float (*acc)[4], int i0, int i1,
                                          const uint32_t* ah,
                                          const uint32_t* al,
                                          const uint32_t (*bh)[2],
                                          const uint32_t (*bl)[2]) {
#pragma unroll
  for (int i = i0; i < i1; ++i) tf32x3::mma(acc[i], al, bh[i]);
#pragma unroll
  for (int i = i0; i < i1; ++i) tf32x3::mma(acc[i], ah, bl[i]);
#pragma unroll
  for (int i = i0; i < i1; ++i) tf32x3::mma(acc[i], ah, bh[i]);
}

// Y += K_kk Linv_kk^T for k-step kk (K's columns 8 kk .. 8 kk + 7 as the
// split A fragment ah, al): Y's tiles j >= kk, a group at a time; the
// first group starts at kk.  kk is a constant of the caller's unrolled
// loop.
template <int NT>
__device__ __forceinline__ void y_step(float (&y)[NT][4], int kk,
                                       const uint32_t* ah, const uint32_t* al,
                                       const float* li, int g, int t) {
  constexpr int LDL = linv_stride(NT);
  const float* lk = li + g * LDL + 8 * kk + t;
#pragma unroll
  for (int q = kk / kGroup; q < NT / kGroup; ++q) {
    const int i0 = max(0, kk - kGroup * q);
    uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
    for (int i = i0; i < kGroup; ++i) {
      const float* lp = lk + 8 * (kGroup * q + i) * LDL;
      tf32x3::split(lp[0], bh[i][0], bl[i][0]);
      tf32x3::split(lp[4], bh[i][1], bl[i][1]);
    }
    mma_group(y + kGroup * q, i0, kGroup, ah, al, bh, bl);
  }
}

// acc = Y Linv: U's tiles jc <= ks at step ks, a group at a time; the last
// group ends at ks.
template <int NT>
__device__ __forceinline__ void u_product(float (&acc)[NT][4],
                                          const float (&y)[NT][4],
                                          const float* li, int g, int t) {
  constexpr int LDL = linv_stride(NT);
  const float* lrow = li + 2 * t * LDL + g;
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    uint32_t ah[4], al[4];
    tf32x3::acc_as_a(y[ks], ah, al);
    const float* lk = lrow + 8 * ks * LDL;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ks][e] = 0.f;
#pragma unroll
    for (int q = 0; q <= ks / kGroup; ++q) {
      const int i1 = min(kGroup, ks + 1 - kGroup * q);
      uint32_t bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int i = 0; i < i1; ++i) {
        const int jc = kGroup * q + i;
        tf32x3::split(lk[8 * jc], bh[i][0], bl[i][0]);
        tf32x3::split(lk[8 * jc + LDL], bh[i][1], bl[i][1]);
      }
      mma_group(acc + kGroup * q, 0, i1, ah, al, bh, bl);
    }
  }
}

// Store this lane's rows row0 and row0 + 8 of U (row-major, (m, r)): c0,
// c1 at columns 8 jc + 2t (+1), c2, c3 at row0 + 8.
template <int NT>
__device__ __forceinline__ void store_u(float* __restrict__ U,
                                        const float (&acc)[NT][4], int row0,
                                        int m, int r, int t) {
#pragma unroll
  for (int jc = 0; jc < NT; ++jc) {
    const int col = 8 * jc + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m || col >= r) continue;
      float* o = U + static_cast<size_t>(row) * r + col;
      if (r % 2 == 0) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[jc][2 * h], acc[jc][2 * h + 1]);
      } else {
        o[0] = acc[jc][2 * h];
        if (col + 1 < r) o[1] = acc[jc][2 * h + 1];
      }
    }
  }
}

}  // namespace tc

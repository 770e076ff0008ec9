// The front half that kernel_matvec.cu (B10) and kernel_tile.cu (B11)
// share on the tensor cores: float32 gaussian and imq kernel values of a
// 128-row block of X against 128-row tiles of Y, through the norm identity
// and split TF32 on wgmma.
//
// The wrappers stage X and Y as TF32 hi and lo planes (tf32x3.cuh), each
// (2, rows, dp) with d zero-padded to dp, a multiple of 8 up to 64, and
// take the squared norms in float32 from the unsplit rows (Y's padded
// with zeros to a multiple of 128; matvec_stage/ops.py::prepare_pairs).
// A block has 384 threads: warpgroup 0 produces (one thread issues every
// TMA load), warpgroups 1 and 2 consume 64 rows of X each.  X's 128 rows
// (hi and lo) are loaded once; Y's tiles go through the kernel's ring.
// Each plane is read in 128-byte-swizzled boxes of 32 columns, so a row of
// 56 columns is two boxes, zero-filled past d (and rows past the tensor
// zero-filled too).
//
// S = X Y^T: wgmma.m64n128k8 .tf32, both K-major from shared memory, three
// passes a k-step (lo hi, hi lo, hi hi).  The kernel value of each entry
// of the accumulator: d2 = max(|x|^2 + |y|^2 - 2 S, 0), the distance
// clamped as in the TPU kernel, then exp2 (gaussian) or rsqrt (imq).  The
// accumulator's thread (warp w of its warpgroup, g = lane / 4, t = lane %
// 4) holds s[4 j + e] at row 16 w + g + 8 (e >> 1) and column 8 j + 2 t +
// (e & 1) of the 64 x 128 tile (tf32x3.cuh).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "kernel_epilogue.cuh"
#include "tf32x3.cuh"

namespace tc_pairs {

using namespace hopper;

constexpr int BM = 128;              // rows of X a block: 2 warpgroups x 64
constexpr int BN = 128;              // rows of Y a tile (S: m64n128)
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int COLS = 32;             // f32 columns a TMA box (128 bytes)
constexpr uint32_t XBOX = BM * 128;  // bytes of a box of X's tile
constexpr uint32_t YBOX = BN * 128;  // and of Y's
constexpr int MAX_DP = 2 * COLS;     // features X keeps resident (2 boxes)
constexpr float LOG2E = 1.4426950408889634f;

// Producer: X's tile of rows [r0, r0 + BM), hi and lo planes of nb boxes
// each, into sx, completing on full_x.
__device__ __forceinline__ void load_x(uint32_t sx, const CUtensorMap* tmx,
                                       uint32_t full_x, int nb, int r0) {
  mbar_expect_tx(full_x, 2 * nb * XBOX);
  for (int pl = 0; pl < 2; ++pl)
    for (int c = 0; c < nb; ++c)
      tma_load(sx + (pl * nb + c) * XBOX, tmx, full_x, c * COLS, r0, pl);
}

// Producer: plane pl (0 hi, 1 lo) of Y's tile of rows [row, row + BN)
// into sy, completing on bar (whose expected bytes the caller has set).
__device__ __forceinline__ void load_y(uint32_t sy, const CUtensorMap* tmy,
                                       uint32_t bar, int nb, int row,
                                       int pl) {
  for (int c = 0; c < nb; ++c)
    tma_load(sy + (pl * nb + c) * YBOX, tmy, bar, c * COLS, row, pl);
}

// Row of X (within the block's tile) of this consumer thread's accumulator
// entries e < 2; entries e >= 2 lie 8 rows below.
__device__ __forceinline__ int acc_row(int cw) {
  return 64 * cw + 16 * (threadIdx.x % 128 / 32) + threadIdx.x % 32 / 4;
}

// Consumer warpgroup: s (64 x 128) = its 64 rows of X (xa: hi plane, the
// lo plane nb boxes later) times Y's tile (sy) transposed, over the
// k-steps of 8, each three TF32 passes; waits for the products.  NKS > 0
// fixes the k-steps (nks is then NKS and nb (NKS + 3) / 4): the chain is
// unrolled, one block of code from the warpgroup's arrive to its wait, and
// ptxas needs to inject no warpgroup.arrive (C7519).  NKS 0 takes nks at
// run time (B10); the loop's blocks then get injected arrives.
__device__ __forceinline__ void k_step(float* s, uint32_t xa, uint32_t sy,
                                       int nb, int ks) {
  const uint32_t xo = (ks / 4) * XBOX + (ks % 4) * 32;  // box, k-step
  const uint32_t yo = sy + (ks / 4) * YBOX + (ks % 4) * 32;
  tf32x3::wgmma3_ss_n128(
      s, sw128_desc(xa + xo, 16), sw128_desc(xa + nb * XBOX + xo, 16),
      sw128_desc(yo, 16), sw128_desc(yo + nb * YBOX, 16), ks > 0);
}

template <int NKS>
__device__ __forceinline__ void products(float* s, uint32_t xa, uint32_t sy,
                                         int nb, int nks) {
  wgmma_fence();
  if constexpr (NKS > 0) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) k_step(s, xa, sy, (NKS + 3) / 4, ks);
  } else {
    for (int ks = 0; ks < nks; ++ks) k_step(s, xa, sy, nb, ks);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<BN / 2>(s);
}

// The kernel value of each entry i of s (the accumulator of products),
// handed to sink(i, value) as it is made: xn0 and xn1 the squared norms
// of the thread's two rows of X, ynt the tile's BN squared norms of Y
// (shared memory); p0, p1 from epilogue_params.  B10 splits each value
// into the A fragments of its second product as it comes (storing the
// values into s first and splitting them after made B10 slower on the
// card); B11 writes it back into s.
template <int KIND, typename Sink>
__device__ __forceinline__ void kernel_values(const float* s,
                                              const float* ynt, float xn0,
                                              float xn1, float p0, float p1,
                                              Sink&& sink) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int g8 = 0; g8 < BN / 8; ++g8) {
    const float2 yv = *reinterpret_cast<const float2*>(ynt + 8 * g8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * g8 + e;
      const float d2 = fmaxf(
          fmaf(-2.f, s[i], ((e & 2) ? xn1 : xn0) + ((e & 1) ? yv.y : yv.x)),
          0.f);
      sink(i, KIND == KIND_GAUSSIAN ? ex2(d2 * p0) : p0 * rsqrtf(d2 + p1));
    }
  }
}

// The epilogue's constants: gaussian exp(-d2 / (2 sigma^2)) = exp2(d2 p0),
// p0 = -log2(e) / (2 sigma^2); imq p0 / sqrt(d2 + p1), p0 = sigma, p1 =
// sigma^2.
inline void epilogue_params(int kind, double sigma, float* p0, float* p1) {
  const double s2 = sigma * sigma;
  if (kind == KIND_GAUSSIAN) {
    *p0 = static_cast<float>(-static_cast<double>(LOG2E) / (2.0 * s2));
    *p1 = 0.f;
  } else {
    *p0 = static_cast<float>(sigma);
    *p1 = static_cast<float>(s2);
  }
}

inline bool misaligned(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 != 0;
}

}  // namespace tc_pairs

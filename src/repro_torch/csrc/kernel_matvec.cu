// Fused exact-kernel matvec: z = K(Xc, Y) V, without ever writing K
// (the operator of the matvec-free solvers, repro.solvers.operators.
// ExactKernelOp, and of exact-kernel prediction).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/matvec_stage/matvec_stage.py::kernel_matvec_kernel
//   (_matvec_body).
//
// Two kernels; the wrapper chooses one by dtype, base kernel and width
// before the launch (kernels/matvec_stage/ops.py::route).
//
// Bound on the H100: operations.  Each of the b * m pairs costs its
// distance over d features, one epilogue and 2 k flops of contraction,
// and nothing of size b * m reaches device memory.  At covtype width (b =
// m = 464,809, d = 54, k = 7, f32) that is 2.16e11 pairs: ~2.7e13 flops,
// 0.41 s at 67 TFLOP/s on the CUDA cores; three TF32 passes over 2 (56 +
// 8) flops a pair (d and k padded) are 8.3e13 flops, 0.17 s at 495 TFLOP/s
// on the tensor cores, against ~0.2 GB of inputs.
//
// float32 gaussian and imq, d <= 64 (the solvers' path): kernel_matvec_tc,
// split TF32 on the tensor cores.
//   Its front half, shared with kernel_tile.cu (B11), is tc_pairs.cuh: the
//   wrapper's TF32 hi and lo planes of Xc and Y (d padded to a multiple of
//   8) and float32 norms, a producer warpgroup issuing every TMA load, X's
//   128 rows resident, S = X Y^T by wgmma.m64n128k8 .tf32 in three passes
//   and the clamped identity with exp2 or rsqrt.  Here the wrapper also
//   stages V^T split the same way, k padded to a multiple of 8 and V's
//   rows permuted within each group of 8 (below).  The producer gives its
//   registers back (setmaxnreg 24), the two consumer warpgroups take 240.
//   Tiles of 128 rows of Y (hi, lo, their norms) and the matching 128 keys
//   of V^T go through a ring of 1 to 4 stages (as many as fit) with full
//   and empty mbarriers, so later tiles load while this one is computed.
//   Two consumer warpgroups share one Y tile, so Y is read once per 128
//   rows of Xc.  The kernel values are split into hi and lo.  O += K V: the
//   split K goes back to wgmma as A from registers (m64nKPk8, KP = 8, 16
//   or 32 columns of V a launch) against V^T (hi, lo) from shared memory.
//   The accumulator holds columns 2t and 2t + 1 of each group of 8 where
//   the A fragment wants t and t + 4 (tf32x3.cuh); the wrapper permutes
//   V's rows within each group of 8 to match, so no shuffle is needed.
//   Each tile's K V is summed in its own accumulator and added to the
//   running sum in float32, so the tensor cores' truncating accumulation
//   spans 48 passes, not the whole sweep.  Y rows past m are zero-filled
//   with V rows of 0; rows past b are computed and not written.
//
// laplace (the L1 distance has no dot-product identity), float64 and rows
// wider than 64 (Xc's tile would not stay resident): kernel_matvec_kernel
// on the CUDA cores, every sum in T.
//   Shapes: xc (b, d), y (m, d), v (m, ld), z (b, ld), row-major and
//   contiguous; the launch covers columns [0, kc) of v and z (the wrapper
//   offsets the pointers for wider right-hand sides).  One block owns
//   BM = 64 rows of Xc and keeps their (64, k) accumulators in shared
//   memory for the whole sweep over Y, so no state crosses blocks.  Per
//   tile of BN = 64 rows of Y it forms the 64 x 64 distance tile in
//   registers (pair_tile.cuh), applies the epilogue and parks the kernel
//   tile in shared memory; the tile is then contracted at once against the
//   matching rows of V, staged KC columns at a time, so the distances are
//   computed once whatever k is.  Y rows past m give kernel values and V
//   rows of 0; rows past b are computed and not written.
//
// Both replace the TPU grid's sequential contraction axis with the loop
// over Y inside the block.
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"
#include "kernel_epilogue.cuh"
#include "pair_tile.cuh"
#include "tc_pairs.cuh"
#include "tf32x3.cuh"

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

// ---------------------------------------------------------------------------
// float32 gaussian and imq: split TF32 on the tensor cores (TMA, wgmma)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;
using tc_pairs::BM;
using tc_pairs::BN;
using tc_pairs::COLS;
using tc_pairs::kThreads;
using tc_pairs::XBOX;
using tc_pairs::YBOX;

constexpr int VBOXES = BN / COLS;    // boxes of V^T (32 keys each) a tile
constexpr int MAX_STAGES = 4;

// Byte offsets in a block's shared memory, from a 1024-byte aligned base:
// Xc's tile (hi and lo planes of nb boxes), the stages' Y tiles (2 nb
// boxes each), their V^T tiles (2 x VBOXES boxes of kp rows), their BN
// norms of Y, then the barriers full_x, full[stages], empty[stages].  Every
// box starts on 1024 bytes, as the 128-byte swizzle needs.
// ops.tc_smem mirrors it.
struct Smem {
  uint32_t y, v, yn, bars, total;
  __host__ __device__ Smem(int nb, int kp, int stages)
      : y(2u * nb * XBOX),
        v(y + stages * 2u * nb * YBOX),
        yn(v + stages * 2u * VBOXES * kp * 128u),
        bars(yn + stages * BN * 4u),
        total(bars + 8u * (1 + 2 * stages)) {}
};

template <int KIND, int KP>
__global__ void __launch_bounds__(kThreads, 1)
matvec_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmy,
                 const __grid_constant__ CUtensorMap tmv,
                 const float* __restrict__ xn, const float* __restrict__ yn,
                 float* __restrict__ z, int b, int m, int nks, int stages,
                 int col0, int kc, int ld, float p0, float p1) {
  extern __shared__ unsigned char smem_raw[];
  const int nb = (nks + 3) / 4;
  const Smem lay(nb, KP, stages);
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sx = (raw + 1023) & ~1023u;
  const auto sy = [&](int st) { return sx + lay.y + st * 2u * nb * YBOX; };
  const auto sv = [&](int st) {
    return sx + lay.v + st * 2u * VBOXES * KP * 128u;
  };
  const auto syn = [&](int st) { return sx + lay.yn + st * BN * 4u; };
  const uint32_t full_x = sx + lay.bars;
  const auto full = [&](int st) { return full_x + 8u * (1 + st); };
  const auto empty = [&](int st) { return full_x + 8u * (1 + stages + st); };
  const int r0 = blockIdx.x * BM;
  const int ntiles = (m + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(full_x, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2 * 128);           // every consumer thread
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: Xc's tile once, then keeps the ring full ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      tc_pairs::load_x(sx, &tmx, full_x, nb, r0);
      const uint32_t bytes = 2 * nb * YBOX + 2 * VBOXES * KP * 128 + BN * 4;
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % stages;
        mbar_wait(empty(st), ((j / stages) & 1) ^ 1);
        mbar_expect_tx(full(st), bytes);
        for (int pl = 0; pl < 2; ++pl) {
          tc_pairs::load_y(sy(st), &tmy, full(st), nb, j * BN, pl);
          for (int c = 0; c < VBOXES; ++c)
            tma_load(sv(st) + (pl * VBOXES + c) * KP * 128, &tmv, full(st),
                     j * BN + c * COLS, col0, pl);
        }
        bulk_load(syn(st), yn + static_cast<size_t>(j) * BN, BN * 4,
                  full(st));
      }
    }
  } else {
    // ---- consumers: S = X Y^T, kernel values, O += K V ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int row0 = r0 + tc_pairs::acc_row(cw);
    const int row1 = row0 + 8;
    const float xn0 = row0 < b ? xn[row0] : 0.f;
    const float xn1 = row1 < b ? xn[row1] : 0.f;
    const uint32_t xa = sx + cw * 64 * 128;        // this warpgroup's rows
    float o[KP / 2], ot[KP / 2], s[BN / 2];
    uint32_t kh[BN / 2], kl[BN / 2];
#pragma unroll
    for (int i = 0; i < KP / 2; ++i) o[i] = ot[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    mbar_wait(full_x, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % stages;
      mbar_wait(full(st), (j / stages) & 1);
      tc_pairs::products<0>(s, xa, sy(st), nb, nks);
      tc_pairs::kernel_values<KIND>(
          s, reinterpret_cast<const float*>(smem_raw + (syn(st) - raw)), xn0,
          xn1, p0, p1,
          [&](int i, float kv) { tf32x3::split(kv, kh[i], kl[i]); });
      wgmma_fence();
#pragma unroll
      for (int g8 = 0; g8 < BN / 8; ++g8) {
        const uint32_t ah[4] = {kh[4 * g8], kh[4 * g8 + 2], kh[4 * g8 + 1],
                                kh[4 * g8 + 3]};
        const uint32_t al[4] = {kl[4 * g8], kl[4 * g8 + 2], kl[4 * g8 + 1],
                                kl[4 * g8 + 3]};
        const uint32_t vo = sv(st) + (g8 / 4) * KP * 128 + (g8 % 4) * 32;
        tf32x3::wgmma3_rs<KP>(ot, ah, al, sw128_desc(vo, 16),
                              sw128_desc(vo + VBOXES * KP * 128, 16), g8 > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<KP / 2>(ot);
      mbar_arrive(empty(st));
#pragma unroll
      for (int i = 0; i < KP / 2; ++i) o[i] += ot[i];
    }
#pragma unroll
    for (int i = 0; i < KP / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);
      const int row = (i & 2) ? row1 : row0;
      if (row < b && col < kc) z[static_cast<size_t>(row) * ld + col] = o[i];
    }
  }
}

template <int KIND, int KP>
int launch(const void* xs, const void* ys, const void* vt, const void* xn,
           const void* yn, void* z, int b, int m, int dp, int kpt, int mp,
           int col0, int kc, int ld, int stages, float p0, float p1,
           cudaStream_t stream) {
  const int nks = dp / 8;
  const size_t smem = 1024 + Smem((nks + 3) / 4, KP, stages).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mx, my, mv;
  int err = encode_map(&mx, f32, 4, xs, 2, b, dp, COLS, BM);
  if (!err) err = encode_map(&my, f32, 4, ys, 2, m, dp, COLS, BN);
  if (!err) err = encode_map(&mv, f32, 4, vt, 2, kpt, mp, COLS, KP);
  if (!err) err = launch_with_smem(matvec_tc_kernel<KIND, KP>, smem);
  if (err) return err;
  const unsigned grid = static_cast<unsigned>((b + BM - 1) / BM);
  matvec_tc_kernel<KIND, KP><<<grid, kThreads, smem, stream>>>(
      mx, my, mv, static_cast<const float*>(xn),
      static_cast<const float*>(yn), static_cast<float*>(z), b, m, nks,
      stages, col0, kc, ld, p0, p1);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_kind(const void* xs, const void* ys, const void* vt,
                const void* xn, const void* yn, void* z, int b, int m, int dp,
                int kpt, int mp, int col0, int kc, int kp, int ld, int stages,
                float p0, float p1, cudaStream_t stream) {
  switch (kp) {
    case 8: return launch<KIND, 8>(xs, ys, vt, xn, yn, z, b, m, dp, kpt, mp,
                                   col0, kc, ld, stages, p0, p1, stream);
    case 16: return launch<KIND, 16>(xs, ys, vt, xn, yn, z, b, m, dp, kpt,
                                     mp, col0, kc, ld, stages, p0, p1, stream);
    case 32: return launch<KIND, 32>(xs, ys, vt, xn, yn, z, b, m, dp, kpt,
                                     mp, col0, kc, ld, stages, p0, p1, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

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

// float32 gaussian (kind 0) and imq (1) on the tensor cores, from the
// wrapper's staging (ops.py::prepare_tc): xs (2, b, dp) and ys (2, m, dp)
// hi and lo planes, dp a multiple of 8 up to 64; vt (2, kpt, mp) the split
// V^T, kpt and mp multiples of 8, rows permuted within groups of 8; xn (b)
// and yn (m padded to a multiple of 128) the squared norms; z (b, ld).  The
// launch covers columns [col0, col0 + kc) of V (z offset to column col0
// by the caller) with KP = kp columns of wgmma, through a ring of
// ``stages`` stages.
extern "C" int kernel_matvec_tc_f32(const void* xs, const void* ys,
                                    const void* vt, const void* xn,
                                    const void* yn, void* z, int b, int m,
                                    int dp, int kpt, int mp, int col0, int kc,
                                    int kp, int ld, int kind, double sigma,
                                    int stages, void* stream) {
  if (b == 0 || kc == 0) return 0;
  if (m <= 0 || dp <= 0 || dp % 8 || dp > tc_pairs::MAX_DP || kpt % 8 ||
      mp % 8 || mp < m || kc > kp || col0 + kc > kpt || stages < 1 ||
      stages > tc::MAX_STAGES || (kind != KIND_GAUSSIAN && kind != KIND_IMQ))
    return cudaErrorInvalidValue;
  using tc_pairs::misaligned;
  if (misaligned(xs) || misaligned(ys) || misaligned(vt) || misaligned(yn))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  float p0, p1;
  tc_pairs::epilogue_params(kind, sigma, &p0, &p1);
  if (kind == KIND_GAUSSIAN)
    return tc::launch_kind<KIND_GAUSSIAN>(xs, ys, vt, xn, yn, z, b, m, dp,
                                          kpt, mp, col0, kc, kp, ld, stages,
                                          p0, p1, st);
  return tc::launch_kind<KIND_IMQ>(xs, ys, vt, xn, yn, z, b, m, dp, kpt, mp,
                                   col0, kc, kp, ld, stages, p0, p1, st);
}

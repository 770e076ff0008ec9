// Pairwise base-kernel evaluation: out = K(X, Y), (n, m) in float32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/kernel_tile/kernel_tile.py::kernel_tile
//   (_l2_body and _l1_body).
//
// Shapes: x (n, d), y (m, d) float32 (the wrapper casts, as the reference
// pins float32) -> out (n, m) float32, row-major and contiguous, never
// padded.
//
// Bound on the H100: bytes.  This is the one kernel of the port whose
// output is the whole (n, m) tile: at n = m = 16,384, d = 54 it writes
// 1.07 GB (0.32 ms at 3.35 TB/s), while three TF32 passes over 2d flops a
// pair take 0.18 ms at 495 TFLOP/s and one exp2 a pair 0.06 ms on the
// special-function units.  Summed directly on the CUDA cores (an FSUB and
// an FFMA a pair and feature) the same tile is an issue floor of ~0.87 ms.
// So the design computes on the tensor cores and keeps the stores
// draining while the next tile is computed.
//
// Three kernels; the wrapper chooses before the launch
// (kernels/kernel_tile/ops.py::route and core_kernel).
//
// "tc", float32 gaussian and imq with d <= 64: kernel_tile_tc_kernel.
//   The front half is B10's (tc_pairs.cuh): the wrapper's TF32 hi and lo
//   planes (d zero-padded to a multiple of 8) and float32 norms, a
//   producer warpgroup whose one thread issues every TMA load, a block of
//   128 rows of X resident (loaded once), S = X Y^T on wgmma.m64n128k8
//   .tf32 in three passes, the clamped identity, exp2 or rsqrt.  Each block
//   walks a contiguous range of Y's 128-row tiles (all of Y unless the row
//   blocks are fewer than the SMs: then the grid's y axis splits Y so
//   every SM has a block) through a ring of Y tiles: two stages at d > 32,
//   four below, so the next Y tile loads under this one's products.  The
//   tile's norms of Y are read before the stage is released.  Each
//   consumer warpgroup parks its 64 x 128 tile of values in its own 16 KB
//   of shared memory, half the tile at a time (a whole tile would leave
//   room for one Y stage only), in the 128-byte swizzle (two boxes of 32
//   columns: the accumulator's float2 writes are then two-way, the fewest
//   for 256 bytes a warp), and one thread stores each half with two TMA
//   stores (global <- shared, clipped at n and m by the TMA) in one bulk
//   group.  The staging is written again only after that group has read
//   it (wait_group.read), which the thread checks just before the next
//   half is written, so the second half drains under the next tile's
//   products.  TMA needs 16-byte rows, so this store runs where m % 4 ==
//   0; other m (tma_out 0) store from the same staging with coalesced,
//   predicated stores: a warp a row, 32 columns at a time.
//   The kernel has one instance a k-step count (dp / 8), so its chain of
//   products is unrolled and ptxas injects no warpgroup.arrive (C7519).
// "tiled", laplace (the L1 distance has no dot-product identity) with d <=
//   64: dist_tiled.cuh, B12's register-tiled direct sums, with the
//   epilogue applied as each value is stored (half the time of
//   "pair_tile" in turns on the H100: tools/time_kernel_tile.py).
// "pair_tile", any base kernel with d > 64 (a wider X tile would not stay
//   resident): the first design.  A block owns a 64 x 64 output tile and
//   stages the features 32 at a time (pair_tile.cuh), sums directly, and
//   writes the values in place of a contraction.  Neighbouring threads
//   write neighbouring columns; entries past n or m are not written.
#include <cuda.h>
#include <cuda_runtime.h>

#include "dist_tiled.cuh"
#include "hopper.cuh"
#include "kernel_epilogue.cuh"
#include "pair_tile.cuh"
#include "tc_pairs.cuh"

namespace {

// ---------------------------------------------------------------------------
// "pair_tile": direct sums on the CUDA cores, 64 x 64 tiles, any d
// ---------------------------------------------------------------------------

template <bool L1>
__global__ void __launch_bounds__(pair_tile::kThreads)
kernel_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int n, int m, int d, int kind,
                   float sigma) {
  using pair_tile::BM;
  using pair_tile::BN;
  using pair_tile::TM;
  using pair_tile::TN;
  __shared__ float staged[pair_tile::kStageElems];
  float* xs = staged;
  float* ys = staged + pair_tile::DC * pair_tile::LDX;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  float dist[TM][TN];
  pair_tile::distances<float, L1>(x, y, n, m, d, r0, c0, xs, ys, dist);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < m)
        out[static_cast<size_t>(row) * m + col] =
            kernel_epilogue(kind, dist[i][j], sigma);
    }
  }
}

// ---------------------------------------------------------------------------
// "tiled": B12's register-tiled direct sums with the epilogue, d <= 64,
// laplace
// ---------------------------------------------------------------------------

struct KernelValue {
  int kind;
  float sigma;
  __device__ __forceinline__ float operator()(float v) const {
    return kernel_epilogue(kind, v, sigma);
  }
};

// ---------------------------------------------------------------------------
// "tc": split TF32 on the tensor cores (TMA loads and stores, wgmma)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;
using tc_pairs::BM;
using tc_pairs::BN;
using tc_pairs::COLS;
using tc_pairs::kThreads;
using tc_pairs::XBOX;
using tc_pairs::YBOX;

constexpr int MAX_STAGES = 4;
constexpr uint32_t OBOX = 64 * 128;        // an output box: 64 rows x 128 B
constexpr int HALF_BOXES = BN / COLS / 2;  // boxes of a half tile (64 cols)
constexpr uint32_t OHALF = HALF_BOXES * OBOX;  // a warpgroup's staging

// Byte offsets in a block's shared memory, from a 1024-byte aligned base:
// X's tile (hi and lo planes of nb boxes), the stages' Y tiles (2 nb boxes
// each), their BN norms of Y, the two consumer warpgroups' output staging
// (half a tile each, from a 1024-byte boundary, as the swizzle needs),
// then the barriers full_x, full[stages], empty[stages].  ops.tc_smem
// mirrors it.
struct Smem {
  uint32_t y, yn, out, bars, total;
  __host__ __device__ Smem(int nb, int stages)
      : y(2u * nb * XBOX),
        yn(y + stages * 2u * nb * YBOX),
        out((yn + stages * BN * 4u + 1023u) & ~1023u),
        bars(out + 2u * OHALF),
        total(bars + 8u * (1 + 2 * stages)) {}
};

template <int KIND, int NKS>
__global__ void __launch_bounds__(kThreads, 1)
kernel_tile_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmy,
                      const __grid_constant__ CUtensorMap tmo,
                      const float* __restrict__ xn,
                      const float* __restrict__ yn, float* __restrict__ out,
                      int n, int m, int stages, int tma_out, float p0,
                      float p1) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int nb = (NKS + 3) / 4;
  const Smem lay(nb, stages);
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sx = (raw + 1023) & ~1023u;
  const auto sy = [&](int st) { return sx + lay.y + st * 2u * nb * YBOX; };
  const auto syn = [&](int st) { return sx + lay.yn + st * BN * 4u; };
  const uint32_t full_x = sx + lay.bars;
  const auto full = [&](int st) { return full_x + 8u * (1 + st); };
  const auto empty = [&](int st) { return full_x + 8u * (1 + stages + st); };
  const int r0 = blockIdx.x * BM;
  // this block's tiles of Y: [j0, j1) of the ntiles, split over grid y
  const int ntiles = (m + BN - 1) / BN;
  const int j0 = static_cast<int>(static_cast<long long>(ntiles) *
                                  blockIdx.y / gridDim.y);
  const int j1 = static_cast<int>(static_cast<long long>(ntiles) *
                                  (blockIdx.y + 1) / gridDim.y);

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
    // ---- producer: X's tile once, then keeps the ring full ----
    if (threadIdx.x == 0) {
      tc_pairs::load_x(sx, &tmx, full_x, nb, r0);
      const uint32_t bytes = 2 * nb * YBOX + BN * 4;
      for (int j = j0; j < j1; ++j) {
        const int it = j - j0, st = it % stages;
        mbar_wait(empty(st), ((it / stages) & 1) ^ 1);
        mbar_expect_tx(full(st), bytes);
        for (int pl = 0; pl < 2; ++pl)
          tc_pairs::load_y(sy(st), &tmy, full(st), nb, j * BN, pl);
        bulk_load(syn(st), yn + static_cast<size_t>(j) * BN, BN * 4,
                  full(st));
      }
    }
    return;
  }
  // ---- consumers: S = X Y^T, kernel values, the tile stored ----
  const int cw = threadIdx.x / 128 - 1;
  const int wt = threadIdx.x % 128;            // thread of the warpgroup
  const int lane = threadIdx.x % 32, warp = wt / 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = r0 + tc_pairs::acc_row(cw);
  const float xn0 = row0 < n ? xn[row0] : 0.f;
  const float xn1 = row0 + 8 < n ? xn[row0 + 8] : 0.f;
  const uint32_t xa = sx + cw * 64 * 128;      // this warpgroup's rows
  const uint32_t so = sx + lay.out + cw * OHALF;  // its output staging
  unsigned char* sop = smem_raw + (so - raw);
  float s[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  mbar_wait(full_x, 0);
  for (int j = j0; j < j1; ++j) {
    const int it = j - j0, st = it % stages;
    mbar_wait(full(st), (it / stages) & 1);
    tc_pairs::products<NKS>(s, xa, sy(st), nb, NKS);
    tc_pairs::kernel_values<KIND>(
        s, reinterpret_cast<const float*>(smem_raw + (syn(st) - raw)), xn0,
        xn1, p0, p1, [&](int i, float kv) { s[i] = kv; });
    mbar_arrive(empty(st));                    // Y's stage is free
    // the tile leaves in two halves of 64 columns through the staging
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // the previous store has read the staging: write this half
      if (tma_out && wt == 0) bulk_wait_read<0>();
      named_bar_sync(1 + cw, 128);
#pragma unroll
      for (int j8 = 0; j8 < BN / 16; ++j8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // row 16 warp + g + 8 h, columns 8 j8 + 2t, 2t + 1 of the half:
          // box j8 / 4, 16-byte chunk 2 (j8 % 4) + t / 2, swizzled by the
          // row's low bits
          const int i = 4 * (BN / 16 * half + j8) + 2 * h;
          const int rr = 16 * warp + g + 8 * h;
          const int chunk = (2 * (j8 % 4) + t / 2) ^ g;
          *reinterpret_cast<float2*>(sop + (j8 / 4) * OBOX + rr * 128 +
                                     chunk * 16 + (t & 1) * 8) =
              make_float2(s[i], s[i + 1]);
        }
      }
      const int c0 = j * BN + half * (BN / 2);
      if (tma_out) {
        fence_proxy_async();                   // the values, to the TMA
        named_bar_sync(1 + cw, 128);
        if (wt == 0) {
          for (int b = 0; b < HALF_BOXES; ++b)
            tma_store(&tmo, so + b * OBOX, c0 + b * COLS, r0 + 64 * cw, 0);
          bulk_commit();
        }
      } else {
        named_bar_sync(1 + cw, 128);
        // a warp a row: lane l reads word l of each box's row and writes
        // column c0 + 32 b + l
        for (int rr = warp; rr < 64; rr += 4) {
          const int row = r0 + 64 * cw + rr;
          if (row >= n) break;
          float* orow = out + static_cast<size_t>(row) * m;
#pragma unroll
          for (int b = 0; b < HALF_BOXES; ++b) {
            const int col = c0 + b * COLS + lane;
            const float v = *reinterpret_cast<const float*>(
                sop + b * OBOX + rr * 128 + (((lane / 4) ^ (rr % 8)) * 16) +
                (lane % 4) * 4);
            if (col < m) orow[col] = v;
          }
        }
      }
    }
  }
  if (tma_out && wt == 0) bulk_wait<0>();      // the stores are done
}

template <int KIND, int NKS>
int launch(const void* xs, const void* ys, const void* xn, const void* yn,
           void* out, int n, int m, int stages, int chunks, int tma_out,
           float p0, float p1, cudaStream_t stream) {
  const int dp = 8 * NKS;
  const size_t smem = 1024 + Smem((NKS + 3) / 4, stages).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mx, my, mo;
  int err = encode_map(&mx, f32, 4, xs, 2, n, dp, COLS, BM);
  if (!err) err = encode_map(&my, f32, 4, ys, 2, m, dp, COLS, BN);
  // the output map, used by the TMA store only (m % 4 == 0 there); other
  // m pass X's map, which the kernel does not read
  if (!err) {
    if (tma_out)
      err = encode_map(&mo, f32, 4, out, 1, n, m, COLS, 64);
    else
      mo = mx;
  }
  if (!err) err = launch_with_smem(kernel_tile_tc_kernel<KIND, NKS>, smem);
  if (err) return err;
  const dim3 grid(static_cast<unsigned>((n + BM - 1) / BM),
                  static_cast<unsigned>(chunks));
  kernel_tile_tc_kernel<KIND, NKS><<<grid, kThreads, smem, stream>>>(
      mx, my, mo, static_cast<const float*>(xn),
      static_cast<const float*>(yn), static_cast<float*>(out), n, m, stages,
      tma_out, p0, p1);
  return static_cast<int>(cudaGetLastError());
}

// One instance a k-step count (dp / 8 = 1 to 8), so each chain of
// products is unrolled.
template <int KIND>
int launch_kind(int tma_out, const void* xs, const void* ys, const void* xn,
                const void* yn, void* out, int n, int m, int dp, int stages,
                int chunks, float p0, float p1, cudaStream_t stream) {
#define TILE_TC_CASE(K)                                                   \
  case K:                                                                 \
    return launch<KIND, K>(xs, ys, xn, yn, out, n, m, stages, chunks,     \
                           tma_out, p0, p1, stream);
  switch (dp / 8) {
    TILE_TC_CASE(1) TILE_TC_CASE(2) TILE_TC_CASE(3) TILE_TC_CASE(4)
    TILE_TC_CASE(5) TILE_TC_CASE(6) TILE_TC_CASE(7) TILE_TC_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef TILE_TC_CASE
}

}  // namespace tc

}  // namespace

// "pair_tile": x (n, d), y (m, d) -> out (n, m), any d.
extern "C" int kernel_tile_f32(const void* x, const void* y, void* out, int n,
                               int m, int d, int kind, double sigma,
                               void* stream) {
  if (n == 0 || m == 0) return 0;
  const dim3 grid((m + pair_tile::BN - 1) / pair_tile::BN,
                  (n + pair_tile::BM - 1) / pair_tile::BM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* yp = static_cast<const float*>(y);
  auto* op = static_cast<float*>(out);
  if (kind == KIND_LAPLACE)
    kernel_tile_kernel<true><<<grid, pair_tile::kThreads, 0, s>>>(
        xp, yp, op, n, m, d, kind, static_cast<float>(sigma));
  else
    kernel_tile_kernel<false><<<grid, pair_tile::kThreads, 0, s>>>(
        xp, yp, op, n, m, d, kind, static_cast<float>(sigma));
  return static_cast<int>(cudaGetLastError());
}

// "tiled": x (n, d), y (m, d) -> out (n, m), d <= 64, laplace only (its
// route; gaussian and imq with d <= 64 take "tc").
extern "C" int kernel_tile_tiled_f32(const void* x, const void* y, void* out,
                                     int n, int m, int d, int kind,
                                     double sigma, void* stream) {
  if (kind != KIND_LAPLACE) return cudaErrorInvalidValue;
  const KernelValue epi{kind, static_cast<float>(sigma)};
  return dist_tiled::launch<true>(x, y, out, 1, n, m, d, epi, stream);
}

// "tc": float32 gaussian (kind 0) and imq (1) from the wrapper's staging
// (matvec_stage/ops.py::prepare_pairs): xs (2, n, dp) and ys (2, m, dp)
// hi and lo planes, dp a multiple of 8 up to 64; xn (n) and yn (m padded
// to a multiple of 128) the squared norms; out (n, m).  ``tma_out`` (m % 4
// == 0) stores with the TMA; ``stages`` deep ring; ``chunks`` splits Y's
// tiles over the grid's y axis.
extern "C" int kernel_tile_tc_f32(const void* xs, const void* ys,
                                  const void* xn, const void* yn, void* out,
                                  int n, int m, int dp, int kind,
                                  double sigma, int stages, int chunks,
                                  int tma_out, void* stream) {
  if (n == 0 || m == 0) return 0;
  const int ntiles = (m + tc::BN - 1) / tc::BN;
  if (dp <= 0 || dp % 8 || dp > tc_pairs::MAX_DP || stages < 1 ||
      stages > tc::MAX_STAGES || chunks < 1 || chunks > ntiles ||
      chunks > 65535 || (tma_out && m % 4) ||
      (kind != KIND_GAUSSIAN && kind != KIND_IMQ))
    return cudaErrorInvalidValue;
  using tc_pairs::misaligned;
  if (misaligned(xs) || misaligned(ys) || misaligned(yn) || misaligned(out))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  float p0, p1;
  tc_pairs::epilogue_params(kind, sigma, &p0, &p1);
  if (kind == KIND_GAUSSIAN)
    return tc::launch_kind<KIND_GAUSSIAN>(tma_out, xs, ys, xn, yn, out, n, m,
                                          dp, stages, chunks, p0, p1, st);
  return tc::launch_kind<KIND_IMQ>(tma_out, xs, ys, xn, yn, out, n, m, dp,
                                   stages, chunks, p0, p1, st);
}

// Causal GQA attention with an online softmax (flash attention):
//
//   o[b][h] = softmax(q[b][h] k[b][g]^T / sqrt(D) + mask) v[b][g],
//   g = h / (Hq / Hkv)
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention
//   (body _body).
//
// Shapes: q (B, Hq, S, D), k and v (B, Hkv, S, D) -> o (B, Hq, S, D), all
// row-major and contiguous, T float or bfloat16.  Scores, the running max
// and sum and the accumulator are float32 for both; the scale
// 1/sqrt(D) multiplies the float32 scores, as in the Pallas body, and o is
// written in T (bfloat16 rounds to nearest even).  Any S: a ragged tail is
// masked here (rows past S are not written, keys past S never count),
// where the reference's wrapper falls back to its dense oracle.  D <= 128.
//
// Bound on the H100: operations.  At Zamba2-7B's prefill (B 4, Hq = Hkv =
// 32, S 3,840, D 112, bfloat16) the causal half of QK^T and PV is
// 4 B Hq S^2 D / 2 = 423 GFLOP, 0.43 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 0.13 ms for q, k, v and o at 3.35 TB/s.
//
// Three kernels; the wrapper chooses one by dtype, head dim and alignment
// before the launch (kernels/flash_attention/ops.py::variant).
//
// bfloat16, D % 8 == 0, 16-byte aligned q, k, v (the model's path):
// flash_attention_bf16_wgmma, built for Hopper.
//   Block: 128 query rows of one (b, h) and 384 threads.  Warpgroup 0 is
//   the producer: one thread issues every TMA load, and setmaxnreg lowers
//   its registers to 24.  Warpgroups 1 and 2 consume 64 rows each and are
//   raised to 240 registers.  K and V tiles of 128 keys go through a ring
//   of 3 stages in shared memory, with full (TMA bytes arrived) and empty
//   (all 256 consumer threads done) mbarriers, so the loads of later tiles
//   overlap the math on this one.  Q is loaded once.
//   Copies: 3-D tensor maps over (planes, S, D), so rows past S of one
//   head are zero-filled instead of read from the next head.  Each tile is
//   loaded as boxes of 64 columns x rows, 128-byte swizzled; the second
//   box covers columns 64..127 and is zero-filled past D.  A row of 112
//   bf16 values (224 bytes) is not a whole number of 128-byte swizzle
//   atoms, and a narrower swizzle would bring back bank conflicts on
//   wgmma's reads, so the tile is two atom-wide boxes.  Q K^T then takes
//   k-steps of 32 bytes inside one box, and a product over all of V spans
//   both boxes, LBO apart.
//   Math: S = Q K^T by wgmma.m64n128k16 with Q and K from shared memory
//   (both K-major, as stored).  The online softmax runs in registers, in
//   the log2 domain (one FFMA and one ex2.approx a score), masked only on
//   the diagonal tile and the ragged tail.
//   P goes back to wgmma as A from registers, since the accumulator layout
//   of S is the A-fragment layout of 16-bit types.  P is split into
//   hi = bf16(P) and lo = bf16(P - hi), and P V takes one m64nDk16 product
//   for each, with V MN-major from shared memory (transposed B).  So P
//   keeps ~16 bits, as the plain version's float32 P does: a single bf16
//   P moves outputs by more than their own rounding step.  Inside a
//   warpgroup, S_{j+1} = Q K_{j+1}^T and P_j V_j are issued together, and
//   the softmax of S_{j+1} runs while P_j V_j is on the tensor cores.
//   Order: the q-tiles of one (b, h) are neighbours in blockIdx, longest
//   first.  Epilogue: divide by l, round to bf16, write rows < S and
//   columns < D.  The CUtensorMaps are built on the host per call;
//   cuTensorMapEncodeTiled is looked up in libcuda at run time
//   (cudaGetDriverEntryPoint), so the library needs no -lcuda.
//
// Other bfloat16 inputs (a misaligned view, D % 8 != 0):
// flash_attention_bf16, mma.sync.  One block of 4 warps per (b Hq, 64-row
// query tile), each warp owning 16 query rows, through mma.sync.m16n8k16
// (bf16 in, f32 out).  Q's fragments stay in registers; K and V tiles are
// staged in shared memory (16-byte copies where d % 8 == 0 and the tensors
// are aligned, else one element at a time), rows padded by 16 bytes
// (conflict-free fragment loads; V's B fragments through ldmatrix.trans).
// P is split into hi and lo as above, and D is padded to a multiple of 16
// with zeros (a template per padded width).
//
// float32 (tests, the reduced config): flash_attention_f32.  256 threads on
// CUDA cores per (b Hq, 64-row query tile), thread (ty, tx) owning rows
// ty + 16 i and score columns tx + 16 j (i, j < 4) and output columns
// tx + 16 c; float32 FMAs, a row's max and sum reduced over the 16 lanes
// that share it.
//
// All three loop over KV tiles up to the diagonal (tiles above it are never
// loaded) and keep the running max, sum and accumulator on chip: the TPU
// kernel's sequential KV grid axis, whose VMEM accumulators persist across
// steps, does not carry over (blocks run in no order here).  Query head h
// reads KV head h / (Hq / Hkv): no KV copy per query head.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "kernel_epilogue.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64, BK = 64, kThreads = 256, DMAX = 128;
constexpr int TC = DMAX / 16;          // output columns per thread
constexpr float NEG_INF = -1e30f;      // the Pallas body's mask value

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// Rows [r0, r0 + rows) of a (s, d) matrix into shared rows of stride ld,
// zero past s.
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int r0,
                                          int rows, int s, int d, int ld,
                                          float* dst) {
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d, c = e % d;
    const int row = r0 + r;
    dst[r * ld + c] =
        row < s ? src[static_cast<size_t>(row) * d + c] : 0.f;
  }
}

__device__ __forceinline__ float row_reduce_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_reduce_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int hq, int hkv,
             int s, int d, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = d | 1;                 // odd row stride
  float* qs = smem;                     // BQ x ld
  float* ks = qs + BQ * ld;             // BK x ld
  float* vs = ks + BK * ld;             // BK x ld
  float* ps = vs + BK * ld;             // BQ x (BK + 1)
  const int tiles = (s + BQ - 1) / BQ;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * BQ;
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const size_t plane = static_cast<size_t>(s) * d;
  const float* qb = q + bh * plane;
  const float* kb = k + kvh * plane;
  const float* vb = v + kvh * plane;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile(qb, q0, BQ, s, d, ld, qs);
  float m[4], l[4], acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  }
  const int ktiles = (s + BK - 1) / BK;
  const int last = causal ? min(ktiles, (q0 + BQ - 1) / BK + 1) : ktiles;
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                    // ks, vs, ps free again
    load_tile(kb, k0, BK, s, d, ld, ks);
    load_tile(vb, k0, BK, s, d, ld, vs);
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int t = 0; t < d; ++t) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + t];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + t];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float val = sc[i][j] * scale;
        if (col >= s || (causal && col > row)) val = NEG_INF;
        sc[i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], row_reduce_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + row_reduce_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float vv[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < d ? vs[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
  float* ob = o + bh * plane;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[static_cast<size_t>(row) * d + col] = acc[i][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;       // 4 warps x 16 query rows

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + rows) of a (s, d) bf16 matrix into shared rows of stride
// ld, columns d..DP and rows past s zero: 16-byte copies when ``vec`` (d %
// 8 == 0 and 16-byte aligned tensors, so every row starts aligned), else
// one element at a time.
template <int DP>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src,
                                           int r0, int rows, int s, int d,
                                           int ld, bool vec,
                                           __nv_bfloat16* dst) {
  if (vec) {
    constexpr int CH = DP / 8;          // 16-byte chunks per shared row
    for (int e = threadIdx.x; e < rows * CH; e += kMmaThreads) {
      const int r = e / CH, c = (e % CH) * 8;
      const int row = r0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < s && c < d)
        val = *reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(row) * d + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < rows * DP; e += kMmaThreads) {
    const int r = e / DP, c = e % DP;
    const int row = r0 + r;
    dst[r * ld + c] =
        (row < s && c < d) ? src[static_cast<size_t>(row) * d + c] : zero;
  }
}

// The B fragments of two n-tiles (columns n0..n0+15) of P V from the
// row-major V tile: ldmatrix.trans of the four 8 x 8 blocks at key rows
// k0..k0+15; lane i addresses row k0 + i % 16, column n0 + 8 (i / 16).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const __nv_bfloat16* p) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int hq, int hkv, int s, int d,
                 int causal, float scale, bool vec) {
  constexpr int LDK = DP + 8;           // halves; Q, K and V rows
  constexpr int NT = DP / 8;            // output n-tiles
  constexpr int KT = DP / 16;           // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);      // BQ x LDK
  __nv_bfloat16* ks = qs + BQ * LDK;                           // BK x LDK
  __nv_bfloat16* vs = ks + BK * LDK;                           // BK x LDK
  const int tiles = (s + BQ - 1) / BQ;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * BQ;
  const int group = hq / hkv;
  const int kvh = (bh / hq) * hkv + (bh % hq) / group;
  const size_t plane = static_cast<size_t>(s) * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma groupID, thread in group

  stage_bf16<DP>(q + bh * plane, q0, BQ, s, d, LDK, vec, qs);
  __syncthreads();
  unsigned qa[KT][4];
  const __nv_bfloat16* qw = qs + (16 * warp + g) * LDK + 2 * t;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const __nv_bfloat16* p = qw + 16 * kk;
    qa[kk][0] = *reinterpret_cast<const unsigned*>(p);
    qa[kk][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDK);
    qa[kk][2] = *reinterpret_cast<const unsigned*>(p + 8);
    qa[kk][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDK + 8);
  }
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ktiles = (s + BK - 1) / BK;
  const int last = causal ? min(ktiles, (q0 + BQ - 1) / BK + 1) : ktiles;
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                    // ks, vs free again
    stage_bf16<DP>(k + kvh * plane, k0, BK, s, d, LDK, vec, ks);
    stage_bf16<DP>(v + kvh * plane, k0, BK, s, d, LDK, vec, vs);
    __syncthreads();
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* p = ks + (8 * j + g) * LDK + 16 * kk + 2 * t;
        mma_bf16(sc[j], qa[kk], *reinterpret_cast<const unsigned*>(p),
                 *reinterpret_cast<const unsigned*>(p + 8));
      }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float val = sc[j][e] * scale;
        if (col >= s || (causal && col > row)) val = NEG_INF;
        sc[j][e] = val;
        if (e < 2)
          mx0 = fmaxf(mx0, val);
        else
          mx1 = fmaxf(mx1, val);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(sc[j][e] - (e < 2 ? mn0 : mn1));
        sc[j][e] = pv;
        if (e < 2)
          sum0 += pv;
        else
          sum1 += pv;
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = al0 * l0 + sum0;
    l1 = al1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float* c0 = sc[2 * kk];
      const float* c1 = sc[2 * kk + 1];
      unsigned hi[4], lo[4];
      const float pv[8] = {c0[0], c0[1], c0[2], c0[3],
                           c1[0], c1[1], c1[2], c1[3]};
      float rest[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        rest[e] = pv[e] - __bfloat162float(__float2bfloat16_rn(pv[e]));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[r] = pack_bf16(pv[2 * r], pv[2 * r + 1]);
        lo[r] = pack_bf16(rest[2 * r], rest[2 * r + 1]);
      }
      const __nv_bfloat16* vrow =
          vs + (16 * kk + lane % 16) * LDK + 8 * (lane / 16);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        unsigned b[4];
        ldmatrix_x4_trans(b, vrow + 8 * n);
        mma_bf16(acc[n], hi, b[0], b[1]);
        mma_bf16(acc[n], lo, b[0], b[1]);
        mma_bf16(acc[n + 1], hi, b[2], b[3]);
        mma_bf16(acc[n + 1], lo, b[2], b[3]);
      }
    }
  }
  __nv_bfloat16* ob = o + bh * plane;
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * n + 2 * t + (e & 1);
      const int row = e < 2 ? row0 : row1;
      if (row < s && col < d)
        ob[static_cast<size_t>(row) * d + col] =
            __float2bfloat16_rn(acc[n][e] * (e < 2 ? inv0 : inv1));
    }
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               long long blocks, int hq, int hkv, int s, int d, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (BQ + 2 * BK) * (DP + 8);
  const int err = launch_with_smem(flash_mma_kernel<DP>, smem);
  if (err) return err;
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<size_t>(ptr) % 16 == 0;
  };
  const bool vec = d % 8 == 0 && aligned(q) && aligned(k) && aligned(v);
  flash_mma_kernel<DP><<<static_cast<unsigned>(blocks), kMmaThreads, smem,
                         stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), hq, hkv, s, d, causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 on Hopper: TMA, wgmma and warp specialisation
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;             // query rows per block: 2 x 64
constexpr int WG_BK = 128;             // keys per KV tile (S: m64n128)
constexpr int WG_STAGES = 3;           // K and V ring depth
constexpr int kWgThreads = 384;        // producer + two consumer warpgroups
constexpr int CHUNK = 64;              // columns per TMA box (128 bytes)
constexpr uint32_t ROW_BYTES = CHUNK * 2;
constexpr uint32_t Q_BOX = WG_BQ * ROW_BYTES;    // one chunk of the Q tile
constexpr uint32_t KV_BOX = WG_BK * ROW_BYTES;   // one chunk of a K/V tile
constexpr float LOG2E = 1.4426950408889634f;

// wgmma.m64nNk16, f32 += bf16 x bf16.  ss: A (64 x 16) and B (N x 16) both
// K-major in shared memory, scale_d 0 overwrites d.  rs: A from registers
// (the m16n8k16 A fragment of each warp's 16 rows), B (16 x N) MN-major in
// shared memory (transposed), accumulating.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R56
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma_rs_nN: accumulators ACC (operands 0 .. N/2 - 1, bound by the
// WG_D8 groups that follow), A's registers A0..A3, B's descriptor DB and
// the scale-d flag P.
#define WG_RS(N, A0, A1, A2, A3, DB, P, ACC, ...)                        \
  __device__ __forceinline__ void wgmma_rs_n##N(float* d, const uint32_t* a, \
                                                uint64_t db) {           \
    asm volatile(                                                        \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                 \
        "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" ACC \
        "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB             \
        ", p, 1, 1, 1;\n}\n"                                             \
        : __VA_ARGS__                                                    \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));  \
  }
WG_RS(16, 8, 9, 10, 11, 12, 13, WG_R0, WG_D8(0))
WG_RS(32, 16, 17, 18, 19, 20, 21, WG_R8, WG_D8(0), WG_D8(8))
WG_RS(48, 24, 25, 26, 27, 28, 29, WG_R16, WG_D8(0), WG_D8(8), WG_D8(16))
WG_RS(64, 32, 33, 34, 35, 36, 37, WG_R24, WG_D8(0), WG_D8(8), WG_D8(16),
      WG_D8(24))
WG_RS(80, 40, 41, 42, 43, 44, 45, WG_R32, WG_D8(0), WG_D8(8), WG_D8(16),
      WG_D8(24), WG_D8(32))
WG_RS(96, 48, 49, 50, 51, 52, 53, WG_R40, WG_D8(0), WG_D8(8), WG_D8(16),
      WG_D8(24), WG_D8(32), WG_D8(40))
WG_RS(112, 56, 57, 58, 59, 60, 61, WG_R48, WG_D8(0), WG_D8(8), WG_D8(16),
      WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48))
WG_RS(128, 64, 65, 66, 67, 68, 69, WG_R56, WG_D8(0), WG_D8(8), WG_D8(16),
      WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56))

#undef WG_RS

// d (64 x N) += A B: N = DP, the padded head width (B spans one or two
// 64-column atoms of V, LBO apart).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N % 16 == 0 && N >= 16 && N <= 128, "N");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  if constexpr (N == 48) wgmma_rs_n48(d, a, db);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  if constexpr (N == 112) wgmma_rs_n112(d, a, db);
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
}

// The online softmax of one KV tile on the S accumulator of a consumer
// warpgroup, in place: sc becomes P; returns the rescale factor of each of
// the thread's two rows.  Scores are taken in the log2 domain (``scale`` =
// log2(e) / sqrt(D) > 0, so the row max of the raw scores gives that of
// the scaled ones) and exp(s scale - m) is one FFMA and one ex2.  MASK
// only on the diagonal tile and the ragged tail.
template <bool MASK>
__device__ __forceinline__ void tile_softmax(float* sc, int k0, int row0,
                                             int s, int causal, float scale,
                                             int t, float& m0, float& m1,
                                             float& l0, float& l1,
                                             float& al0, float& al1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int i = 0; i < WG_BK / 2; ++i) {
    if (MASK) {
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int row = row0 + ((i & 2) ? 8 : 0);
      if (col >= s || (causal && col > row)) sc[i] = NEG_INF;
    }
    if (i & 2)
      mx1 = fmaxf(mx1, sc[i]);
    else
      mx0 = fmaxf(mx0, sc[i]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * scale), mn1 = fmaxf(m1, mx1 * scale);
  al0 = ex2(m0 - mn0);
  al1 = ex2(m1 - mn1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < WG_BK / 2; ++i) {
    const float p = ex2(fmaf(sc[i], scale, (i & 2) ? -mn1 : -mn0));
    sc[i] = p;
    if (i & 2)
      sum1 += p;
    else
      sum0 += p;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
  l0 = al0 * l0 + sum0;
  l1 = al1 * l1 + sum1;
  m0 = mn0;
  m1 = mn1;
}

// Block: 128 query rows of one (b, h); warpgroup 0 produces (one thread
// issues every TMA load), warpgroups 1 and 2 consume 64 rows each.  Shared
// memory (1024-byte aligned, each box in the 128-byte swizzle): the Q tile
// as NC chunks of 64 columns, then WG_STAGES stages of K and of V, each NC
// chunks, then the barriers: full_q, full_k[st], full_v[st], empty[st].
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int hq, int hkv, int s,
                   int d, int causal, float scale) {
  constexpr int NC = (DP + CHUNK - 1) / CHUNK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + NC * Q_BOX;
  const uint32_t sv = sk + WG_STAGES * NC * KV_BOX;
  const uint32_t bars = sv + WG_STAGES * NC * KV_BOX;
  const uint32_t full_q = bars;
  const auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  const auto full_v = [&](int st) { return bars + 8 * (1 + WG_STAGES + st); };
  const auto empty = [&](int st) {
    return bars + 8 * (1 + 2 * WG_STAGES + st);
  };

  // The q-tiles of one (b, h) are neighbours in blockIdx, so the blocks
  // in flight share a few heads' K and V in L2; within a head the longest
  // tile comes first, so the grid ends on short tiles.
  const int tiles = (s + WG_BQ - 1) / WG_BQ;
  const int bh = blockIdx.x / tiles;
  const int q0 = (tiles - 1 - static_cast<int>(blockIdx.x % tiles)) * WG_BQ;
  const int kvh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int ktiles = (s + WG_BK - 1) / WG_BK;
  const int ntiles =
      causal ? min(ktiles, (q0 + WG_BQ - 1) / WG_BK + 1) : ktiles;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < WG_STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 2 * 128);            // every consumer thread
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: keeps the ring full ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, NC * Q_BOX);
      for (int c = 0; c < NC; ++c)
        tma_load(sq + c * Q_BOX, &tq, full_q, c * CHUNK, q0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % WG_STAGES;
        const uint32_t phase = (j / WG_STAGES) & 1;
        mbar_wait(empty(st), phase ^ 1);
        mbar_expect_tx(full_k(st), NC * KV_BOX);
        for (int c = 0; c < NC; ++c)
          tma_load(sk + (st * NC + c) * KV_BOX, &tk, full_k(st), c * CHUNK,
                   j * WG_BK, kvh);
        mbar_expect_tx(full_v(st), NC * KV_BOX);
        for (int c = 0; c < NC; ++c)
          tma_load(sv + (st * NC + c) * KV_BOX, &tv, full_v(st), c * CHUNK,
                   j * WG_BK, kvh);
      }
    }
  } else {
    // ---- consumers: S = Q K^T, online softmax, O += P V ----
    // Tile j's products S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued
    // together; the softmax of S_j then runs while P_{j-1} V_{j-1} is on
    // the tensor cores, and stage j - 1 is released when that product is
    // done.
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int first = q0 + 64 * cw;               // this warpgroup's rows
    const int row0 = first + 16 * (threadIdx.x % 128 / 32) + lane / 4;
    const uint32_t qa = sq + cw * 64 * ROW_BYTES;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float acc[DP / 2], sc[WG_BK / 2];
    uint32_t hi[WG_BK / 16][4], lo[WG_BK / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    const auto stage_phase = [](int j) {
      return static_cast<uint32_t>(j / WG_STAGES) & 1u;
    };
    // S = Q K_j^T, issued and committed (one group).
    const auto issue_qk = [&](int j) {
      const int st = j % WG_STAGES;
      mbar_wait(full_k(st), stage_phase(j));
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;   // k-step in the row
        const uint32_t kb = sk + (st * NC + ks / 4) * KV_BOX + off;
        wgmma_ss_n128(sc, sw128_desc(qa + (ks / 4) * Q_BOX + off, 16),
                        sw128_desc(kb, 16), ks > 0);
      }
      wgmma_commit();
    };
    // O += P V_j with P in its hi and lo terms, issued and committed.
    const auto issue_pv = [&](int j) {
      const int st = j % WG_STAGES;
      mbar_wait(full_v(st), stage_phase(j));
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        const uint64_t vd = sw128_desc(
            sv + st * NC * KV_BOX + kk * 16 * ROW_BYTES, KV_BOX);
        wgmma_rs<DP>(acc, hi[kk], vd);
        wgmma_rs<DP>(acc, lo[kk], vd);
      }
      wgmma_commit();
    };
    // The softmax of S_j (masked on the diagonal tile and the ragged
    // tail), leaving P_j in sc; returns the rescale factors.
    const auto softmax = [&](int j, float& al0, float& al1) {
      const int k0 = j * WG_BK;
      if ((causal && k0 + WG_BK - 1 > first) || k0 + WG_BK > s)
        tile_softmax<true>(sc, k0, row0, s, causal, scale, t, m0, m1, l0, l1,
                           al0, al1);
      else
        tile_softmax<false>(sc, k0, row0, s, causal, scale, t, m0, m1, l0,
                            l1, al0, al1);
    };
    // P in two bf16 terms, hi = bf16(P) and lo = bf16(P - hi), as the A
    // fragments of P V: the accumulator layout of S is the A layout.  The
    // rounded hi values are read back from the packed bits (P - hi is
    // exact in float32).
    const auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = sc[8 * kk + 2 * r], b = sc[8 * kk + 2 * r + 1];
          const uint32_t h = pack_bf16(a, b);
          hi[kk][r] = h;
          lo[kk][r] = pack_bf16(a - __uint_as_float(h << 16),
                                b - __uint_as_float(h & 0xffff0000u));
        }
    };

    mbar_wait(full_q, 0);
    float al0, al1;
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs<WG_BK / 2>(sc);
    softmax(0, al0, al1);
    split_p();
    for (int j = 1; j < ntiles; ++j) {
      fence_regs<DP / 2>(acc);
      wgmma_fence();
      issue_qk(j);
      issue_pv(j - 1);
      wgmma_wait<1>();                            // S_j is in
      fence_regs<WG_BK / 2>(sc);
      softmax(j, al0, al1);
      wgmma_wait<0>();                            // P_{j-1} V_{j-1} done
      fence_regs<DP / 2>(acc);
      mbar_arrive(empty((j - 1) % WG_STAGES));
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;
      split_p();
    }
    fence_regs<DP / 2>(acc);
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_wait<0>();
    fence_regs<DP / 2>(acc);
    mbar_arrive(empty((ntiles - 1) % WG_STAGES));
    const size_t plane = static_cast<size_t>(s) * d;
    __nv_bfloat16* ob = o + bh * plane;
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int col = 8 * (i / 4) + 2 * t;
      const int row = row0 + ((i & 2) ? 8 : 0);
      const float inv = (i & 2) ? inv1 : inv0;
      if (row < s && col < d)
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<size_t>(row) * d + col) =
            __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
    }
  }
}

// A (planes, s, d) bf16 tensor as a 3-D map read in boxes of 64 columns x
// ``rows`` rows of one plane, 128-byte swizzled; the TMA fills rows past s
// and columns past d with zeros.  Returns a CUDA error code.
int encode_map(CUtensorMap* map, const void* base, int planes, int s, int d,
               int rows) {
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                            planes, s, d, CHUNK, rows);
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b,
                 int hq, int hkv, int s, int d, int causal, float scale,
                 cudaStream_t stream) {
  constexpr int NC = (DP + CHUNK - 1) / CHUNK;
  const size_t smem =
      1024 + NC * (Q_BOX + 2 * WG_STAGES * KV_BOX) + 8 * (1 + 3 * WG_STAGES);
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, b * hq, s, d, WG_BQ);
  if (!err) err = encode_map(&tk, k, b * hkv, s, d, WG_BK);
  if (!err) err = encode_map(&tv, v, b * hkv, s, d, WG_BK);
  if (!err) err = launch_with_smem(flash_wgmma_kernel<DP>, smem);
  if (err) return err;
  const long long blocks =
      static_cast<long long>(b) * hq * ((s + WG_BQ - 1) / WG_BQ);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  flash_wgmma_kernel<DP><<<static_cast<unsigned>(blocks), kWgThreads, smem,
                           stream>>>(tq, tk, tv,
                                     static_cast<__nv_bfloat16*>(o), hq, hkv,
                                     s, d, causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// The launch checks every dtype shares: returns a CUDA error code, or -1
// when there is nothing to launch, else 0 with ``blocks`` set.
int check_launch(int b, int hq, int hkv, int s, int d, long long* blocks) {
  if (b == 0 || hq == 0 || s == 0 || d == 0) return -1;
  if (d > DMAX || hkv == 0 || hq % hkv) return cudaErrorInvalidValue;
  *blocks = static_cast<long long>(b) * hq * ((s + BQ - 1) / BQ);
  if (*blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  return 0;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int b, int hq,
                                   int hkv, int s, int d, int causal,
                                   double scale, void* stream) {
  long long blocks = 0;
  const int bad = check_launch(b, hq, hkv, s, d, &blocks);
  if (bad) return bad < 0 ? 0 : bad;
  const int ld = d | 1;
  const size_t smem = sizeof(float) * ((BQ + 2 * BK) * ld + BQ * (BK + 1));
  const int err = launch_with_smem(flash_kernel, smem);
  if (err) return err;
  flash_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, s, d,
      causal, static_cast<float>(scale));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int hq,
                                    int hkv, int s, int d, int causal,
                                    double scale, void* stream) {
  long long blocks = 0;
  const int bad = check_launch(b, hq, hkv, s, d, &blocks);
  if (bad) return bad < 0 ? 0 : bad;
  const auto st = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  switch ((d + 15) / 16) {
    case 1: return launch_mma<16>(q, k, v, o, blocks, hq, hkv, s, d, causal, sc, st);
    case 2: return launch_mma<32>(q, k, v, o, blocks, hq, hkv, s, d, causal, sc, st);
    case 3: return launch_mma<48>(q, k, v, o, blocks, hq, hkv, s, d, causal, sc, st);
    case 4: return launch_mma<64>(q, k, v, o, blocks, hq, hkv, s, d, causal, sc, st);
    case 5: return launch_mma<80>(q, k, v, o, blocks, hq, hkv, s, d, causal, sc, st);
    case 6: return launch_mma<96>(q, k, v, o, blocks, hq, hkv, s, d, causal, sc, st);
    case 7: return launch_mma<112>(q, k, v, o, blocks, hq, hkv, s, d, causal, sc, st);
    default: return launch_mma<128>(q, k, v, o, blocks, hq, hkv, s, d, causal, sc, st);
  }
}

// bfloat16 through TMA and wgmma: needs d % 8 == 0 (TMA row strides are
// multiples of 16 bytes) and 16-byte aligned q, k and v; the wrapper sends
// other bfloat16 inputs to flash_attention_bf16.
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k,
                                          const void* v, void* o, int b,
                                          int hq, int hkv, int s, int d,
                                          int causal, double scale,
                                          void* stream) {
  long long blocks = 0;
  const int bad = check_launch(b, hq, hkv, s, d, &blocks);
  if (bad) return bad < 0 ? 0 : bad;
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<size_t>(ptr) % 16 == 0;
  };
  if (d % 8 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  switch ((d + 15) / 16) {
    case 1: return launch_wgmma<16>(q, k, v, o, b, hq, hkv, s, d, causal, sc, st);
    case 2: return launch_wgmma<32>(q, k, v, o, b, hq, hkv, s, d, causal, sc, st);
    case 3: return launch_wgmma<48>(q, k, v, o, b, hq, hkv, s, d, causal, sc, st);
    case 4: return launch_wgmma<64>(q, k, v, o, b, hq, hkv, s, d, causal, sc, st);
    case 5: return launch_wgmma<80>(q, k, v, o, b, hq, hkv, s, d, causal, sc, st);
    case 6: return launch_wgmma<96>(q, k, v, o, b, hq, hkv, s, d, causal, sc, st);
    case 7: return launch_wgmma<112>(q, k, v, o, b, hq, hkv, s, d, causal, sc, st);
    default: return launch_wgmma<128>(q, k, v, o, b, hq, hkv, s, d, causal, sc, st);
  }
}

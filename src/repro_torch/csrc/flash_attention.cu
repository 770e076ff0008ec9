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
// Design.  One block per (b Hq, 64-row query tile); the KV tiles of 64
// rows run in a loop inside the block up to the diagonal: tiles above it
// are never loaded.  The TPU kernel's sequential KV grid axis, whose VMEM
// accumulators persist across steps, does not carry over (blocks run in
// no order here), so each block keeps its running max, sum and
// accumulator in registers.  Query head h reads KV head h / (Hq / Hkv): no
// KV copy per query head.
//   bfloat16 (the model's path): 4 warps, each owning 16 query rows, on
//   the tensor cores through mma.sync.m16n8k16 (bf16 in, f32 out).  Q's
//   fragments stay in registers; K and V tiles are staged in shared
//   memory by 16-byte copies, rows padded by 16 bytes (conflict-free
//   fragment loads; V's B fragments through ldmatrix.trans).  S = Q K^T
//   lands in the accumulator layout, the online softmax reduces each row
//   over the 4 lanes of a quad, and P is fed back from registers as the A
//   operand of P V.  P is split into two bf16 terms, hi = bf16(P) and
//   lo = bf16(P - hi), and P V takes one product for each, so P keeps ~16
//   bits as the plain version's float32 P does (a single bf16 P moves
//   outputs by more than their own rounding step).  D is padded to a
//   multiple of 16 with zeros (a template per padded width).
//   float32 (tests, the reduced config): 256 threads on CUDA cores, thread
//   (ty, tx) owning rows ty + 16 i and score columns tx + 16 j (i, j < 4)
//   and output columns tx + 16 c; float32 FMAs, a row's max and sum
//   reduced over the 16 lanes that share it.
// cp.async / TMA staging, wgmma and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernel_epilogue.cuh"

namespace {

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

// The SSD intra-chunk block of Mamba2 (state-space duality, Dao & Gu
// 2024, Alg. 1's diagonal block), per (head, chunk):
//
//   y[i] = sum_{j <= i} (c[i] . b[j]) exp(cs[i] - cs[j]) xdt[j]
//
// i.e. Y = ((C B^T) * L) (X dt) with L[i][j] = exp(cs_i - cs_j) for i >= j
// and 0 above the diagonal.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk/ssd_chunk.py::ssd_intra_chunk (body _body).
//
// Shapes: c and b (BH, nc, Q, N), xdt (BH, nc, Q, P), cs (BH, nc, Q) -> y
// (BH, nc, Q, P), all float32, row-major and contiguous.  Q <= 256, N and
// P <= 128.  Every product and sum is an IEEE float32 FMA (no TF32): the
// reference computes in float32.  L is evaluated only where i >= j: above
// the diagonal cs_i - cs_j is positive (cs is a cumulative sum of
// negative steps) and its exp can overflow, and inf * 0 would give NaN.
//
// Bound on the H100: operations.  At Zamba2-7B's prefill (BH = 4 x 112,
// nc 15, Q 256, N = P = 64) the causal half of C B^T and of (S L) X is
// (Q^2 / 2)(2N + 2P) BH nc = 56 GFLOP, 0.84 ms at 67 TFLOP/s float32,
// against 0.53 ms for the 1.76 GB of inputs and output at 3.35 TB/s.
//
// Design: the Pallas kernel holds a whole (Q, Q) float32 score tile per
// (head, chunk); at Q = 256 that is 256 KB, above the 227 KB a Hopper block
// can have.  So a block of 256 threads owns one 64-row query tile of one
// (head, chunk): its C rows and cumulative sums stay in shared memory,
// and it walks the key tiles j <= i: B_j and X_j staged, S = C_i B_j^T in
// registers (thread (ty, tx): rows ty + 16 r, columns tx + 16 u), S * L
// through shared memory, Y_i += (S * L) X_j in registers (columns
// tx + 16 c).  Shared rows have an odd stride, so the 16 rows one warp
// reads at a time fall in 16 banks.  A ragged Q is masked.
#include <cuda_runtime.h>

#include "kernel_epilogue.cuh"

namespace {

constexpr int BQ = 64, kThreads = 256, WMAX = 128, QMAX = 256;

// Rows [r0, r0 + rows) of a (q, w) matrix into shared rows of stride ld,
// zero past q.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int r0, int q, int w, int ld,
                                          float* dst) {
  for (int e = threadIdx.x; e < BQ * w; e += kThreads) {
    const int r = e / w, c = e % w;
    const int row = r0 + r;
    dst[r * ld + c] = row < q ? src[static_cast<size_t>(row) * w + c] : 0.f;
  }
}

// TC = ceil(P / 16): output columns per thread (a template, so no FMA is
// spent on columns past P).
template <int TC>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ c, const float* __restrict__ b,
           const float* __restrict__ xdt, const float* __restrict__ cs,
           float* __restrict__ y, int q, int n, int p) {
  extern __shared__ float smem[];
  const int ldn = n | 1, ldp = p | 1;
  float* cq = smem;                     // BQ x ldn
  float* bk = cq + BQ * ldn;            // BQ x ldn
  float* xk = bk + BQ * ldn;            // BQ x ldp
  float* sl = xk + BQ * ldp;            // BQ x (BQ + 1)
  float* csq = sl + BQ * (BQ + 1);      // BQ
  float* csk = csq + BQ;                // BQ
  const int tiles = (q + BQ - 1) / BQ;
  const size_t chunk = blockIdx.x / tiles;   // bh * nc + chunk index
  const int it = blockIdx.x % tiles;
  const int i0 = it * BQ;
  const float* cb = c + chunk * q * n;
  const float* bb = b + chunk * q * n;
  const float* xb = xdt + chunk * q * p;
  const float* csb = cs + chunk * q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile(cb, i0, q, n, ldn, cq);
  if (threadIdx.x < BQ)
    csq[threadIdx.x] = i0 + threadIdx.x < q ? csb[i0 + threadIdx.x] : 0.f;
  float acc[4][TC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < TC; ++cc) acc[r][cc] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * BQ;
    __syncthreads();                    // bk, xk, sl free again
    load_tile(bb, j0, q, n, ldn, bk);
    load_tile(xb, j0, q, p, ldp, xk);
    if (threadIdx.x < BQ)
      csk[threadIdx.x] = j0 + threadIdx.x < q ? csb[j0 + threadIdx.x] : 0.f;
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[r][u] = 0.f;
    for (int t = 0; t < n; ++t) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = cq[(ty + 16 * r) * ldn + t];
#pragma unroll
      for (int u = 0; u < 4; ++u) bv[u] = bk[(tx + 16 * u) * ldn + t];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[r][u] = fmaf(cv[r], bv[u], s[r][u]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int li = ty + 16 * r, row = i0 + li;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int lj = tx + 16 * u, col = j0 + lj;
        const float lval = (row >= col && row < q && col < q)
                               ? expf(csq[li] - csk[lj]) : 0.f;
        sl[li * (BQ + 1) + lj] = s[r][u] * lval;
      }
    }
    __syncthreads();
    for (int j = 0; j < BQ; ++j) {
      float xv[TC];
#pragma unroll
      for (int cc = 0; cc < TC; ++cc) {
        const int col = tx + 16 * cc;
        xv[cc] = col < p ? xk[j * ldp + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float w = sl[(ty + 16 * r) * (BQ + 1) + j];
#pragma unroll
        for (int cc = 0; cc < TC; ++cc) acc[r][cc] = fmaf(w, xv[cc], acc[r][cc]);
      }
    }
  }
  float* yb = y + chunk * q * p;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = i0 + ty + 16 * r;
    if (row >= q) continue;
#pragma unroll
    for (int cc = 0; cc < TC; ++cc) {
      const int col = tx + 16 * cc;
      if (col < p) yb[static_cast<size_t>(row) * p + col] = acc[r][cc];
    }
  }
}

template <int TC>
int launch(const void* c, const void* b, const void* xdt, const void* cs,
           void* y, long long blocks, int q, int n, int p, size_t smem,
           cudaStream_t stream) {
  const int err = launch_with_smem(ssd_kernel<TC>, smem);
  if (err) return err;
  ssd_kernel<TC><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(c), static_cast<const float*>(b),
      static_cast<const float*>(xdt), static_cast<const float*>(cs),
      static_cast<float*>(y), q, n, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_intra_chunk_f32(const void* c, const void* b,
                                   const void* xdt, const void* cs, void* y,
                                   int chunks, int q, int n, int p,
                                   void* stream) {
  if (chunks == 0 || q == 0 || p == 0) return 0;
  if (q > QMAX || n > WMAX || p > WMAX) return cudaErrorInvalidValue;
  const int ldn = n | 1, ldp = p | 1;
  const size_t smem = sizeof(float) *
      (2 * BQ * ldn + BQ * ldp + BQ * (BQ + 1) + 2 * BQ);
  const long long blocks =
      static_cast<long long>(chunks) * ((q + BQ - 1) / BQ);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((p + 15) / 16) {
    case 1: return launch<1>(c, b, xdt, cs, y, blocks, q, n, p, smem, st);
    case 2: return launch<2>(c, b, xdt, cs, y, blocks, q, n, p, smem, st);
    case 3: return launch<3>(c, b, xdt, cs, y, blocks, q, n, p, smem, st);
    case 4: return launch<4>(c, b, xdt, cs, y, blocks, q, n, p, smem, st);
    case 5: return launch<5>(c, b, xdt, cs, y, blocks, q, n, p, smem, st);
    case 6: return launch<6>(c, b, xdt, cs, y, blocks, q, n, p, smem, st);
    case 7: return launch<7>(c, b, xdt, cs, y, blocks, q, n, p, smem, st);
    default: return launch<8>(c, b, xdt, cs, y, blocks, q, n, p, smem, st);
  }
}

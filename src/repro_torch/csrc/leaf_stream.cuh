// A leaf's big row-major matrices streamed once through shared memory in
// row panels, and the two products each panel feeds, shared by the
// leaf_matvec (B5, leaf_matvec.cu) and leaf_update (B13, leaf_update.cu)
// kernels.  A block of kThreads = 256 threads walks its leaves (persistent
// blocks, launch_persistent: leaf blockIdx.x, then + gridDim.x, ...) as one
// stream of panels of 8 RW rows (RW rows a warp) through a ring of two
// slots (stream_panels):
//
//   panel s:  wait for panel s; barrier; copy panel s + 1 into the slot
//             panel s - 1 left; compute on panel s
//
// so one panel is in flight behind the one in use, across the end of a
// leaf too (the next leaf's first panel and right-hand side load while the
// current leaf finishes; two blocks an SM in float32).  A panel is a flat
// span of the leaf's matrix, rows i0 .. i0 + rows: copy_span takes its
// 16-byte-aligned interior with 16-byte cp.async copies and the head and
// tail (leaves of 167 x 167 floats start 0, 4, 8 or 12 bytes past a
// 16-byte boundary, and so do their panels) one element each, and keeps
// the span's alignment in shared memory (element e at offset e -
// floor(e0) from a 16-byte-aligned slot).
//
// The products, for the panel's rows i (stride n) and a small k-column
// block X in shared memory (row stride ldx, 4 x an odd number of elements,
// so that 16-byte reads of neighbouring rows fall on distinct banks):
//   rows_times       out[i][q] = sum_j P[i][j] X[j][q]: warp w takes rows
//                    RW w .. RW w + RW - 1 of every 8 RW (RW = 4 or 2, a
//                    panel's rows / 8), lane l the columns j = l, l + 32,
//                    ..., KT right-hand sides at a time (KT = 1 for k = 1,
//                    else 8): RW KT partial sums a lane, each a chain of
//                    fused multiply-adds in ascending j, then summed over
//                    the 32 lanes by warp_sum_spread (RW KT values in
//                    about as many shuffles where one at a time takes 5
//                    each);
//   cols_accumulate  acc[q][j] += sum_i P[i][j] X[i][q]: thread t takes
//                    column j = t mod 128 (and + 128, ...) and either the
//                    panel's rows i = t / 128 (mod 2) of every right-hand-
//                    side tile (B5: the leaf's result is group 0's sum
//                    plus group 1's) or all rows of every other tile
//                    (B13, whose k spans two tiles): a chain of fused
//                    multiply-adds in ascending i, carried across the
//                    leaf's panels in shared memory.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "async_copy.cuh"
#include "kernel_epilogue.cuh"

namespace leaf_stream {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColThreads = 128;          // cols_accumulate: threads a row
constexpr int kGroups = kThreads / kColThreads;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

// Elements of a panel slot of rows x cols: the span plus the 16 / sizeof(T)
// - 1 elements its alignment may shift it by, in whole 16-byte pieces.
template <typename T>
__host__ __device__ inline size_t panel_elems(int rows, int cols) {
  constexpr size_t v = 16 / sizeof(T);
  return (static_cast<size_t>(rows) * cols + 2 * v - 2) / v * v;
}

// ``n`` elements rounded up to whole 16-byte pieces.
template <typename T>
__host__ __device__ inline size_t pad16(size_t n) {
  constexpr size_t v = 16 / sizeof(T);
  return (n + v - 1) / v * v;
}

// Where element e0 of a span lands in its slot: e0 mod v (v = 16 / sizeof(T)
// where the matrix's base is 16-byte aligned, else 1: every element copied
// alone; a power of two, so no division).
__device__ __forceinline__ int span_offset(long long e0, int v) {
  return static_cast<int>(e0 & (v - 1));
}

// Issues the cp.async copies of elements [e0, e1) of ``src`` to dst[e - e0
// + span_offset(e0, v)], by all threads of the block.
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, long long e0,
                                          long long e1, int v) {
  const int tid = threadIdx.x;
  if (v == 1) {
    for (long long e = e0 + tid; e < e1; e += kThreads)
      acopy::element(dst + (e - e0), src + e, true);
    return;
  }
  const long long mask = ~static_cast<long long>(v - 1);
  const long long a0 = e0 & mask;                      // slot start
  const long long h = min(e1, (e0 + v - 1) & mask);    // head end
  const long long t0 = max(h, e1 & mask);              // tail start
  const int pieces = static_cast<int>(t0 - h) >> (v == 4 ? 2 : 1);
  T* d = dst + (h - a0);
  const T* s = src + h;
  for (int c = tid; c < pieces; c += kThreads)
    acopy::bytes16(d + c * v, s + c * v, true);
  if (tid < h - e0) acopy::element(dst + (e0 - a0) + tid, src + e0 + tid, true);
  const int back = kThreads - 1 - tid;                 // tail: the last threads
  if (back < e1 - t0)
    acopy::element(dst + (t0 - a0) + back, src + t0 + back, true);
}

// KT values from x (16-byte aligned where KT > 1).
template <int KT>
__device__ __forceinline__ void load_row(float (&v)[KT], const float* x) {
  if constexpr (KT == 1) {
    v[0] = x[0];
  } else {
#pragma unroll
    for (int q = 0; q < KT / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(x)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  }
}

template <int KT>
__device__ __forceinline__ void load_row(double (&v)[KT], const double* x) {
  if constexpr (KT == 1) {
    v[0] = x[0];
  } else {
#pragma unroll
    for (int q = 0; q < KT / 2; ++q) {
      const double2 f = reinterpret_cast<const double2*>(x)[q];
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  }
}

// Sums NV values (a power of two <= 32) over the 32 lanes of a warp: at
// each of the five steps a lane that still holds n > 1 values keeps one
// half, sends the other to the lane ``o`` away (o = 16, 8, 4, 2, 1) and
// adds what that lane sends of its own half; once n = 1 the steps are
// plain butterflies.  Returns value number spread_index<NV>(lane), summed
// over all lanes (every lane of a group of 32 / NV holds it).
template <int S, int NV, typename T>
__device__ __forceinline__ void spread_steps(T (&v)[NV], int lane) {
  if constexpr (S < 5) {
    constexpr int o = 16 >> S, n = NV >> S;
    if constexpr (n > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int t = 0; t < n / 2; ++t) {
        const T send = up ? v[t] : v[t + n / 2];
        const T keep = up ? v[t + n / 2] : v[t];
        v[t] = keep + __shfl_xor_sync(kFull, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], o);
    }
    spread_steps<S + 1>(v, lane);
  }
}

template <int NV, typename T>
__device__ __forceinline__ T warp_sum_spread(T (&v)[NV], int lane) {
  spread_steps<0>(v, lane);
  return v[0];
}

template <int NV>
__device__ __forceinline__ int spread_index(int lane) {
  int idx = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s)
    if ((NV >> s) > 1 && (lane & (16 >> s))) idx += (NV >> s) / 2;
  return idx;
}

// out(i, q, value) for the panel's rows i < nrows and q < k: value = sum_j
// P[i][j] X[j][q] over j < n, P's rows at stride n, X's at stride ldx
// (16-byte aligned where KT > 1, with columns up to k rounded up to KT).
// Warp w takes rows RW w .. RW w + RW - 1 of every 8 RW (rows past nrows
// are read inside the slot and not written).
template <int RW, int KT, typename T, typename Out>
__device__ __forceinline__ void rows_times(const T* P, int nrows, int n,
                                           const T* X, int ldx, int k,
                                           Out out) {
  constexpr int NV = RW * KT;
  const int lane = threadIdx.x & 31;
  const int idx = spread_index<NV>(lane);
  const bool writer = (lane & (32 / NV - 1)) == 0;
  for (int i0 = RW * (threadIdx.x >> 5); i0 < nrows; i0 += kWarps * RW) {
    const T* p0 = P + i0 * n;
    const int row = i0 + idx / KT, qi = idx % KT;
    for (int q0 = 0; q0 < k; q0 += KT) {
      T acc[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q) acc[q] = T(0);
#pragma unroll 2
      for (int j = lane; j < n; j += 32) {
        T a[RW], x[KT];
#pragma unroll
        for (int r = 0; r < RW; ++r) a[r] = p0[r * n + j];
        load_row<KT>(x, X + j * ldx + q0);
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int q = 0; q < KT; ++q)
            acc[r * KT + q] = fmadd(a[r], x[q], acc[r * KT + q]);
      }
      const T sum = warp_sum_spread<NV>(acc, lane);
      if (writer && row < nrows && q0 + qi < k) out(row, q0 + qi, sum);
    }
  }
}

// acc[(g k + q) m + j] = (first ? 0 : itself) + sum_i P[i][j] X[i][q] for
// j < m and q < k, over the panel's rows i < nrows; P's rows at stride m,
// X's at stride ldx (columns up to k rounded up to KT).  Thread t takes
// column t mod 128 (and + 128, ...) and, with kSplitTiles false, the rows
// i = g (mod 2) of every tile of KT right-hand sides, g = t / 128, into
// its group's sums (k columns each); with kSplitTiles true, every row of
// the tiles g, g + 2, ..., into one set of sums.  Each thread reads and
// writes only its own entries of acc.
template <int KT, bool kSplitTiles, typename T>
__device__ __forceinline__ void cols_accumulate(const T* P, int nrows, int m,
                                                const T* X, int ldx, int k,
                                                T* acc, bool first) {
  const int g = threadIdx.x / kColThreads;
  const int i_first = kSplitTiles ? 0 : g;
  const int i_step = kSplitTiles ? 1 : kGroups;
  const int q_first = kSplitTiles ? g * KT : 0;
  const int q_step = kSplitTiles ? kGroups * KT : KT;
  T* sums = acc + (kSplitTiles ? 0 : static_cast<size_t>(g) * k * m);
  for (int j = threadIdx.x % kColThreads; j < m; j += kColThreads) {
    for (int q0 = q_first; q0 < k; q0 += q_step) {
      T* cs = sums + static_cast<size_t>(q0) * m + j;
      T a[KT];
#pragma unroll
      for (int q = 0; q < KT; ++q)
        a[q] = first || q0 + q >= k ? T(0) : cs[q * m];
#pragma unroll 2
      for (int i = i_first; i < nrows; i += i_step) {
        const T pij = P[i * m + j];
        T x[KT];
        load_row<KT>(x, X + i * ldx + q0);
#pragma unroll
        for (int q = 0; q < KT; ++q) a[q] = fmadd(pij, x[q], a[q]);
      }
#pragma unroll
      for (int q = 0; q < KT; ++q)
        if (q0 + q < k) cs[q * m] = a[q];
    }
  }
}

// A position in the block's stream of panels: leaf t of the block (its
// index ``leaf``), panel pi of it, its ring slot; the leaf's staged
// right-hand side is buffer t mod 2 (the next leaf's loads while the
// current one is in use).
struct Cursor {
  int t = 0, pi = 0, slot = 0;
  long long leaf;
  __device__ Cursor() : leaf(blockIdx.x) {}
  __device__ int buf() const { return t & 1; }
  __device__ void next(int npl) {
    slot ^= 1;
    if (++pi == npl) {
      pi = 0;
      ++t;
      leaf += gridDim.x;
    }
  }
};

// The block's walk over its leaves of ``p``, ``npl`` panels a leaf: for
// each panel c in turn, issue(c) issues its cp.async copies (into ring
// slot c.slot; with c.pi == 0 the leaf's right-hand side into buffer
// c.buf() too) one panel ahead, and body(c) computes on it once it has
// landed and every thread is past the previous panel's body.
template <typename Issue, typename Body>
__device__ __forceinline__ void stream_panels(int p, int npl, Issue issue,
                                              Body body) {
  const int b = blockIdx.x;
  const int nleaf = p > b ? (p - 1 - b) / static_cast<int>(gridDim.x) + 1 : 0;
  Cursor in;                       // the next panel to copy
  auto copy_next = [&]() {
    if (in.t < nleaf) {
      issue(in);
      in.next(npl);
    }
    acopy::commit();
  };
  copy_next();
  for (Cursor at; at.t < nleaf; at.next(npl)) {
    acopy::wait<0>();
    __syncthreads();               // panel at has landed; slot at ^ 1 is free
    copy_next();
    body(at);
  }
}

// Launches ``kernel`` with persistent blocks of kThreads: per_sm an SM (or
// as many as its occupancy allows, at least one), at most one a leaf of p.
template <typename Args>
int launch_persistent(void (*kernel)(Args), const Args& a, int p, int per_sm,
                      size_t smem, cudaStream_t stream) {
  int err = launch_with_smem(kernel, smem);
  if (err) return err;
  int dev = 0, sms = 0, occ = 0;
  if ((err = static_cast<int>(cudaFuncSetAttribute(
           kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared))) ||
      (err = static_cast<int>(cudaGetDevice(&dev))) ||
      (err = static_cast<int>(cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev))) ||
      (err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, kThreads, smem))))
    return err;
  const long long blocks = static_cast<long long>(sms) *
                           std::max(1, std::min(per_sm, occ));
  kernel<<<static_cast<unsigned>(std::min<long long>(p, blocks)), kThreads,
           smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace leaf_stream

// Fused per-query cross-kernel evaluation and weight contraction of HCK
// Algorithm 3, phase 2 (the oos_local and oos_walk stages):
//
//   z_i = sum_s W_s[widx_s,i]^T k(P_s[pidx_s,i], x_i)
//
// over one segment (a stage alone) or two (oos_local and oos_walk in one
// launch: the leaf block and the parent's landmark block of each query).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/oos_stage/oos_stage.py::oos_contract_kernel
//   (_contract_body).
//
// Shapes per segment: points (Bp, m, d), weights (Bw, m, k), pidx and
// widx (q,) int64; queries (q, d) -> z (q, k).  All row-major and
// contiguous; T is float or double and every sum is taken in T.  The TPU
// kernel took per-query blocks gathered beforehand ((q, m, d) and (q, m,
// k) copies in device memory); this kernel reads each query's blocks in
// place through the block indices.  A query with an index outside [0, Bp)
// or [0, Bw) in any segment gets a NaN row instead of an out-of-bounds
// read.
//
// Bound on the H100: bytes.  Per query and segment it does m (3d + 2k)
// flops on the m (d + k) values of its blocks; queries arrive sorted by
// leaf, so neighbouring queries share blocks, and the least traffic is
// the distinct blocks a batch touches plus the queries and the output
// (~0.024 ms for a 4,096-query oos_local bucket at covtype width, f32).
//
// Design: persistent blocks of up to four warps (three at covtype width,
// 189 KB), one warp a query at a time; each warp walks a contiguous run of
// the (sorted) queries and,
// per query, its segments (and, where a block does not fit a slot, its
// chunks of `rows` rows).  A warp owns two slots of shared memory for
// point blocks, two for weight blocks and two for query rows.  While it
// computes one item it copies the next item's blocks flat with cp.async
// (16-byte pieces where the blocks' sizes and bases allow, else 8 or 4)
// into the slots the current item does not use; a block whose tag
// (segment, block index, chunk) equals a slot's is not copied again, so a
// query reuses the previous query's leaf block, and the walk segment its
// sibling's parent landmarks.  Lanes own rows (lane + 32 i); the distance
// is a direct sum of (p - x)^2 or |p - x| over features, read VW features
// at a time (VW the widest of 4, 2, 1 elements within 16 bytes that
// divides d); when d / VW is even each lane starts at its own feature
// (lane mod d / VW), so rows of an even stride do not share banks.  The
// epilogue is the shared kernel_epilogue.cuh; the weighted sums read the
// weight block from shared memory, 8 output columns at a time, reduced
// across the warp with shuffles and kept in registers over the query's
// items (for k > 8 added into the query's output row).  A warp reads the
// block indices of 32 queries at once and hands them out with shuffles.
// Each warp keeps at most one block copy in flight beside the item it
// computes, and that, not the arithmetic, bounds the kernel.
//
// The bfloat16-data entry (oos_contract_bf16; a mixed-precision policy's
// prediction): points and queries (S) are bfloat16, weights and the
// output (T) float32.  The blocks are staged in shared memory as they lie
// in device memory, so a bfloat16 point slot holds half the bytes (pieces
// of 2 bytes, plain loads and stores, where a block's base or size is not
// a multiple of 4: data_copy); each feature is converted to float32 as
// the distance reads it, and from there the entry computes what the
// float32 entry computes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>

#include <algorithm>
#include <cstdint>

#include "async_copy.cuh"
#include "kernel_epilogue.cuh"

namespace {

constexpr int kMaxWarps = 4;
constexpr int RB = 4;  // rows a lane holds per batch (a batch: 128 rows)
constexpr int KT = 8;  // output columns reduced together

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() { return CUDART_NAN_F; }
template <>
__device__ __forceinline__ double quiet_nan<double>() { return CUDART_NAN; }

template <typename T, int VW>
struct Vec;
template <>
struct Vec<float, 1> { using type = float; };
template <>
struct Vec<float, 2> { using type = float2; };
template <>
struct Vec<float, 4> { using type = float4; };
template <>
struct Vec<double, 1> { using type = double; };
template <>
struct Vec<double, 2> { using type = double2; };
struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};
template <>
struct Vec<__nv_bfloat16, 1> { using type = __nv_bfloat16; };
template <>
struct Vec<__nv_bfloat16, 2> { using type = __nv_bfloat162; };
template <>
struct Vec<__nv_bfloat16, 4> { using type = bf16x4; };

// acc + (p - x)^2 or acc + |p - x|, element by element
template <typename T, bool L1>
__device__ __forceinline__ T term(T acc, T p, T x) {
  const T diff = p - x;
  return L1 ? acc + (diff < T(0) ? -diff : diff) : fma(diff, diff, acc);
}

template <typename T, bool L1>
__device__ __forceinline__ T dist(T acc, T p, T x) {
  return term<T, L1>(acc, p, x);
}
template <typename T, bool L1>
__device__ __forceinline__ T dist(T acc, float2 p, float2 x) {
  return term<T, L1>(term<T, L1>(acc, p.x, x.x), p.y, x.y);
}
template <typename T, bool L1>
__device__ __forceinline__ T dist(T acc, float4 p, float4 x) {
  acc = term<T, L1>(term<T, L1>(acc, p.x, x.x), p.y, x.y);
  return term<T, L1>(term<T, L1>(acc, p.z, x.z), p.w, x.w);
}
template <typename T, bool L1>
__device__ __forceinline__ T dist(T acc, double2 p, double2 x) {
  return term<T, L1>(term<T, L1>(acc, p.x, x.x), p.y, x.y);
}
template <typename T, bool L1>
__device__ __forceinline__ T dist(T acc, __nv_bfloat16 p, __nv_bfloat16 x) {
  return term<T, L1>(acc, __bfloat162float(p), __bfloat162float(x));
}
template <typename T, bool L1>
__device__ __forceinline__ T dist(T acc, __nv_bfloat162 p, __nv_bfloat162 x) {
  acc = term<T, L1>(acc, __low2float(p), __low2float(x));
  return term<T, L1>(acc, __high2float(p), __high2float(x));
}
template <typename T, bool L1>
__device__ __forceinline__ T dist(T acc, bf16x4 p, bf16x4 x) {
  return dist<T, L1>(dist<T, L1>(acc, p.lo, x.lo), p.hi, x.hi);
}

struct Segment {
  const void* points;     // (bp, m, d), of the data type S
  const void* weights;    // (bw, m, k), of the weights' type T
  const long long* pidx;  // (q,)
  const long long* widx;  // (q,)
  long long bp, bw;
  int m;
  int pw, ww;  // copy widths (bytes) of point and weight blocks
};

struct Args {
  Segment seg[2];
  const void* queries;  // (q, d)
  void* out;            // (q, k)
  int nseg, q, d, k;
  int rows;   // rows a slot holds
  int warps;  // warps a block
  int xw;     // copy width (bytes) of a query row
  int pslot, wslot, xslot;  // elements of one slot (16-byte multiples;
                            // of S for points and queries, of T for weights)
  int kind;
  double sigma;
};

struct Item {
  long long qi;
  int s, c;
};

// Which of two slots holds a tag, and the tags themselves (registers, not
// an indexed array).
struct Slots {
  long long tag0 = -1, tag1 = -1;
  __device__ long long tag(int s) const { return s ? tag1 : tag0; }
  __device__ void set(int s, long long t) {
    if (s) tag1 = t; else tag0 = t;
  }
  // The slot of `t` given that the current item uses `cur`: the slot that
  // holds it already, else the other one (then `load` is set).
  __device__ int pick(int cur, long long t, bool& load) {
    load = false;
    if (tag(cur) == t) return cur;
    if (tag(1 - cur) == t) return 1 - cur;
    load = true;
    set(1 - cur, t);
    return 1 - cur;
  }
};

struct Info {
  bool valid;
  long long pi, wi;
  int r0, nr;
};

// The block indices of 32 queries from `base` (lane l holds query base +
// l's), read with one coalesced load and handed out with shuffles, so an
// item's indices are not a dependent load from device memory.
struct IndexCache {
  long long base = -1;
  long long p0 = 0, w0 = 0, p1 = 0, w1 = 0;

  __device__ void fill(const Args& a, long long qi, long long q1, int lane) {
    base = qi;
    const long long q = qi + lane;
    if (q < q1) {
      p0 = a.seg[0].pidx[q];
      w0 = a.seg[0].widx[q];
      if (a.nseg == 2) {
        p1 = a.seg[1].pidx[q];
        w1 = a.seg[1].widx[q];
      }
    }
  }

  __device__ Info info(const Args& a, const Item& it, long long q1,
                       int lane) {
    if (base < 0 || it.qi >= base + 32) fill(a, it.qi, q1, lane);
    const int src = static_cast<int>(it.qi - base);
    const Segment& g = a.seg[it.s];
    Info f;
    f.pi = __shfl_sync(0xffffffffu, it.s ? p1 : p0, src);
    f.wi = __shfl_sync(0xffffffffu, it.s ? w1 : w0, src);
    f.valid = f.pi >= 0 && f.pi < g.bp && f.wi >= 0 && f.wi < g.bw;
    f.r0 = it.c * a.rows;
    f.nr = min(a.rows, g.m - f.r0);
    return f;
  }
};

__device__ __forceinline__ bool advance(const Args& a, Item& it,
                                        long long q1) {
  const int nch = (a.seg[it.s].m + a.rows - 1) / a.rows;
  if (it.c + 1 < nch) {
    ++it.c;
  } else if (it.s + 1 < a.nseg) {
    ++it.s;
    it.c = 0;
  } else {
    ++it.qi;
    it.s = 0;
    it.c = 0;
  }
  return it.qi < q1;
}

// A flat block copy of data of type S by the 32 lanes of a warp
// (acopy::warp_copy), or, for a bfloat16 block whose base or size is not a
// multiple of 4 bytes (``width`` 2, below cp.async's smallest copy), 2
// bytes a piece by plain loads and stores.
template <typename S>
__device__ __forceinline__ void data_copy(void* dst, const void* src,
                                          int nbytes, int width, int lane) {
  if constexpr (sizeof(S) == 2) {
    if (width == 2) {
      for (int o = 2 * lane; o < nbytes; o += 64)
        *reinterpret_cast<uint16_t*>(static_cast<char*>(dst) + o) =
            *reinterpret_cast<const uint16_t*>(
                static_cast<const char*>(src) + o);
      return;
    }
  }
  acopy::warp_copy(dst, src, nbytes, width, lane);
}

// A tag naming (segment, block, chunk).
__device__ __forceinline__ long long tag_of(long long idx, int s, int c) {
  return ((idx * 2 + s) << 20) | c;
}

template <typename S, typename T, int VW, bool L1>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
oos_contract_kernel(const __grid_constant__ Args a) {
  using V = typename Vec<S, VW>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long nw = static_cast<long long>(gridDim.x) * a.warps;
  const long long gw = static_cast<long long>(blockIdx.x) * a.warps + warp;
  const long long q0 = gw * a.q / nw;
  const long long q1 = (gw + 1) * a.q / nw;
  if (q0 >= q1) return;

  const size_t ssz = sizeof(S), tsz = sizeof(T);
  unsigned char* wbase =
      smem_raw + static_cast<size_t>(warp) * 2 *
                     ((a.pslot + a.xslot) * ssz + a.wslot * tsz);
  S* ps = reinterpret_cast<S*>(wbase);
  T* ws = reinterpret_cast<T*>(wbase + 2 * a.pslot * ssz);
  S* xs = reinterpret_cast<S*>(wbase + 2 * (a.pslot * ssz + a.wslot * tsz));
  const int d = a.d, k = a.k;
  const int nv = d / VW;
  const int rot = (nv % 2 == 0) ? lane % nv : 0;
  const S* Q = static_cast<const S*>(a.queries);
  T* out = static_cast<T*>(a.out);
  const T sigma = static_cast<T>(a.sigma);

  Slots pslots, wslots, xslots;
  int sp = 1, sw = 1, sx = 1;  // the current item's slots

  // Issue the copies of item `it` into the slots the current item does not
  // use; returns its slots.
  auto prefetch = [&](const Item& it, const Info& f, int& np, int& nwt,
                      int& nx) {
    bool load;
    nx = xslots.pick(sx, it.qi, load);
    if (load)
      data_copy<S>(xs + nx * a.xslot, Q + it.qi * d,
                   static_cast<int>(d * ssz), a.xw, lane);
    np = sp;
    nwt = sw;
    if (!f.valid) return;
    const Segment& g = a.seg[it.s];
    np = pslots.pick(sp, tag_of(f.pi, it.s, it.c), load);
    if (load)
      data_copy<S>(
          ps + np * a.pslot,
          static_cast<const S*>(g.points) +
              (static_cast<size_t>(f.pi) * g.m + f.r0) * d,
          static_cast<int>(f.nr * d * ssz), g.pw, lane);
    nwt = wslots.pick(sw, tag_of(f.wi, it.s, it.c), load);
    if (load)
      acopy::warp_copy(
          ws + nwt * a.wslot,
          static_cast<const T*>(g.weights) +
              (static_cast<size_t>(f.wi) * g.m + f.r0) * k,
          static_cast<int>(f.nr * k * tsz), g.ww, lane);
  };

  IndexCache cache;
  Item cur{q0, 0, 0};
  Info fc = cache.info(a, cur, q1, lane);
  const bool small_k = k <= KT;  // the output row stays in registers
  T zacc[KT];
  {
    int np, nwt, nx;
    prefetch(cur, fc, np, nwt, nx);
    sp = np;
    sw = nwt;
    sx = nx;
  }
  acopy::commit();
  for (;;) {
    Item nxt = cur;
    const bool more = advance(a, nxt, q1);
    Info fn{};
    int np = sp, nwt = sw, nx = sx;
    if (more) {
      fn = cache.info(a, nxt, q1, lane);
      prefetch(nxt, fn, np, nwt, nx);
    }
    acopy::commit();
    acopy::wait<1>();
    __syncwarp();

    // ---- compute the current item ----
    T* o = out + cur.qi * k;
    const bool first = cur.s == 0 && cur.c == 0;
    if (!fc.valid) {
      if (small_k) {
#pragma unroll
        for (int c = 0; c < KT; ++c) zacc[c] = quiet_nan<T>();
      } else {
        for (int c = lane; c < k; c += 32) o[c] = quiet_nan<T>();
      }
    } else {
      const S* P = ps + sp * a.pslot;
      const T* W = ws + sw * a.wslot;
      const V* X = reinterpret_cast<const V*>(xs + sx * a.xslot);
      for (int b0 = 0; b0 < fc.nr; b0 += 32 * RB) {
        const V* prow[RB];
        T acc[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const int row = min(b0 + lane + 32 * i, fc.nr - 1);
          prow[i] = reinterpret_cast<const V*>(P + row * d);
          acc[i] = T(0);
        }
        for (int u = 0; u < nv; ++u) {
          int uu = u + rot;
          uu -= uu >= nv ? nv : 0;
          const V xv = X[uu];
#pragma unroll
          for (int i = 0; i < RB; ++i)
            acc[i] = dist<T, L1>(acc[i], prow[i][uu], xv);
        }
        T kv[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i)
          kv[i] = b0 + lane + 32 * i < fc.nr
                      ? kernel_epilogue<T>(a.kind, acc[i], sigma)
                      : T(0);
        for (int c0 = 0; c0 < k; c0 += KT) {
          T part[KT];
#pragma unroll
          for (int c = 0; c < KT; ++c) part[c] = T(0);
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const int row = b0 + lane + 32 * i;
            if (row < fc.nr) {
              const T* wr = W + row * k + c0;
#pragma unroll
              for (int c = 0; c < KT; ++c)
                if (c0 + c < k) part[c] += kv[i] * wr[c];
            }
          }
#pragma unroll
          for (int c = 0; c < KT; ++c) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
            if (small_k)
              zacc[c] = first && b0 == 0 ? part[c] : zacc[c] + part[c];
            else if (lane == c && c0 + c < k)
              o[c0 + c] = first && b0 == 0 ? part[c] : o[c0 + c] + part[c];
          }
        }
      }
    }
    if (small_k && (!more || nxt.qi != cur.qi)) {  // the query's last item
#pragma unroll
      for (int c = 0; c < KT; ++c)
        if (lane == c && c < k) o[c] = zacc[c];
    }
    __syncwarp();
    if (!more) break;
    cur = nxt;
    fc = fn;
    sp = np;
    sw = nwt;
    sx = nx;
  }
}

// Blocks an SM of one kernel at one shared-memory size, cached (serving
// launches the same shapes again and again).
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem, int& per_sm) {
  static Kernel last_kernel = nullptr;
  static int last_threads = 0, last_per_sm = 0;
  static size_t last_smem = 0;
  if (kernel == last_kernel && threads == last_threads && smem == last_smem) {
    per_sm = last_per_sm;
    return 0;
  }
  const int err = static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem));
  if (err) return err;
  last_kernel = kernel;
  last_threads = threads;
  last_smem = smem;
  last_per_sm = per_sm;
  return 0;
}

int sm_count(int& sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, err;
    if ((err = static_cast<int>(cudaGetDevice(&dev))) ||
        (err = static_cast<int>(cudaDeviceGetAttribute(
             &cached, cudaDevAttrMultiProcessorCount, dev))))
      return err;
  }
  sms = cached;
  return 0;
}

template <typename S, typename T, int VW, bool L1>
int launch_kernel(const Args& a, cudaStream_t stream) {
  const auto kernel = oos_contract_kernel<S, T, VW, L1>;
  const size_t smem = static_cast<size_t>(a.warps) * 2 *
                      ((a.pslot + a.xslot) * sizeof(S) + a.wslot * sizeof(T));
  const int threads = a.warps * 32;
  int err = launch_with_smem(kernel, smem);
  int sms = 0, per_sm = 0;
  if (err || (err = sm_count(sms)) ||
      (err = blocks_per_sm(kernel, threads, smem, per_sm)))
    return err;
  const long long want = (static_cast<long long>(a.q) + a.warps - 1) / a.warps;
  const long long grid = std::max<long long>(
      1, std::min<long long>(want, static_cast<long long>(sms) *
                                       std::max(per_sm, 1)));
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename T>
int launch(const void* p0, const void* w0, const void* pi0, const void* wi0,
           long long bp0, long long bw0, int m0, int pw0, int ww0,
           const void* p1, const void* w1, const void* pi1, const void* wi1,
           long long bp1, long long bw1, int m1, int pw1, int ww1, int nseg,
           const void* queries, void* out, int q, int d, int k, int rows,
           int warps, int xw, int vw, int pslot, int wslot, int xslot,
           int kind, double sigma, void* stream) {
  if (q == 0 || k == 0) return 0;
  if (nseg < 1 || nseg > 2 || warps < 1 || warps > kMaxWarps || rows < 1 ||
      d % vw != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.seg[0] = {p0, w0, static_cast<const long long*>(pi0),
              static_cast<const long long*>(wi0), bp0, bw0, m0, pw0, ww0};
  a.seg[1] = nseg == 2
                 ? Segment{p1, w1, static_cast<const long long*>(pi1),
                           static_cast<const long long*>(wi1), bp1, bw1, m1,
                           pw1, ww1}
                 : a.seg[0];
  a.queries = queries;
  a.out = out;
  a.nseg = nseg;
  a.q = q;
  a.d = d;
  a.k = k;
  a.rows = rows;
  a.warps = warps;
  a.xw = xw;
  a.pslot = pslot;
  a.wslot = wslot;
  a.xslot = xslot;
  a.kind = kind;
  a.sigma = sigma;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool l1 = kind == KIND_LAPLACE;
  if constexpr (sizeof(S) <= 4) {
    if (vw == 4)
      return l1 ? launch_kernel<S, T, 4, true>(a, st)
                : launch_kernel<S, T, 4, false>(a, st);
  }
  if (vw == 2)
    return l1 ? launch_kernel<S, T, 2, true>(a, st)
              : launch_kernel<S, T, 2, false>(a, st);
  if (vw != 1) return static_cast<int>(cudaErrorInvalidValue);
  return l1 ? launch_kernel<S, T, 1, true>(a, st)
            : launch_kernel<S, T, 1, false>(a, st);
}

}  // namespace

#define OOS_CONTRACT_ENTRY(NAME, S, T)                                        \
  extern "C" int NAME(                                                        \
      const void* p0, const void* w0, const void* pi0, const void* wi0,       \
      long long bp0, long long bw0, int m0, int pw0, int ww0, const void* p1, \
      const void* w1, const void* pi1, const void* wi1, long long bp1,        \
      long long bw1, int m1, int pw1, int ww1, int nseg, const void* queries, \
      void* out, int q, int d, int k, int rows, int warps, int xw, int vw,    \
      int pslot, int wslot, int xslot, int kind, double sigma,                \
      void* stream) {                                                         \
    return launch<S, T>(p0, w0, pi0, wi0, bp0, bw0, m0, pw0, ww0, p1, w1,     \
                        pi1, wi1, bp1, bw1, m1, pw1, ww1, nseg, queries, out, \
                        q, d, k, rows, warps, xw, vw, pslot, wslot, xslot,    \
                        kind, sigma, stream);                                 \
  }

// The _bf16 entry is compiled apart, in oos_contract_bf16.cu
// (REPRO_BF16_ENTRIES), so that the float32 and float64 entries compile as
// they do alone.
#ifdef REPRO_BF16_ENTRIES
OOS_CONTRACT_ENTRY(oos_contract_bf16, __nv_bfloat16, float)
#else
OOS_CONTRACT_ENTRY(oos_contract_f32, float, float)
OOS_CONTRACT_ENTRY(oos_contract_f64, double, double)
#endif  // REPRO_BF16_ENTRIES

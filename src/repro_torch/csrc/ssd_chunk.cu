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
// P <= 128, any of them ragged.  Both products run on the tensor cores in
// split TF32 (tf32x3.cuh: hi hi + hi lo + lo hi, float32 accumulation),
// as accurate as the float32 reference; one TF32 pass would not be.  L is
// evaluated only where i >= j: above the diagonal cs_i - cs_j is positive
// (cs is a cumulative sum of negative steps), its exp can overflow, and
// inf * 0 would give NaN.  The Pallas kernel's whole (Q, Q) score tile
// (256 KB at Q = 256) does not fit a Hopper block, so a block owns query
// rows and walks the key tiles j <= i.
//
// Bound on the H100: bytes.  At Zamba2-7B's prefill (BH = 4 x 112, nc 15,
// Q 256, N = P = 64) c, b, xdt, cs and y are 1.76 GB, 0.53 ms at 3.35
// TB/s; the causal half of C B^T and of (S L) X is 56 GFLOP, three TF32
// passes 0.34 ms at 495 TFLOP/s.
//
// Two kernels; the wrapper chooses one before the launch
// (kernels/ssd_chunk/ops.py::variant).
//
// N and P multiples of 4 up to 64, c, b and xdt 16-byte aligned (the
// model's path): ssd_intra_chunk_wgmma_f32, TMA, wgmma, warp-specialised.
//   Block: 128 query rows of one (head, chunk) and 384 threads.  Warpgroup
//   0 produces (setmaxnreg 88): one thread issues the TMA loads of the
//   block's C and, a tile ahead, of each key tile's B and X (64 keys, raw
//   float32, 128-byte-swizzled boxes of 32 columns, zero-filled past Q, N
//   and P); the warpgroup then splits each tile as it lands, B in place
//   (hi to its own plane, lo over the raw values: the split is
//   elementwise, so the swizzle carries over), X transposed (wgmma's .tf32
//   operands are K-major only, and X's keys are its rows): a work item is
//   4 keys by 4 columns, four 16-byte loads, a 4 x 4 transpose in
//   registers, four 16-byte stores a plane.  Splitting in shared memory,
//   not in device memory, keeps the bytes at the kernel's bound.
//   Warpgroups 1 and 2 consume 64 rows each (setmaxnreg 208) through a
//   ring of 2 stages (full and empty mbarriers): S = C B^T by
//   wgmma.m64n64k8 .tf32 from shared memory, three passes a k-step; the
//   decay and the causal mask in registers; then Y += (S L) X with S L
//   split in registers as the A operand against X^T.  The accumulator
//   holds columns 2t and 2t + 1 of each group of 8 keys where the A
//   fragment wants t and t + 4 (tf32x3.cuh), so the transpose writes each
//   group's keys in the order KEY_OF: even keys, then odd.  The halves of
//   one (head, chunk) are neighbours in the grid, the longer first, so the
//   chunk's B and X come from device memory once and from L2 the second
//   time.
//
// Other shapes (N or P above 64 or not a multiple of 4, a misaligned
// view): ssd_intra_chunk_f32, mma.sync.  It keeps the interface's full
// range (N, P <= 128, any width, any view); the model's traffic
// (Zamba2-7B, N = P = 64 on aligned tensors) never reaches it.  A block of 4 warps owns one
// 64-row query tile of one (head, chunk); each warp owns 16 query rows and
// keeps them as split A fragments of C in registers.  mma.sync.m16n8k8
// .tf32 loads its fragments from shared memory in any layout, so B and X
// need no transpose and are split in registers as they are read.  The key
// tiles (64 keys of B and of X) go through a double-buffered ring of
// cp.async copies (16 bytes where N and P are multiples of 4 and the
// tensors aligned, else 4), so the next tile loads while this one is
// computed; each warp stops at the last 8-key group its rows need.  Per
// group of 8 keys: S = C B^T in three passes per 8 features (the hi hi
// terms and the corrections in two accumulators, two chains in flight);
// the decay and the mask in registers; then Y += (S L) X with S L's
// accumulator read as the A fragment ({c0, c2, c1, c3}, split): its logical
// key p stands for key KEY_OF[p], so X's B fragment is read from rows 2t
// and 2t + 1.  Shared rows are padded to 4 mod 8 words, which makes both
// fragment reads conflict-free.  The query tiles of one (head, chunk) are
// neighbours in the grid, longest first.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "kernel_epilogue.cuh"
#include "tf32x3.cuh"

namespace {

using hopper::smem_addr;

constexpr int BQ = 64, BK = 64, kThreads = 128, WMAX = 128, QMAX = 256;
constexpr float LOG2E = 1.4426950408889634f;

// Shared row stride (in floats) for a width of w floats: a whole number
// of 8-float k-steps plus 4, so that the fragment reads fall in 32 banks.
__host__ __device__ constexpr int row_stride(int w) {
  return 8 * ((w + 7) / 8) + 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + BK) of a (q, w) matrix into shared rows of stride ld,
// 8 ceil(w / 8) columns each; rows past q and columns past w zero.
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int r0, int q, int w, int ld,
                                          bool vec, float* dst) {
  const int wp = 8 * ((w + 7) / 8);
  if (vec) {
    const int chunks = wp / 4;
    for (int e = threadIdx.x; e < BK * chunks; e += kThreads) {
      const int r = e / chunks, c = 4 * (e % chunks);
      const bool ok = r0 + r < q && c < w;
      cp_async16(dst + r * ld + c,
                 ok ? src + static_cast<size_t>(r0 + r) * w + c : src, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < BK * wp; e += kThreads) {
    const int r = e / wp, c = e % wp;
    const bool ok = r0 + r < q && c < w;
    cp_async4(dst + r * ld + c,
              ok ? src + static_cast<size_t>(r0 + r) * w + c : src, ok);
  }
}

// A warp's rows of C as the A fragments of NK k-steps: split once and kept
// (N <= 64, the model's path), or kept in float32 and split at each use
// (N <= 128), which leaves the registers for P = 128's accumulators.
template <int NK, bool SPLIT>
struct CFrags {
  uint32_t h[NK][4], l[NK][4];
  __device__ __forceinline__ void set(int ks, int e, float v) {
    tf32x3::split(v, h[ks][e], l[ks][e]);
  }
  __device__ __forceinline__ void get(int ks, uint32_t* hi,
                                      uint32_t* lo) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = h[ks][e];
      lo[e] = l[ks][e];
    }
  }
};

template <int NK>
struct CFrags<NK, false> {
  float f[NK][4];
  __device__ __forceinline__ void set(int ks, int e, float v) {
    f[ks][e] = v;
  }
  __device__ __forceinline__ void get(int ks, uint32_t* hi,
                                      uint32_t* lo) const {
    // tf32x3::split with its first step volatile: a split hoisted out of
    // the key loops would hold all NK fragments split again
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t r;
      asm volatile("add.u32 %0, %1, 4096;" : "=r"(r)
                   : "r"(__float_as_uint(f[ks][e])));
      hi[e] = r & 0xFFFFE000u;
      lo[e] = __float_as_uint(f[ks][e] - __uint_as_float(hi[e]));
    }
  }
};

// NK: the most 8-feature k-steps of C B^T (N <= 8 NK); PK: the most 8-column
// n-tiles of (S L) X (P <= 8 PK).  The loops stop at the shape's own.
template <int NK, int PK>
__global__ void __launch_bounds__(kThreads)
ssd_mma_kernel(const float* __restrict__ c, const float* __restrict__ b,
              const float* __restrict__ xdt, const float* __restrict__ cs,
              float* __restrict__ y, int q, int n, int p, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ldb = row_stride(n), ldx = row_stride(p);
  const int nk = (n + 7) / 8, pk = (p + 7) / 8;
  float* bs = smem;                         // 2 stages x BK x ldb
  float* xs = bs + 2 * BK * ldb;            // 2 stages x BK x ldx
  float* css = xs + 2 * BK * ldx;           // the chunk's cs, rows < i0 + BQ
  const int tiles = (q + BQ - 1) / BQ;
  const size_t chunk = blockIdx.x / tiles;  // bh * nc + chunk index
  const int it = tiles - 1 - static_cast<int>(blockIdx.x % tiles);
  const int i0 = it * BQ;
  const float* cb = c + chunk * q * n;
  const float* bb = b + chunk * q * n;
  const float* xb = xdt + chunk * q * p;
  const float* csb = cs + chunk * q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = i0 + 16 * warp + g, row1 = row0 + 8;

  load_tile(bb, 0, q, n, ldb, vec, bs);
  load_tile(xb, 0, q, p, ldx, vec, xs);
  cp_async_commit();
  for (int r = threadIdx.x; r < i0 + BQ; r += kThreads)
    css[r] = r < q ? csb[r] : 0.f;
  // this warp's rows of C: the A fragments of every k-step
  CFrags<NK, NK <= 8> cf;
#pragma unroll
  for (int ks = 0; ks < NK; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = (e & 1) ? row1 : row0, col = 8 * ks + t + 4 * (e >> 1);
      cf.set(ks, e, (ks < nk && row < q && col < n)
                        ? cb[static_cast<size_t>(row) * n + col] : 0.f);
    }
  // rows past q take no key (L = 0), so their exp cannot overflow
  const int last0 = row0 < q ? row0 : -1, last1 = row1 < q ? row1 : -1;
  float acc[PK][4];
#pragma unroll
  for (int j = 0; j < PK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      const int nxt = (jt + 1) & 1;
      load_tile(bb, (jt + 1) * BK, q, n, ldb, vec, bs + nxt * BK * ldb);
      load_tile(xb, (jt + 1) * BK, q, p, ldx, vec, xs + nxt * BK * ldx);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // tile jt (and css) are in
    const float* bt = bs + (jt & 1) * BK * ldb;
    const float* xt = xs + (jt & 1) * BK * ldx;
    const int j0 = jt * BK;
    const float csi0 = css[row0], csi1 = css[row1];
    // the 8-key groups up to this warp's last row
    const int groups = min(BK / 8, (i0 + 16 * warp + 15 - j0) / 8 + 1);
    for (int kg = 0; kg < groups; ++kg) {
      // S = C B^T: the hi hi terms and the two correction terms in two
      // accumulators, so that two chains of products are in flight
      float sh[4] = {0.f, 0.f, 0.f, 0.f}, sc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* brow = bt + (8 * kg + g) * ldb + t;
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        if (ks >= nk) break;
        uint32_t ah[4], al[4], bh[2], bl[2];
        cf.get(ks, ah, al);
        tf32x3::split(brow[8 * ks], bh[0], bl[0]);
        tf32x3::split(brow[8 * ks + 4], bh[1], bl[1]);
        tf32x3::mma(sc, al, bh);
        tf32x3::mma(sc, ah, bl);
        tf32x3::mma(sh, ah, bh);
      }
      // s[e]: row (e < 2 ? row0 : row1), key j0 + 8 kg + 2t + (e & 1),
      // times L (exp2 of the log2e-scaled difference; 0 above the
      // diagonal and on rows past q)
      const int key = j0 + 8 * kg + 2 * t;
      const float csk0 = css[key], csk1 = css[key + 1];
      float s[4];
      s[0] = (sh[0] + sc[0]) *
             hopper::ex2(key <= last0 ? (csi0 - csk0) * LOG2E : -INFINITY);
      s[1] = (sh[1] + sc[1]) *
             hopper::ex2(key + 1 <= last0 ? (csi0 - csk1) * LOG2E : -INFINITY);
      s[2] = (sh[2] + sc[2]) *
             hopper::ex2(key <= last1 ? (csi1 - csk0) * LOG2E : -INFINITY);
      s[3] = (sh[3] + sc[3]) *
             hopper::ex2(key + 1 <= last1 ? (csi1 - csk1) * LOG2E : -INFINITY);
      uint32_t ah[4], al[4];
      tf32x3::acc_as_a(s, ah, al);
      const float* xrow = xt + (8 * kg + 2 * t) * ldx + g;
#pragma unroll
      for (int j = 0; j < PK; ++j) {
        if (j >= pk) break;
        uint32_t xh[2], xl[2];
        tf32x3::split(xrow[8 * j], xh[0], xl[0]);
        tf32x3::split(xrow[8 * j + ldx], xh[1], xl[1]);
        tf32x3::mma3(acc[j], ah, al, xh, xl);
      }
    }
    __syncthreads();                        // stage jt & 1 free again
  }
  float* yb = y + chunk * q * p;
#pragma unroll
  for (int j = 0; j < PK; ++j) {
    if (j >= pk) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row0 : row1, col = 8 * j + 2 * t + (e & 1);
      if (row < q && col < p)
        yb[static_cast<size_t>(row) * p + col] = acc[j][e];
    }
  }
}

// Shared memory of one block: two stages of B and X key tiles and the
// chunk's cs up to the last query row.
size_t smem_bytes(int q, int n, int p) {
  return sizeof(float) *
         (2 * BK * (row_stride(n) + row_stride(p)) + ((q + BQ - 1) / BQ) * BQ);
}

template <int NK, int PK>
int launch(const void* c, const void* b, const void* xdt, const void* cs,
           void* y, long long blocks, int q, int n, int p, int vec,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(q, n, p);
  const int err = launch_with_smem(ssd_mma_kernel<NK, PK>, smem);
  if (err) return err;
  ssd_mma_kernel<NK, PK>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          static_cast<const float*>(c), static_cast<const float*>(b),
          static_cast<const float*>(xdt), static_cast<const float*>(cs),
          static_cast<float*>(y), q, n, p, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// N, P <= 64 (the model's path): wgmma, warp-specialised
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int BM = 128;                  // query rows a block: 2 x 64
constexpr int BKW = 64;                  // keys a tile
constexpr int kWgThreads = 384;          // producer + two consumer warpgroups
constexpr int STAGES = 2;
constexpr uint32_t CBOX = BM * 128;      // a 32-column box of C's 128 rows
constexpr uint32_t KBOX = BKW * 128;     // a 32-column box of a 64-row tile

// Byte offsets from the 1024-aligned base: C hi and lo (2 boxes each), then
// per stage B hi and lo and X^T hi and lo (2 boxes each), then cs, then the
// barriers full_c, full[STAGES], empty[STAGES], raw_c, raw[STAGES].
constexpr uint32_t C_OFF = 0;
constexpr uint32_t STAGE_OFF = 4 * CBOX;
constexpr uint32_t STAGE_BYTES = 8 * KBOX;
constexpr uint32_t CS_OFF = STAGE_OFF + STAGES * STAGE_BYTES;
constexpr uint32_t BAR_OFF = CS_OFF + QMAX * 4;
constexpr uint32_t SMEM = 1024 + BAR_OFF + 8 * (2 + 3 * STAGES);

__device__ __forceinline__ void st_v4(uint32_t addr, uint32_t a, uint32_t b,
                                      uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

__device__ __forceinline__ void st_1(uint32_t addr, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(a) : "memory");
}

// The ``bytes`` bytes at ``lo`` (a TMA-landed float32 tile), split in
// place: hi to the same offsets from ``hi``, lo back over the raw values.
// The split is elementwise, so the 128-byte swizzle of the tile carries
// over to both planes.  16-byte loads and stores.
__device__ __forceinline__ void split_in_place(uint32_t hi, uint32_t lo,
                                               uint32_t bytes, int tid) {
  for (uint32_t off = tid * 16; off < bytes; off += 128 * 16) {
    uint32_t v[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                 : "r"(lo + off) : "memory");
    uint32_t h[4], l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      tf32x3::split(__uint_as_float(v[u]), h[u], l[u]);
    st_v4(hi + off, h[0], h[1], h[2], h[3]);
    st_v4(lo + off, l[0], l[1], l[2], l[3]);
  }
}

// The raw X tile at ``lo`` (64 keys x 64 columns as TMA wrote it: two
// swizzled boxes of 32 columns, rows = keys) split and transposed into
// X^T's hi and lo planes (rows = columns of X, keys K-major, each group
// of 8 keys in the order KEY_OF), the lo plane over the raw tile: every
// producer thread reads its values before any is overwritten.  A work
// item is 4 keys of one group (the even ones or the odd ones, which
// KEY_OF puts at 4 consecutive logical places) by 4 consecutive columns:
// four 16-byte loads, a 4 x 4 transpose in registers, and per plane four
// 16-byte stores.
__device__ __forceinline__ void split_xt(uint32_t hi, uint32_t lo, int tid) {
  constexpr int ITEMS = BKW / 4 * 16 / 128;     // 2 items a thread
  float v[ITEMS][4][4];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int w = tid + 128 * it;
    const int grp = w / 32, half = (w / 16) & 1, c4 = 4 * (w % 16);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 8 * grp + 2 * u + half;   // real key KEY_OF[4 half + u]
      const uint32_t off = (c4 / 32) * KBOX + r * 128 +
                           ((((c4 % 32) / 4) ^ (r & 7)) << 4);
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[it][u][0]), "=f"(v[it][u][1]), "=f"(v[it][u][2]),
                     "=f"(v[it][u][3])
                   : "r"(lo + off) : "memory");
    }
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");   // producers only
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int w = tid + 128 * it;
    const int grp = w / 32, half = (w / 16) & 1, c4 = 4 * (w % 16);
    const int lk = 8 * grp + 4 * half;             // logical keys lk..lk+3
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c4 + k;
      const uint32_t off = (lk / 32) * KBOX + c * 128 +
                           ((((lk % 32) / 4) ^ (c & 7)) << 4);
      uint32_t h[4], l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) tf32x3::split(v[it][u][k], h[u], l[u]);
      st_v4(hi + off, h[0], h[1], h[2], h[3]);
      st_v4(lo + off, l[0], l[1], l[2], l[3]);
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tmc,
                 const __grid_constant__ CUtensorMap tmb,
                 const __grid_constant__ CUtensorMap tmx,
                 const float* __restrict__ cs, float* __restrict__ y, int q,
                 int n, int p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* css = reinterpret_cast<const float*>(
      smem_raw + (base + CS_OFF - raw));
  const uint32_t full_c = base + BAR_OFF;
  const auto full = [&](int st) { return full_c + 8u * (1 + st); };
  const auto empty = [&](int st) { return full_c + 8u * (1 + STAGES + st); };
  const uint32_t raw_c = full_c + 8u * (1 + 2 * STAGES);
  const auto raw_full = [&](int st) { return raw_c + 8u * (1 + st); };
  const auto stage = [&](int st) {
    return base + STAGE_OFF + st * STAGE_BYTES;
  };
  const int halves = (q + BM - 1) / BM;
  const size_t chunk = blockIdx.x / halves;
  const int hb = halves - 1 - static_cast<int>(blockIdx.x % halves);
  const int i0 = hb * BM;
  const int ntiles = min(2 * hb + 2, (q + BKW - 1) / BKW);
  const float* csb = cs + chunk * q;
  const int plane = static_cast<int>(chunk);

  if (threadIdx.x == 0) {
    mbar_init(full_c, 128);
    mbar_init(raw_c, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 128);
      mbar_init(empty(st), 2 * 128);
      mbar_init(raw_full(st), 1);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: TMA brings C once and B, X a key tile at a time, raw,
    // one tile ahead; the warpgroup splits each as it lands ----
    setmaxnreg_dec<88>();
    const int tid = threadIdx.x;
    const auto fetch = [&](int jt) {             // tile jt's raw B and X
      const int st = jt % STAGES;
      const uint32_t s0 = stage(st);
      mbar_wait(empty(st), ((jt / STAGES) & 1) ^ 1);
      mbar_expect_tx(raw_full(st), 4 * KBOX);
      for (int bx = 0; bx < 2; ++bx) {
        tma_load(s0 + (2 + bx) * KBOX, &tmb, raw_full(st), 32 * bx, jt * BKW,
                 plane);
        tma_load(s0 + (6 + bx) * KBOX, &tmx, raw_full(st), 32 * bx, jt * BKW,
                 plane);
      }
    };
    if (tid == 0) {
      mbar_expect_tx(raw_c, 2 * CBOX);
      for (int bx = 0; bx < 2; ++bx)
        tma_load(base + C_OFF + (2 + bx) * CBOX, &tmc, raw_c, 32 * bx, i0,
                 plane);
      fetch(0);
    }
    float* csw = reinterpret_cast<float*>(smem_raw + (base + CS_OFF - raw));
    for (int r = tid; r < i0 + BM && r < QMAX; r += 128)
      csw[r] = r < q ? csb[r] : 0.f;
    mbar_wait(raw_c, 0);
    split_in_place(base + C_OFF, base + C_OFF + 2 * CBOX, 2 * CBOX, tid);
    fence_proxy_async();
    mbar_arrive(full_c);
    for (int jt = 0; jt < ntiles; ++jt) {
      const int st = jt % STAGES;
      if (tid == 0 && jt + 1 < ntiles) fetch(jt + 1);
      mbar_wait(raw_full(st), (jt / STAGES) & 1);
      const uint32_t s0 = stage(st);
      split_in_place(s0, s0 + 2 * KBOX, 2 * KBOX, tid);
      split_xt(s0 + 4 * KBOX, s0 + 6 * KBOX, tid);
      fence_proxy_async();
      mbar_arrive(full(st));
    }
  } else {
    // ---- consumers: S = C B^T, S L, Y += (S L) X ----
    setmaxnreg_inc<208>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int qt = 2 * hb + cw;                   // this warpgroup's tile
    const int row0 = i0 + 64 * cw + 16 * (threadIdx.x % 128 / 32) + lane / 4;
    const int row1 = row0 + 8;
    const int last0 = row0 < q ? row0 : -1, last1 = row1 < q ? row1 : -1;
    const int nk = (n + 7) / 8;
    const uint32_t ca = base + C_OFF + cw * 64 * 128;
    float s[32], yacc[32];
    uint32_t kh[32], kl[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = yacc[i] = 0.f;
    mbar_wait(full_c, 0);
    const float cs0 = css[min(row0, QMAX - 1)], cs1 = css[min(row1, QMAX - 1)];
    for (int jt = 0; jt < ntiles; ++jt) {
      const int st = jt % STAGES;
      mbar_wait(full(st), (jt / STAGES) & 1);
      if (jt <= qt) {
        const uint32_t s0 = stage(st);
        wgmma_fence();
        for (int ks = 0; ks < nk; ++ks) {
          const uint32_t co = (ks / 4) * CBOX + (ks % 4) * 32;
          const uint32_t bo = s0 + (ks / 4) * KBOX + (ks % 4) * 32;
          tf32x3::wgmma3_ss_n64(s, sw128_desc(ca + co, 16),
                                sw128_desc(ca + 2 * CBOX + co, 16),
                                sw128_desc(bo, 16),
                                sw128_desc(bo + 2 * KBOX, 16), ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(s);
        const int j0 = jt * BKW;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = j0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int last = (i & 2) ? last1 : last0;
          const float csi = (i & 2) ? cs1 : cs0;
          const float l = hopper::ex2(key <= last ? (csi - css[key]) * LOG2E
                                                  : -INFINITY);
          tf32x3::split(s[i] * l, kh[i], kl[i]);
        }
        wgmma_fence();
#pragma unroll
        for (int g8 = 0; g8 < BKW / 8; ++g8) {
          const uint32_t ah[4] = {kh[4 * g8], kh[4 * g8 + 2], kh[4 * g8 + 1],
                                  kh[4 * g8 + 3]};
          const uint32_t al[4] = {kl[4 * g8], kl[4 * g8 + 2], kl[4 * g8 + 1],
                                  kl[4 * g8 + 3]};
          const uint32_t xo = s0 + 4 * KBOX + (g8 / 4) * KBOX + (g8 % 4) * 32;
          tf32x3::wgmma3_rs<64>(yacc, ah, al, sw128_desc(xo, 16),
                                sw128_desc(xo + 2 * KBOX, 16), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(yacc);
      }
      mbar_arrive(empty(st));
    }
    float* yb = y + chunk * q * p;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);
      const int row = (i & 2) ? row1 : row0;
      if (row < q && col < p) yb[static_cast<size_t>(row) * p + col] = yacc[i];
    }
  }
}

}  // namespace wg

int launch_wgmma(const void* c, const void* b, const void* xdt,
                 const void* cs, void* y, long long chunks, int q, int n,
                 int p, cudaStream_t stream) {
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mc, mb, mx;
  int err = hopper::encode_map(&mc, f32, 4, c, chunks, q, n, 32, wg::BM);
  if (!err)
    err = hopper::encode_map(&mb, f32, 4, b, chunks, q, n, 32, wg::BKW);
  if (!err) err = hopper::encode_map(&mx, f32, 4, xdt, chunks, q, p, 32,
                                     wg::BKW);
  if (!err) err = launch_with_smem(wg::ssd_wgmma_kernel, wg::SMEM);
  if (err) return err;
  const long long blocks = chunks * ((q + wg::BM - 1) / wg::BM);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  wg::ssd_wgmma_kernel<<<static_cast<unsigned>(blocks), wg::kWgThreads,
                         wg::SMEM, stream>>>(
      mc, mb, mx, static_cast<const float*>(cs), static_cast<float*>(y), q, n,
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// N, P <= 128, any Q <= 256, any alignment: mma.sync.
extern "C" int ssd_intra_chunk_f32(const void* c, const void* b,
                                   const void* xdt, const void* cs, void* y,
                                   int chunks, int q, int n, int p,
                                   void* stream) {
  if (chunks == 0 || q == 0 || p == 0) return 0;
  if (q > QMAX || n > WMAX || p > WMAX) return cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>(chunks) * ((q + BQ - 1) / BQ);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<size_t>(ptr) % 16 == 0;
  };
  const int vec = n % 4 == 0 && p % 4 == 0 && aligned(c) && aligned(b) &&
                  aligned(xdt);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n <= 64 && p <= 64)
    return launch<8, 8>(c, b, xdt, cs, y, blocks, q, n, p, vec, st);
  if (n <= 64)
    return launch<8, 16>(c, b, xdt, cs, y, blocks, q, n, p, vec, st);
  if (p <= 64)
    return launch<16, 8>(c, b, xdt, cs, y, blocks, q, n, p, vec, st);
  return launch<16, 16>(c, b, xdt, cs, y, blocks, q, n, p, vec, st);
}

// The model's path: N and P multiples of 4 up to 64 and c, b, xdt 16-byte
// aligned (TMA reads 16-byte rows from aligned bases); the wrapper sends
// other shapes to ssd_intra_chunk_f32.
extern "C" int ssd_intra_chunk_wgmma_f32(const void* c, const void* b,
                                         const void* xdt, const void* cs,
                                         void* y, int chunks, int q, int n,
                                         int p, void* stream) {
  if (chunks == 0 || q == 0 || p == 0) return 0;
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<size_t>(ptr) % 16 == 0;
  };
  if (q > QMAX || n <= 0 || n > 64 || p > 64 || n % 4 || p % 4 ||
      !aligned(c) || !aligned(b) || !aligned(xdt))
    return cudaErrorInvalidValue;
  return launch_wgmma(c, b, xdt, cs, y, chunks, q, n, p,
                      static_cast<cudaStream_t>(stream));
}

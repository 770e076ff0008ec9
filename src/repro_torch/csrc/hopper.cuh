// Hopper (sm_90a) building blocks shared by the kernels written around TMA,
// mbarriers and wgmma: flash_attention.cu (B14, bf16), kernel_matvec.cu
// (B10, split TF32), kernel_tile.cu (B11, split TF32) and ssd_chunk.cu
// (B15, split TF32).
//
//   * mbarrier ring: init, expect_tx, arrive, parity wait, and the proxy
//     fence that publishes threads' shared-memory writes to TMA and wgmma;
//     a named barrier over some of a block's warps;
//   * TMA: a box of a 3-D tensor map, or a 1-D bulk copy, into shared
//     memory, completion counted in bytes on an mbarrier; a box from shared
//     memory back to a 3-D tensor map, in bulk groups that the issuing
//     thread commits and waits for; the host-side encoder of a 3-D map
//     read or written in 128-byte-swizzled boxes;
//   * wgmma: the shared-memory descriptor of a 128-byte-swizzled tile,
//     fence / commit / wait, the accumulator register fences, and the
//     operand lists of the accumulators (WG_D8, WG_R*);
//   * setmaxnreg, and ex2 on the MUFU unit.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Makes this thread's writes to shared memory visible to the async proxy
// (TMA, wgmma) before an mbarrier arrive or a barrier publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier ``id`` (1 to 15; 0 is __syncthreads') over ``count`` threads,
// whole warps.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 3-D tensor map (column c0, row c1, plane c2) into shared
// memory; completion is reported to ``bar`` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// ``bytes`` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) into shared memory, reported to ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// One box of shared memory at ``src`` into a 3-D tensor map at (column c0,
// row c1, plane c2); the TMA clips what lies past the tensor.  Part of the
// issuing thread's current bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// Closes the issuing thread's current bulk group of stores.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared memory (which may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime so a
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A row-major (planes, rows, cols) tensor of ``type`` (``elem`` bytes an
// element) as a 3-D map read or written in boxes of ``box_cols`` columns
// (128 bytes: one swizzle atom) x ``box_rows`` rows of one plane, 128-byte
// swizzled; a load fills rows and columns past the tensor with zeros, a
// store leaves them out.  The row
// stride cols * elem must be a multiple of 16 bytes.  Returns a CUDA error
// code.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                      const void* base, long long planes, long long rows,
                      long long cols, int box_cols, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * elem,
                                 static_cast<cuuint64_t>(rows) * cols * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle that the
// TMA boxes are written in: rows of 128 bytes, 8-row groups 1024 bytes
// apart (SBO).  ``lbo``: the byte distance of the next 128-byte atom along
// MN, for an MN-major operand; K-major tiles are one atom wide per k-step
// (32 bytes: 16 bf16 or 8 tf32 values) and take 16.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Warp-specialised blocks: the producer warpgroup gives registers back,
// the consumer warpgroups take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x on the MUFU unit (flushes results below 2^-126 to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hopper

// The accumulator operands of a wgmma asm statement, 8 registers of d at a
// time (WG_D8), and their operand numbers in the template string (WG_R0:
// %0..%7, WG_R8: %0..%15, ..., WG_R56: %0..%63).
#define WG_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R8 WG_R0 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R16 WG_R8 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define WG_R24 WG_R16 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R32 WG_R24 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WG_R40 WG_R32 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_R48 WG_R40 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define WG_R56 WG_R48 ", %56, %57, %58, %59, %60, %61, %62, %63"

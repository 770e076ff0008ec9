// cp.async copies of single elements (or of 16 bytes) from device memory
// into shared memory, used where a tile is staged into a padded or
// transposed layout that a bulk (TMA) copy cannot write: leaf_factor.cu
// (B3, rows of odd stride), policy_dist.cu (B12, feature-major tiles),
// build_dist.cu (B8's odd-stride tiles, B9's padded Linv), leaf_solve.cu
// (B4's packed triangle, zero-filled past the diagonal, and U's permuted
// rows) and oos_contract.cu (B7's blocks, flat, a warp a copy).  The
// copies run asynchronously to the issuing threads, so a block keeps every
// load of a tile in flight at once (and, with two buffers, behind its
// math).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace acopy {

// One float or double from ``src`` into ``dst``; when ``valid`` is false
// nothing is read and ``dst`` is zero-filled (``src`` must still be a
// mapped address).
template <typename T>
__device__ __forceinline__ void element(T* dst, const T* src, bool valid) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(static_cast<int>(sizeof(T))),
               "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

// 16 bytes (both addresses 16-byte aligned); when ``valid`` is false
// nothing is read and ``dst`` is zero-filled (``src`` must still be a
// mapped address).
__device__ __forceinline__ void bytes16(void* dst, const void* src,
                                        bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 16 bytes (both addresses 16-byte aligned) of which the first ``n`` (0 to
// 16) are read from ``src`` and the rest of ``dst`` is zero-filled.
__device__ __forceinline__ void bytes16_n(void* dst, const void* src, int n) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n) : "memory");
}

// ``width`` bytes (16, 8 or 4; both addresses aligned to it).
__device__ __forceinline__ void piece(void* dst, const void* src, int width) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}

// A flat copy of ``nbytes`` (a multiple of ``width``) by the 32 lanes of a
// warp, neighbouring lanes on neighbouring pieces.
__device__ __forceinline__ void warp_copy(void* dst, const void* src,
                                          int nbytes, int width, int lane) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int o = lane * width; o < nbytes; o += 32 * width)
    piece(d + o, s + o, width);
}

// Closes the group of copies this thread has issued since the last commit.
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace acopy

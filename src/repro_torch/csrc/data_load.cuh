// Loads of kernel-evaluation data in another type than the arithmetic's:
// the bfloat16-data entries of B1 and B2 (build_stage.cu), B8 and B9
// (build_dist.cu) and B7 (oos_contract.cu), which a mixed-precision policy
// (SolveConfig.precision "bf16") feeds bfloat16 points, landmarks,
// queries or cached distance tiles beside float32 factors.  Each datum is
// converted to float32 as it is loaded, so from there an entry computes
// exactly what its float32 entry computes; S = T gives the float32 and
// float64 entries their own loads back (cp.async where they stage).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "async_copy.cuh"

namespace dload {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// *p as a T.
template <typename T, typename S>
__device__ __forceinline__ T load(const S* p) {
  return static_cast<T>(widen(*p));
}

// *p as a T through the read-only cache.
template <typename T, typename S>
__device__ __forceinline__ T ldg(const S* p) {
  return static_cast<T>(widen(__ldg(p)));
}

// One datum from ``src`` into the T at ``dst`` (shared memory); when
// ``valid`` is false nothing is read and ``dst`` is zero.  S = T copies
// with cp.async (acopy::element, the caller commits and waits); a
// bfloat16 datum (2 bytes, below cp.async's 4) is loaded, converted and
// stored by the thread itself, complete when the caller's barrier is.
template <typename T, typename S>
__device__ __forceinline__ void stage(T* dst, const S* src, bool valid) {
  if constexpr (std::is_same_v<T, S>) {
    acopy::element(dst, src, valid);
  } else {
    *dst = valid ? load<T>(src) : T(0);
  }
}

}  // namespace dload

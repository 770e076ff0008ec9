// Distance -> kernel value: the base-kernel nonlinearities applied as a
// tile epilogue, the CUDA counterpart of
// src/repro/kernels/kernel_tile/kernel_tile.py::kernel_epilogue, and the
// launch helpers every kernel library shares.
//   gaussian  exp(-d2 / (2 sigma^2))      d2 = squared Euclidean distance
//   imq       sigma / sqrt(d2 + sigma^2)
//   laplace   exp(-d1 / sigma)            d1 = Manhattan distance
#pragma once

#include <cuda_runtime.h>

enum KernelKind { KIND_GAUSSIAN = 0, KIND_IMQ = 1, KIND_LAPLACE = 2 };

__device__ __forceinline__ float ep_exp(float v) { return expf(v); }
__device__ __forceinline__ double ep_exp(double v) { return exp(v); }
__device__ __forceinline__ float ep_rsqrt(float v) { return rsqrtf(v); }
__device__ __forceinline__ double ep_rsqrt(double v) { return rsqrt(v); }

// True when the kernel consumes the Manhattan distance (else squared L2).
__device__ __forceinline__ bool kind_is_l1(int kind) {
  return kind == KIND_LAPLACE;
}

template <typename T>
__device__ __forceinline__ T kernel_epilogue(int kind, T dist, T sigma) {
  if (kind == KIND_GAUSSIAN) return ep_exp(dist * (T(-0.5) / (sigma * sigma)));
  if (kind == KIND_IMQ) return sigma * ep_rsqrt(dist + sigma * sigma);
  return ep_exp(-dist / sigma);
}

// Opts ``kernel`` in to ``smem`` bytes of dynamic shared memory when that is
// above the 48 KB default (a block can have at most 227 KB on the H100).
// Returns the CUDA error code, 0 on success.
template <typename Kernel>
int launch_with_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Every library exports this so its Python wrapper can name a launch error.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

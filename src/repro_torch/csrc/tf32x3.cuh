// Float32 products on the TF32 tensor cores, as accurate as float32:
// split TF32 ("3xTF32").  Shared by kernel_matvec.cu (B10, wgmma) and
// ssd_chunk.cu (B15, wgmma and mma.sync).
//
// Each float32 operand a is split as hi = tf32(a), rounded to nearest
// with ties away from zero (10 mantissa bits), and lo = a - hi, exact in
// float32 and at most 2^-11 |a|.  A product is then
//
//   a b = hi_a hi_b + hi_a lo_b + lo_a hi_b  (+ lo_a lo_b ~ 2^-22 a b, left out)
//
// three TF32 passes accumulated in float32; each TF32 x TF32 product is
// exact in float32.  So the product keeps ~21 of float32's 24 bits where
// one TF32 pass keeps 11, and the kernels meet the float32 gates (B10
// 2e-6 of max K|V|, B15 1e-5 of the componentwise magnitude) that one pass
// fails: tests/test_torch_tc_split.py emulates both kernels' arithmetic on
// the CPU, three passes and one, against the reference in float64.
//
// The tensor cores add each product group to the float32 accumulator with
// a truncating alignment.  B10 sums each Y tile's K V (48 passes) in an
// accumulator of its own and adds it to the running total with float32
// adds, so no accumulator spans its sweep over 3,632 tiles; B15's sums
// span at most 96 passes and stay in the accumulator.
//
// Fragments.  For m16n8k8 (mma.sync) and m64nNk8 (wgmma, each warp's 16
// rows) with .tf32 operands, thread (g = lane / 4, t = lane % 4) holds
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k t, n g), b1 (k t + 4, n g)
//   C/D:         c[4 j + e] at row g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
// so an accumulator of 8 columns is not an A fragment as it stands: its
// thread holds columns 2t, 2t + 1 where A wants t, t + 4.  Read as A
// ({c0, c2, c1, c3}), its logical column p stands for the real column
// KEY_OF[p] = (0, 2, 4, 6, 1, 3, 5, 7)[p]; the B operand's row p must then
// be the real row KEY_OF[p] too (B10 permutes V's rows in the wrapper;
// B15's wgmma kernel writes X^T's keys in that order, its mma.sync kernel
// reads X's rows 2t and 2t + 1 for b0 and b1).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace tf32x3 {

// a -> (hi, lo) as the bit patterns the tensor cores read.  hi is
// cvt.rna.tf32.f32's value, computed as the integer add of half a unit of
// the 10th mantissa bit and the clearing of the 13 bits below it (two
// integer operations; cvt's own sequence is longer); lo = a - hi keeps its
// low 13 bits, which the tensor core drops as it reads a TF32 operand
// (rounding toward zero): at most 2^-11 |lo| <= 2^-22 |a|.  Finite a only.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// The A fragment of an 8-column group of an accumulator (see above):
// {c0, c2, c1, c3}, split.
__device__ __forceinline__ void acc_as_a(const float* c, uint32_t* hi,
                                         uint32_t* lo) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// ---------------------------------------------------------------------------
// mma.sync.m16n8k8 (one warp)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in three passes, the small terms first.
__device__ __forceinline__ void mma3(float* c, const uint32_t* ahi,
                                     const uint32_t* alo, const uint32_t* bhi,
                                     const uint32_t* blo) {
  mma(c, alo, bhi);
  mma(c, ahi, blo);
  mma(c, ahi, bhi);
}

// ---------------------------------------------------------------------------
// wgmma.m64nNk8 .tf32 (one warpgroup).  Both operands K-major (.tf32 has no
// transpose); ``scale_d`` 0 overwrites d, 1 accumulates.
// ---------------------------------------------------------------------------

// d (64 x 128) (+)= A B^T, A (64 x 8) and B (128 x 8) in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WG_R56
      "}, %64, %65, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) (+)= A B^T, A (64 x 8) and B (64 x 8) in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_R24
      "}, %32, %33, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N) (+)= A B^T, A (64 x 8) from registers (each warp's m16n8k8 A
// fragment), B (N x 8) in shared memory.
__device__ __forceinline__ void wgmma_rs_n8(float* d, const uint32_t* a,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {" WG_R0
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : WG_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" WG_R8
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_R24
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64, "N");
  if constexpr (N == 8) wgmma_rs_n8(d, a, db, scale_d);
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, scale_d);
  if constexpr (N == 32) wgmma_rs_n32(d, a, db, scale_d);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
}

// d (+)= A B^T in three passes, the small terms first; scale_d applies to
// the first.
__device__ __forceinline__ void wgmma3_ss_n128(float* d, uint64_t ahi,
                                              uint64_t alo, uint64_t bhi,
                                              uint64_t blo, int scale_d) {
  wgmma_ss_n128(d, alo, bhi, scale_d);
  wgmma_ss_n128(d, ahi, blo, 1);
  wgmma_ss_n128(d, ahi, bhi, 1);
}

__device__ __forceinline__ void wgmma3_ss_n64(float* d, uint64_t ahi,
                                             uint64_t alo, uint64_t bhi,
                                             uint64_t blo, int scale_d) {
  wgmma_ss_n64(d, alo, bhi, scale_d);
  wgmma_ss_n64(d, ahi, blo, 1);
  wgmma_ss_n64(d, ahi, bhi, 1);
}

template <int N>
__device__ __forceinline__ void wgmma3_rs(float* d, const uint32_t* ahi,
                                          const uint32_t* alo, uint64_t bhi,
                                          uint64_t blo, int scale_d) {
  wgmma_rs<N>(d, alo, bhi, scale_d);
  wgmma_rs<N>(d, ahi, blo, 1);
  wgmma_rs<N>(d, ahi, bhi, 1);
}

}  // namespace tf32x3

// The 3×TF32 split shared by the tensor-core kernels (attention.cu,
// hyplinear.cu): `mma.sync.m16n8k8` TF32 products at near f32 accuracy.
//
// TF32 keeps 10 mantissa bits, so every operand x is split into hi (x
// rounded to TF32, to nearest, ties away from zero, as `cvt.rna`) and lo
// (x − hi, exact), and a product is taken as lo·hi' + hi·lo' + hi·hi'
// with f32 accumulation (CUTLASS's OpMultiplyAddFastF32).
// tests/test_torch_tf32_split.py and tests/test_torch_hyplinear_split.py
// emulate the scheme on the CPU against float64.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned TF32_MASK = 0xffffe000u;  // sign, exponent, 10 bits

// x = hi + lo + (a remainder below 2^-21·|x|), both TF32, as the tensor
// core reads them: hi is `cvt.rna.tf32.f32` of x (round to nearest, ties
// away from zero) and lo is x − hi (exact) with its 13 low bits dropped.
// The tensor core reads neither operand's 13 low bits, so hi goes to it
// unmasked (the rounding carry already in) and lo untruncated: the same
// products, one operation fewer.  Integer and f32 ops only: a `cvt` runs
// at a quarter of their rate, and the split is taken for every operand a
// warp reads.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi & TF32_MASK)));
}

// c += a·b for one m16n8k8 tile (A row-major, B column-major)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b at near f32 accuracy: lo·hi + hi·lo, then hi·hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4], float b0,
                                           float b1) {
  unsigned bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

}  // namespace

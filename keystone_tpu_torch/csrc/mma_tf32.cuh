// Float32 products on the tensor cores in 3xTF32 (mma.sync m16n8k8), shared
// by the kernels of this directory.
//
// An f32 operand a is split into a_hi = tf32(a) and a_lo = tf32(a − a_hi)
// (round to nearest, ties away). a·b is then a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi, accumulated in f32 with the small terms first; the dropped
// a_lo·b_lo is below f32's own rounding. A plain TF32 product keeps about
// three decimal digits, which the reference's Precision.HIGHEST bars do
// not allow.
//
// Fragments of mma.sync.m16n8k8 .tf32 (PTX ISA), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, K x N):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8, f32):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
#pragma once

#include <cstdint>

// tf32(a): round to nearest, ties away from zero (cvt.rna.tf32.f32 for a
// finite a), as two integer instructions: add half a TF32 ulp to the
// magnitude's bits, clear the 13 bits TF32 drops
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a -> (tf32(a), tf32(a − tf32(a))); the difference is exact in f32
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(__fsub_rn(a, __uint_as_float(hi)));
}

// c += a · b, one TF32 product
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a · b in 3xTF32
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// The int8 tensor-core building block of the port's int8 convolution (K7 in
// conv_int8.cu), beside the bfloat16 one in bf16_mma.cuh and the 3xTF32 one
// in tf32_mma.cuh, for NVIDIA Hopper (sm_90a): one mma.sync m16n8k32 with
// signed 8-bit operands and signed 32-bit accumulators, and the packing of
// four int8 values into one of its registers.
//
// An int8 product is exact in int32 and so is the tensor cores' integer
// accumulation (it wraps only past 2^31, which 127 * 127 * K reaches at K of
// 133,000 and more), so unlike TF32 and bfloat16 no kernel needs a fresh
// partial accumulator every few k-steps. Fragments (PTX ISA, mma.m16n8k32
// .s8): A row-major, a0 = A[g][4t..4t+3], a1 = A[g+8][4t..4t+3], a2 =
// A[g][16+4t..16+4t+3], a3 = A[g+8][16+4t..16+4t+3]; B column-major, b0 =
// B[4t..4t+3][g], b1 = B[16+4t..16+4t+3][g]; C, D: c0, c1 = C[g][2t..2t+1],
// c2, c3 = C[g+8][2t..2t+1] (g = lane / 4, t = lane % 4); the lowest k index
// in the lowest byte of a register.
//
// Each kernel source includes it once; the build (ops/_build.py) hashes every
// header under csrc/ into each library's name, so an edit here rebuilds them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// four int8 values in one mma register, v0 the lowest k index
__device__ __forceinline__ uint32_t pack_s8(int8_t v0, int8_t v1, int8_t v2, int8_t v3) {
  return (uint32_t)(uint8_t)v0 | ((uint32_t)(uint8_t)v1 << 8) | ((uint32_t)(uint8_t)v2 << 16) |
         ((uint32_t)(uint8_t)v3 << 24);
}

// d += a * b for one m16n8k32 tile, int8 operands, int32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace

// The bfloat16 tensor-core building block of the port's ConvLSTM kernels (K2
// in convlstm.cu, the chain-step and dx tile in convlstm_seq.cu, the weight
// gradient in convlstm_bwd.cu), beside the 3xTF32 one in tf32_mma.cuh, for
// NVIDIA Hopper (sm_90a): one mma.sync m16n8k16 with bfloat16 operands and
// float32 accumulators, the packing of two bfloat16 operands into one of
// its registers, the per-op bfloat16 rounding of the gate algebra, and the
// copies of a few bfloat16 elements into shared memory.
//
// A product of two bfloat16 values is exact in float32, so one mma replaces
// the three of 3xTF32; the tensor cores still truncate what they add into an
// accumulator, so a kernel adds a fresh partial accumulator into its float32
// result every few k-steps, as with TF32. Fragments (PTX ISA, mma.m16n8k16
// .bf16): A row-major, a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1], a2 =
// A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]; B column-major, b0 =
// B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]; C as m16n8k8's (g = lane / 4, t =
// lane % 4); the lower k index in the low half of a register.
//
// Each kernel source includes it once; the build (ops/_build.py) hashes every
// header under csrc/ into each library's name, so an edit here rebuilds them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

template <typename T>
constexpr bool kIsBf16 = sizeof(T) == 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to bfloat16 (nearest even) and back: one bfloat16 op's result
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// two bfloat16 operands in one mma register, lo the lower k index
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a * b for one m16n8k16 tile, bfloat16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// n contiguous elements global -> shared (n * sizeof(T) of 16, 8 or 4
// bytes by cp.async, zero-filled when !valid; fewer bytes, one bfloat16, by
// a plain load and store, which the barrier before the stage's use orders)
template <typename T>
__device__ __forceinline__ void copy_elems(T* dst, const T* src, int n, bool valid) {
  const int bytes = n * (int)sizeof(T);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 8 : 0));
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
  } else {
    for (int i = 0; i < n; ++i) dst[i] = valid ? src[i] : from_f<T>(0.f);
  }
}

// The Keras hard sigmoid and its derivative in the layer's type: float32
// rounding each product and sum (as PyTorch's float32 ops), or bfloat16
// rounding each op's result, 0.2 itself a bfloat16 (as JAX's bfloat16 ops
// with a weakly typed 0.2)
template <typename T>
__device__ __forceinline__ float hsig(float z) {
  if constexpr (kIsBf16<T>)
    return fminf(fmaxf(rb(__fadd_rn(rb(__fmul_rn(0.2001953125f, z)), 0.5f)), 0.f), 1.f);
  else
    return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, z), 0.5f), 0.f), 1.f);
}

template <typename T>
__device__ __forceinline__ float d_hsig(float z) {
  const float g = hsig<T>(z);
  return g > 0.f && g < 1.f ? (kIsBf16<T> ? 0.2001953125f : 0.2f) : 0.f;
}

// one op of the gate algebra: its float32 result, rounded to bfloat16 in a
// bfloat16 layer
template <typename T>
__device__ __forceinline__ float op(float v) {
  if constexpr (kIsBf16<T>)
    return rb(v);
  else
    return v;
}

// the gate algebra's ops, each rounded once (no contraction into an FMA)
template <typename T>
__device__ __forceinline__ float mul(float a, float b) { return op<T>(__fmul_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float add(float a, float b) { return op<T>(__fadd_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float sub(float a, float b) { return op<T>(__fsub_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float tanh_(float z) { return op<T>(tanhf(z)); }

}  // namespace

// The 3xTF32 tensor-core building block of the port's ConvLSTM kernels (K2
// in convlstm.cu, the chain-step and dx tile in convlstm_seq.cu, the weight
// gradient in convlstm_bwd.cu), for NVIDIA Hopper (sm_90a): cp.async copies
// into shared memory, the split of a float32 operand into TF32 hi and lo
// parts with cvt.rna rounding, and one mma.sync m16n8k8 TF32 product with
// float32 accumulators. A kernel forms a float32 product as hi*lo + lo*hi +
// hi*hi (lo*lo lies below float32's rounding) and adds a fresh partial
// accumulator into its float32 result every few k-steps: the tensor cores
// truncate what they accumulate.
//
// Each kernel source includes it once; the build (ops/_build.py) hashes every
// header under csrc/ into each library's name, so an edit here rebuilds them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// float32 -> TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), on the integer pipes: the sign-magnitude bits plus half a
// TF32 ulp, the 13 low bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, each a TF32 value
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a * b for one m16n8k8 tile, TF32 operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace

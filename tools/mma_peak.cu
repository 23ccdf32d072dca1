// Peak-rate probes for tools/torch_mma_peak.py: every thread runs `iters`
// rounds of 8 independent chains of one instruction, so that the SMs'
// issue of that instruction, not latency, bounds the loop.
//   mma_peak   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, the
//              tensor-core product K2 (csrc/convlstm.cu) issues three of
//              for each float32 product (3xTF32); 2*16*8*8 flops each
//   ffma_peak  float32 fused multiply-add outside the tensor cores; 2 flops
//   mma_bf16_peak  mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, the
//              product the bfloat16 forms of K2, K3 and K4 run once for
//              each bfloat16 product; 2*16*8*16 flops each
// Results are kept alive by a store that never happens.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void mma_peak(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t t = threadIdx.x;
  const uint32_t a[4] = {t, t + 1, t + 2, t + 3};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(acc[j], a, t * 3, t * 5);
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 1.2345f) out[0] = s;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void mma_bf16_peak(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t t = threadIdx.x;
  const uint32_t a[4] = {t, t + 1, t + 2, t + 3};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_bf16(acc[j], a, t * 3, t * 5);
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 1.2345f) out[0] = s;
}

__global__ void ffma_peak(float* out, int iters) {
  float x[8];
  for (int j = 0; j < 8; ++j) x[j] = threadIdx.x * 0.001f + j;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = fmaf(x[j], 0.9999f, 0.0001f);
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += x[j];
  if (s == 1.2345f) out[0] = s;
}

}  // namespace

// kind 0: mma_peak, 1: ffma_peak, 2: mma_bf16_peak, on `blocks` blocks of
// 256 threads. Returns the cudaError_t of the launch.
extern "C" int dl4ds_peak(int kind, int blocks, int iters, float* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    mma_peak<<<blocks, 256, 0, s>>>(out, iters);
  else if (kind == 1)
    ffma_peak<<<blocks, 256, 0, s>>>(out, iters);
  else
    mma_bf16_peak<<<blocks, 256, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}

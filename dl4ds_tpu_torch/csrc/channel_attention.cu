// Fused squeeze-excite channel-attention gate (K1) for NVIDIA Hopper (sm_90a).
//
//   m = mean_HW(x)   h = relu(m @ w1 + b1)   g = sigmoid(h @ w2 + b2)   y = x * g
//
// x and y are NHWC, [B, HW, C] in memory, float32 or bfloat16; w1 [C, Cr],
// b1 [Cr], w2 [Cr, C], b2 [C] are float32. Every sum is taken in float32;
// g is computed in float32, rounded to x's type and then multiplied, as the
// TPU kernel does (dl4ds_tpu/ops/pallas_ops.py:39-50).
//
// Replaces: dl4ds_tpu/ops/pallas_ops.py `_forward_pallas` -> `_kernel`
// (one grid step per sample with the whole feature map held in VMEM).
//
// Bound: device memory. The gate does ~2 flops per element against 4 (f32)
// or 2 (bf16) bytes read and as many written, far below the H100's ~20
// flop/byte float32 ridge. The least traffic is one read and one write of x:
// at batch 8 in float32 the six backbone gates of the flagship model
// (128x128, C = 8..48) and its output-head gate (512x512, C = 8) move about
// 310 MB per forward, about 93 us at 3.35 TB/s.
//
// Design: the TPU holds a sample on chip between the reduction and the
// multiply; an SM's 227 KB of shared memory cannot hold a 512x512x8 float32
// sample (8 MB), and one block per sample would leave most of the 132 SMs
// idle at batch 8. So the work is split into three launches on one stream:
//   1. ca_partial_sums: blocks over (HW chunks, B, channel tiles). Neighbouring
//      threads read neighbouring channels of a row, so each warp reads
//      consecutive addresses; the per-block sums go to a float32 scratch
//      [B, chunks, C] that the caller allocated. Enough chunks are made to
//      give every SM work at any batch size.
//   2. ca_gate: one block per sample finishes the mean and runs the two small
//      mat-vecs with relu and sigmoid in float32, writing g [B, C].
//   3. ca_apply: y = x * g[b, c], 16-byte vector loads and stores where C and
//      the pointers allow it.
// x is read twice (steps 1 and 3), so the traffic is 1.5x the bound unless
// the second read hits the 50 MB L2 (it can for the 128x128 backbone maps,
// not for the 67 MB output-head map). Keeping a sample resident, or fusing
// steps 2 and 3, is the way below that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Per-block partial sums over rows [chunk * rows_per_chunk, +rows_per_chunk)
// of sample b, for the channel tile [c0, c0 + ctile). ctile <= kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ca_partial_sums(const T* __restrict__ x, float* __restrict__ partial,
                int64_t hw, int c, int rows_per_chunk, int chunks, int ctile) {
  __shared__ float smem[kThreads];
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * ctile;
  const int groups = kThreads / ctile;
  const int t = threadIdx.x;
  const int g = t / ctile;
  const int ch = c0 + t % ctile;

  float acc = 0.f;
  if (g < groups && ch < c) {
    const int64_t r_begin = (int64_t)chunk * rows_per_chunk;
    const int64_t r_stop = r_begin + rows_per_chunk;
    const int64_t r_end = r_stop < hw ? r_stop : hw;
    const T* xb = x + (int64_t)b * hw * c;
    for (int64_t r = r_begin + g; r < r_end; r += groups)
      acc += to_float(xb[r * c + ch]);
  }
  smem[t] = acc;
  __syncthreads();
  if (t < ctile && ch < c) {  // here g == 0 and ch == c0 + t
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += smem[k * ctile + t];
    partial[((int64_t)b * chunks + chunk) * c + ch] = s;
  }
}

// One block per sample: mean, both mat-vecs, relu and sigmoid, in float32.
// Dynamic shared memory: m [c] then h [cr].
__global__ void __launch_bounds__(kThreads)
ca_gate(const float* __restrict__ partial, const float* __restrict__ w1,
        const float* __restrict__ b1, const float* __restrict__ w2,
        const float* __restrict__ b2, float* __restrict__ gate,
        int chunks, int c, int cr, float hw) {
  extern __shared__ float sh[];
  float* m = sh;
  float* h = sh + c;
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const float* p = partial + (int64_t)b * chunks * c + j;
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += p[(int64_t)k * c];
    m[j] = s / hw;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < cr; r += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < c; ++j) s += m[j] * w1[j * cr + r];
    h[r] = fmaxf(s + b1[r], 0.f);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < cr; ++r) s += h[r] * w2[r * c + j];
    gate[(int64_t)b * c + j] = 1.f / (1.f + expf(-(s + b2[j])));
  }
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// y = x * g[b, c]. Each thread handles VEC consecutive elements; the caller
// guarantees C % VEC == 0, so they share one sample and one pixel.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ca_apply(const T* __restrict__ x, const float* __restrict__ gate,
         T* __restrict__ y, int64_t n_vec, int64_t hwc, int c) {
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x);
  Pack<T, VEC>* yv = reinterpret_cast<Pack<T, VEC>*>(y);
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = v * VEC;
    const float* gb = gate + (i / hwc) * c + (int)(i % c);
    Pack<T, VEC> p = xv[v];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gk = to_float(from_float<T>(gb[k]));  // g rounded to x's type
      p.v[k] = from_float<T>(to_float(p.v[k]) * gk);
    }
    yv[v] = p;
  }
}

template <typename T, int VEC>
cudaError_t launch_apply(const void* x, const float* gate, void* y, int64_t n,
                         int64_t hwc, int c, int apply_blocks, cudaStream_t stream) {
  const int64_t n_vec = n / VEC;
  const int64_t need = (n_vec + kThreads - 1) / kThreads;
  const int blocks = (int)(need < apply_blocks ? need : apply_blocks);
  ca_apply<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), gate, static_cast<T*>(y), n_vec, hwc, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const float* w1, const float* b1, const float* w2,
                const float* b2, float* partial, float* gate, void* y, int batch,
                int64_t hw, int c, int cr, int chunks, int rows_per_chunk, int vec,
                int apply_blocks, cudaStream_t stream) {
  const int ctile = c < kThreads ? c : kThreads;
  const dim3 grid1(chunks, batch, (c + ctile - 1) / ctile);
  ca_partial_sums<T><<<grid1, kThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, hw, c, rows_per_chunk, chunks, ctile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t shmem = sizeof(float) * (size_t)(c + cr);
  ca_gate<<<batch, kThreads, shmem, stream>>>(partial, w1, b1, w2, b2, gate, chunks,
                                              c, cr, (float)hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t n = (int64_t)batch * hw * c;
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) return launch_apply<T, kVec>(x, gate, y, n, hw * c, c, apply_blocks, stream);
  if (vec == 1) return launch_apply<T, 1>(x, gate, y, n, hw * c, c, apply_blocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launches
// (0 on success). Launches on `stream`, does not synchronise, allocates
// nothing: `partial` [B, chunks, C] and `gate` [B, C] are float32 scratch
// from the caller.
extern "C" int dl4ds_channel_attention(int dtype, const void* x, const float* w1,
                                       const float* b1, const float* w2,
                                       const float* b2, float* partial, float* gate,
                                       void* y, int batch, long long hw, int c, int cr,
                                       int chunks, int rows_per_chunk, int vec,
                                       int apply_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = run<float>(x, w1, b1, w2, b2, partial, gate, y, batch, hw, c, cr, chunks,
                     rows_per_chunk, vec, apply_blocks, s);
  else if (dtype == 1)
    err = run<__nv_bfloat16>(x, w1, b1, w2, b2, partial, gate, y, batch, hw, c, cr,
                             chunks, rows_per_chunk, vec, apply_blocks, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// K7: the int8 convolution of the port's post-training quantization
// (dl4ds_tpu_torch/quantization.py), for NVIDIA Hopper (sm_90a). It takes
// the place of XLA's s8 x s8 -> s32 convolution in the JAX package's int8
// replay (dl4ds_tpu/quantization.py:276-282); no Pallas kernel computes it.
//
//   y[b, oy, ox, co] = out_type(float(sum_{ky, kx, ci} x[b, iy, ix, ci] *
//                                     w[co, ky, kx, ci]) * scale[co])
//
// x is NHWC int8 (the activation, quantized per tensor before the launch),
// w the int8 weight packed once at quantization time, scale[co] = s_x *
// s_w[co] in float32 (formed on the host, as the JAX package's
// `_requant_scale`), and out_type float32, bfloat16 (round to nearest even)
// or int32 (the raw sums, scale unused: the checks' form). The sum is exact
// in int32. iy = (oy * stride + ky - pad_top) / dil where that divides and
// lies in [0, h), else the tap reads 0; ix likewise: stride and the four
// paddings of the port's `Conv` (SAME, VALID, strided SAME), and `dil` the
// input dilation of the port's `ConvTranspose` (its stride), so a transposed
// convolution runs here as the correlation of the dilated, padded input
// with the unflipped kernel, as `lax.conv_transpose` lowers it.
//
// Dense (groups 1): an implicit GEMM on the tensor cores, M = output pixels,
// N = Co, K = kh * kw * Cin zero-padded to a multiple of 32; the weight
// packed as [Co_pad, K_pad] with k = (ky * kw + kx) * Cin + ci, which is the
// column-major B of mma.sync m16n8k32 (s8_mma.cuh). A block of 4 warps takes
// 128 output pixels and 8 * NT output channels; each thread gathers one
// pixel's 32 k values of a stage into shared memory (V of them a load: 16 or
// 4 bytes where Cin allows, else one), then each warp runs 2 x NT mma over
// its 32 pixels. Depthwise (groups = Cin = Co, the ConvNeXt block's 7x7): a
// plain integer loop, one thread an output value, the weight packed as
// [C, kh * kw]. wgmma, TMA and the activation's quantization fused into the
// loads are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_mma.cuh"

namespace {

constexpr int kBM = 128;        // output pixels a block (dense)
constexpr int kBK = 32;         // k values a stage: one mma k-step
constexpr int kThreads = 128;   // 4 warps of 32 pixel rows each
constexpr int kRow = 48;        // bytes a shared row: 32 used, 48 spread the banks
constexpr int kDwThreads = 256;

long long g_launched = 0;

struct Geometry {
  int batch, h, w, cin, ho, wo, co, kh, kw, stride, dil, pad_t, pad_l;
  int k;         // kh * kw * cin
  int k_pad;     // k rounded up to kBK (dense)
  long long m;   // batch * ho * wo
};

__device__ __forceinline__ void store(float* y, long long i, int acc, float s) {
  y[i] = __fmul_rn(__int2float_rn(acc), s);
}
__device__ __forceinline__ void store(__nv_bfloat16* y, long long i, int acc, float s) {
  y[i] = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), s));
}
__device__ __forceinline__ void store(int* y, long long i, int acc, float) { y[i] = acc; }

// the input row and column of a tap, or -1 where the tap reads the padding
// or a zero of the dilation
__device__ __forceinline__ int source(int p, int dil, int n) {
  if (p < 0) return -1;
  if (dil > 1) {
    if (p % dil) return -1;
    p /= dil;
  }
  return p < n ? p : -1;
}

template <int V, int NT, typename OutT>
__global__ void __launch_bounds__(kThreads)
    conv_s8_dense(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, OutT* __restrict__ y, Geometry g) {
  __shared__ __align__(16) int8_t s_a[kBM * kRow];
  __shared__ __align__(16) int8_t s_b[NT * 8 * kRow];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * NT * 8;

  // this thread gathers row `tid` of every A stage: output pixel m0 + tid
  const long long m = m0 + tid;
  const bool row_ok = m < g.m;
  int b = 0, oy = 0, ox = 0;
  if (row_ok) {
    ox = (int)(m % g.wo);
    const long long r = m / g.wo;
    oy = (int)(r % g.ho);
    b = (int)(r / g.ho);
  }
  const int8_t* xb = x + (long long)b * g.h * g.w * g.cin;
  const int py0 = oy * g.stride - g.pad_t, px0 = ox * g.stride - g.pad_l;
  // (ky, kx, ci) of the next k this thread gathers, carried across stages
  int ky = 0, kx = 0, ci = 0, k = 0;

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < g.k_pad; k0 += kBK) {
    // A: 32 k values of pixel m, V at a time (V divides Cin, so a group of V
    // lies in one tap, its channels contiguous in x)
    int8_t* dst = s_a + tid * kRow;
#pragma unroll
    for (int j = 0; j < kBK; j += V) {
      bool ok = row_ok && k < g.k;
      int iy = -1, ix = -1;
      if (ok) {
        iy = source(py0 + ky, g.dil, g.h);
        ix = source(px0 + kx, g.dil, g.w);
        ok = iy >= 0 && ix >= 0;
      }
      const int8_t* src = xb + ((long long)iy * g.w + ix) * g.cin + ci;
      if constexpr (V == 16) {
        *reinterpret_cast<int4*>(dst + j) =
            ok ? *reinterpret_cast<const int4*>(src) : make_int4(0, 0, 0, 0);
      } else if constexpr (V == 4) {
        *reinterpret_cast<uint32_t*>(dst + j) = ok ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      } else {
        dst[j] = ok ? *src : (int8_t)0;
      }
      k += V;
      ci += V;
      if (ci == g.cin) {
        ci = 0;
        if (++kx == g.kw) {
          kx = 0;
          ++ky;
        }
      }
    }
    // B: rows n0 .. n0 + 8 NT of the packed weight, 32 bytes each
    for (int i = tid; i < NT * 8 * 2; i += kThreads) {
      const int n = i >> 1, half = i & 1;
      *reinterpret_cast<int4*>(s_b + n * kRow + half * 16) = *reinterpret_cast<const int4*>(
          w + (long long)(n0 + n) * g.k_pad + k0 + half * 16);
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* ar = s_a + (warp * 32 + mt * 16 + gq) * kRow + 4 * tq;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ar);
      a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kRow);
      a[2] = *reinterpret_cast<const uint32_t*>(ar + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kRow + 16);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* br = s_b + (nt * 8 + gq) * kRow + 4 * tq;
        mma_s8(acc[mt][nt], a, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 16));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + warp * 32 + mt * 16 + gq + half * 8;
      if (row >= g.m) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + nt * 8 + 2 * tq + e;
          if (col < g.co) store(y, row * g.co + col, acc[mt][nt][half * 2 + e], scale[col]);
        }
      }
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kDwThreads)
    conv_s8_depthwise(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, OutT* __restrict__ y, Geometry g) {
  const long long i = (long long)blockIdx.x * kDwThreads + threadIdx.x;
  if (i >= g.m * g.co) return;
  const int c = (int)(i % g.co);
  const long long m = i / g.co;
  const int ox = (int)(m % g.wo);
  const long long r = m / g.wo;
  const int oy = (int)(r % g.ho), b = (int)(r / g.ho);
  const int8_t* xb = x + (long long)b * g.h * g.w * g.cin + c;
  const int8_t* wc = w + (long long)c * g.kh * g.kw;
  int acc = 0;
  for (int ky = 0; ky < g.kh; ++ky) {
    const int iy = source(oy * g.stride - g.pad_t + ky, g.dil, g.h);
    if (iy < 0) continue;
    for (int kx = 0; kx < g.kw; ++kx) {
      const int ix = source(ox * g.stride - g.pad_l + kx, g.dil, g.w);
      if (ix < 0) continue;
      acc += (int)xb[((long long)iy * g.w + ix) * g.cin] * (int)wc[ky * g.kw + kx];
    }
  }
  store(y, i, acc, scale[c]);
}

template <typename OutT>
cudaError_t launch_dense(int nt, int vec, const int8_t* x, const int8_t* w, const float* scale,
                         OutT* y, const Geometry& g, cudaStream_t s) {
  const dim3 grid((unsigned)((g.m + kBM - 1) / kBM), (unsigned)((g.co + nt * 8 - 1) / (nt * 8)));
#define DL4DS_K7_DENSE(V, NT)                                                   \
  if (vec == V && nt == NT) {                                                   \
    conv_s8_dense<V, NT, OutT><<<grid, kThreads, 0, s>>>(x, w, scale, y, g);    \
    return cudaGetLastError();                                                  \
  }
#define DL4DS_K7_DENSE_NT(V) \
  DL4DS_K7_DENSE(V, 1) DL4DS_K7_DENSE(V, 2) DL4DS_K7_DENSE(V, 4) DL4DS_K7_DENSE(V, 8)
  DL4DS_K7_DENSE_NT(1)
  DL4DS_K7_DENSE_NT(4)
  DL4DS_K7_DENSE_NT(16)
#undef DL4DS_K7_DENSE_NT
#undef DL4DS_K7_DENSE
  return cudaErrorInvalidValue;
}

template <typename OutT>
cudaError_t launch(int depthwise, int nt, int vec, const void* x, const void* w,
                   const float* scale, void* y, const Geometry& g, cudaStream_t s) {
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  OutT* yo = static_cast<OutT*>(y);
  if (depthwise) {
    const long long n = g.m * g.co;
    conv_s8_depthwise<OutT>
        <<<(unsigned)((n + kDwThreads - 1) / kDwThreads), kDwThreads, 0, s>>>(xi, wi, scale, yo, g);
    return cudaGetLastError();
  }
  return launch_dense<OutT>(nt, vec, xi, wi, scale, yo, g, s);
}

}  // namespace

// The number of kernels this library has launched since it was loaded.
extern "C" long long dl4ds_conv_int8_launched() { return g_launched; }

// One int8 convolution. out_type: 0 float32, 1 bfloat16, 2 int32 (the raw
// sums); depthwise: 1 for groups = cin = co (w [co, kh * kw]), 0 for groups 1
// (w [co_pad, k_pad], co_pad a multiple of 8 * nt and at least co, k_pad a
// multiple of 32 and at least kh * kw * cin); nt: 1, 2, 4 or 8 column tiles
// of 8 channels a block; vec: 1, 4 or 16 input bytes a load, dividing cin (x
// and w 16-byte aligned for 16, x 4-byte aligned for 4). x [batch, h, w,
// cin] int8, y [batch, ho, wo, co], scale [co] float32. Returns the
// cudaError_t of the launch (0 on success); launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int dl4ds_conv_int8(int out_type, int depthwise, int nt, int vec, const void* x,
                               const void* w, const float* scale, void* y, int batch, int h,
                               int w_in, int cin, int ho, int wo, int co, int kh, int kw,
                               int stride, int dil, int pad_t, int pad_l, int k_pad, int co_pad,
                               void* stream) {
  Geometry g;
  g.batch = batch;
  g.h = h;
  g.w = w_in;
  g.cin = cin;
  g.ho = ho;
  g.wo = wo;
  g.co = co;
  g.kh = kh;
  g.kw = kw;
  g.stride = stride;
  g.dil = dil;
  g.pad_t = pad_t;
  g.pad_l = pad_l;
  g.k = kh * kw * cin;
  g.k_pad = k_pad;
  g.m = (long long)batch * ho * wo;
  const bool shape_ok = batch > 0 && h > 0 && w_in > 0 && cin > 0 && ho > 0 && wo > 0 && co > 0 &&
                        kh > 0 && kw > 0 && stride > 0 && dil > 0;
  const bool dense_ok = !depthwise && (nt == 1 || nt == 2 || nt == 4 || nt == 8) &&
                        (vec == 1 || vec == 4 || vec == 16) && cin % vec == 0 &&
                        k_pad % kBK == 0 && k_pad >= g.k && co_pad >= co &&
                        co_pad % (8 * nt) == 0;
  const bool dw_ok = depthwise && cin == co;
  if (!shape_ok || !(dense_ok || dw_ok) || out_type < 0 || out_type > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_type == 0)
    err = launch<float>(depthwise, nt, vec, x, w, scale, y, g, s);
  else if (out_type == 1)
    err = launch<__nv_bfloat16>(depthwise, nt, vec, x, w, scale, y, g, s);
  else
    err = launch<int>(depthwise, nt, vec, x, w, scale, y, g, s);
  if (err == cudaSuccess) ++g_launched;
  return (int)err;
}

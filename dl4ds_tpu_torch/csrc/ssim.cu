// Fused per-image SSIM (K6), forward and backward, for NVIDIA Hopper (sm_90a).
//
// For each single-channel image pair (x, y) of [N, H, W] float32, with the
// K-tap Gaussian g and VALID filtering (Hv = H - K + 1, Wv = W - K + 1):
//   mu1, mu2, mu11, mu22, mu12  = g (x) g applied to x, y, x^2, y^2, xy
//   L = A1 / B1,  A1 = 2 mu1 mu2 + c1,  B1 = mu1^2 + mu2^2 + c1
//   C = A2 / B2,  A2 = 2 (mu12 - mu1 mu2) + c2,  B2 = (mu11 - mu1^2) + (mu22 - mu2^2) + c2
//   ssim = mean over the Hv x Wv positions (and an output's channels) of S = L C,
// with c1 = (k1 max_val)^2 and c2 = (k2 max_val)^2 formed here from max_val,
// which is read from device memory (the loss passes the data range of its
// inputs as a device scalar, so no host read is needed). Every sum is
// float32 FMA (no TF32: mu11 - mu1^2 cancels); the taps are the float32
// taps of the host's Gaussian.
//
// The backward takes the upstream gradient gs [n_out] and, per position,
// with s = gs / (channels Hv Wv):
//   d mu12 = 2 L / B2,  d mu11 = d mu22 = -S / B2,
//   d mu1 = 2 C (mu2 - L mu1) / B1 + 2 L (C mu1 - mu2) / B2  (d mu2: 1 <-> 2),
//   dS/dc1 = C (1 - L) / B1,  dS/dc2 = L (1 - C) / B2,  all times s;
// then with F^T the transposed VALID filter (the full correlation with the
// taps reversed), separable:
//   d x = F^T(d mu1) + 2 x F^T(d mu11) + y F^T(d mu12)
//   d y = F^T(d mu2) + 2 y F^T(d mu22) + x F^T(d mu12)
//   d max_val = sum (dS/dc1 2 k1^2 max_val + dS/dc2 2 k2^2 max_val).
// It is ops/ssim.py `ssim_backward_reference`, the closed form of
// `jax.vjp` of the XLA ssim that the JAX package's fused SSIM runs as its
// backward.
//
// Replaces: dl4ds_tpu/ops/pallas_ops.py `_ssim_forward` -> `_ssim_kernel`
// (a grid step per 8 images, each image's five moments filtered by two
// dense band matmuls on the MXU, [Hv, H] @ [H, W] @ [W, Wv]), and its VJP
// `_bwd` (`jax.vjp` of the XLA ssim, which XLA fuses into a few loops).
//
// Bound: at [128, 64, 64] and 11 taps the forward's separable filters need
// (64*54 + 54*54) * 11 * 5 = 350,460 multiply-adds an image, 89.7 MFLOP for
// the batch (1.34 us at 67 TFLOP/s of float32) against 4.19 MB read (1.25
// us at 3.35 TB/s): below one launch's floor on the card.
//
// Design: the TPU's 54x64 band matrices are 83% zeros and exist only to feed
// the MXU; here the filters are direct, with the launch plan of
// ops/fused_ops.py `_ssim_plan` choosing one of two regimes per direction:
//   image: one block (512 threads) an output image holds each of its
//          channels' image pair, the five row-filtered moments (and in the
//          backward the four derivative maps) in shared memory: the
//          horizontal and the vertical pass, the SSIM algebra, a
//          fixed-order block sum, the per-image value written directly.
//          The backward then runs the transposed vertical and horizontal
//          passes of the maps and writes d y (and d x where asked). One
//          launch each way. At the losses' 11 taps (compiled in), a thread
//          takes 4 consecutive outputs of a pass with their inputs and the
//          taps in registers, reading an input once for 4 outputs.
//   tiles: images too large for one block: 16x32-output tiles with their
//          halo (shared memory under 48 KB for any H, W and up to kMaxTaps
//          taps). The forward writes a partial a tile; the last tile of an
//          output to arrive (an arrival counter after a __threadfence)
//          sums its partials in a fixed order: one launch. The backward
//          writes the four derivative maps to scratch (launch 1), then
//          filters them back over 16x32-pixel tiles (launch 2).
// d max_val sums per-block partials in block order in the last block of
// the grid to arrive. No float atomics: the bits repeat from run to run.
// The arrival counters are zero between launches (the last arrival resets
// them); the caller allocates them once per device, and launches that share
// them must be ordered on one stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 25;    // compiled maximum filter size
constexpr int kTileH = 16;      // output rows (backward launch 2: pixel rows) a tile
constexpr int kTileW = 32;      // output columns a tile
constexpr int kTileThreads = 256;
constexpr int kImageThreads = 512;
constexpr int kFixedTaps = 11;  // the filter size the image kernels take at compile time
// opt-in shared memory kept back from the dynamic allocation for the
// kernels' static shared variables
constexpr int kStaticSmemReserve = 1024;

struct Taps {
  float w[kMaxTaps];
};

struct Consts {
  float c1, c2, dc1, dc2;   // c1, c2 and their derivatives in max_val
};

__device__ __forceinline__ Consts consts(const float* max_val, float k1, float k2) {
  const float mv = *max_val;
  const float a1 = k1 * mv, a2 = k2 * mv;
  Consts k;
  k.c1 = a1 * a1;
  k.c2 = a2 * a2;
  k.dc1 = 2.f * k1 * k1 * mv;
  k.dc2 = 2.f * k2 * k2 * mv;
  return k;
}

__device__ __forceinline__ float ssim_value(float mu1, float mu2, float mu11, float mu22,
                                            float mu12, const Consts& k) {
  const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
  const float lum = (2.f * mu1_mu2 + k.c1) / (mu1_sq + mu2_sq + k.c1);
  const float cs = (2.f * (mu12 - mu1_mu2) + k.c2) / ((mu11 - mu1_sq) + (mu22 - mu2_sq) + k.c2);
  return lum * cs;
}

// The derivative maps at one position, times s: d[0] = d mu1, d[1] = d mu2,
// d[2] = d mu11 = d mu22, d[3] = d mu12; returns s dS/dmax_val.
__device__ __forceinline__ float ssim_grads(float mu1, float mu2, float mu11, float mu22,
                                            float mu12, const Consts& k, float s,
                                            float (&d)[4]) {
  const float b1 = mu1 * mu1 + mu2 * mu2 + k.c1;
  const float a1 = 2.f * mu1 * mu2 + k.c1;
  const float b2 = (mu11 - mu1 * mu1) + (mu22 - mu2 * mu2) + k.c2;
  const float a2 = 2.f * (mu12 - mu1 * mu2) + k.c2;
  const float l = a1 / b1, c = a2 / b2, sv = l * c;
  d[0] = s * (2.f * c * (mu2 - l * mu1) / b1 + 2.f * l * (c * mu1 - mu2) / b2);
  d[1] = s * (2.f * c * (mu1 - l * mu2) / b1 + 2.f * l * (c * mu2 - mu1) / b2);
  d[2] = s * (-sv / b2);
  d[3] = s * (2.f * l / b2);
  return s * (c * (1.f - l) / b1 * k.dc1 + l * (1.f - c) / b2 * k.dc2);
}

// Fixed-order block sum of one float a thread (butterfly within each warp,
// then thread 0 over the warps in order); the result is valid in thread 0.
template <int THREADS>
__device__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < THREADS / 32; ++i) s += warp_sums[i];
  __syncthreads();
  return s;
}

// Block-wide "am I the last of `total` arrivals on *counter" (see
// csrc/channel_attention.cu): fence, count, and the last resets the counter.
__device__ bool last_arrival(unsigned* counter, unsigned total) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned old = atomicAdd(counter, 1u);
    is_last = old == total - 1;
    if (is_last) *counter = 0u;
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// The fixed-order sum of n partials (strided over the block, then
// block_sum), valid in thread 0.
template <int THREADS>
__device__ float sum_partials(const float* p, long long n) {
  float v = 0.f;
  for (long long i = threadIdx.x; i < n; i += THREADS) v += __ldcg(p + i);
  return block_sum<THREADS>(v);
}

// Stage one h x w image of x and of y into shared memory.
template <int THREADS>
__device__ void stage_image(float* sx, float* sy, const float* __restrict__ x,
                            const float* __restrict__ y, int hw, bool vec4) {
  if (vec4) {
    for (int i = threadIdx.x * 4; i < hw; i += THREADS * 4) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(sx + i))),
                   "l"(x + i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(sy + i))),
                   "l"(y + i));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < hw; i += THREADS) {
      sx[i] = x[i];
      sy[i] = y[i];
    }
  }
  __syncthreads();
}

// Horizontal pass of a staged image: hm[q][r][c] for the five moments q, r <
// h, c < wv, plane = h * wv.
template <int THREADS>
__device__ void row_moments(const float* sx, const float* sy, float* hm, const float* sw,
                            int k, int h, int w, int wv) {
  const int plane = h * wv;
  for (int i = threadIdx.x; i < plane; i += THREADS) {
    const int r = i / wv, c = i % wv;
    const float* px = sx + r * w + c;
    const float* py = sy + r * w + c;
    float m1 = 0.f, m2 = 0.f, m11 = 0.f, m22 = 0.f, m12 = 0.f;
    for (int j = 0; j < k; ++j) {
      const float g = sw[j], a = px[j], b = py[j];
      m1 += g * a;
      m2 += g * b;
      m11 += g * (a * a);
      m22 += g * (b * b);
      m12 += g * (a * b);
    }
    hm[i] = m1;
    hm[plane + i] = m2;
    hm[2 * plane + i] = m11;
    hm[3 * plane + i] = m22;
    hm[4 * plane + i] = m12;
  }
  __syncthreads();
}

// The vertical pass at output (r, c) from row moments of row stride `ld`.
__device__ __forceinline__ void col_moments(const float* hm, int plane, int ld, int o,
                                            const float* sw, int k, float (&mu)[5]) {
#pragma unroll
  for (int q = 0; q < 5; ++q) mu[q] = 0.f;
  for (int j = 0; j < k; ++j) {
    const float g = sw[j];
#pragma unroll
    for (int q = 0; q < 5; ++q) mu[q] += g * hm[q * plane + o + j * ld];
  }
}

// ---------------------------------------------------------------------------
// image regime
// ---------------------------------------------------------------------------
//
// Each pass comes in two forms: for a filter size K fixed at compile time
// (the losses' 11 taps), a thread takes kRun consecutive outputs along the
// pass and holds their kRun + K - 1 inputs and the taps in registers, so
// that an input is read from shared memory once for kRun outputs, not K
// times; for K = 0 the size is a runtime value and a thread takes one
// output. Both sum the taps in the same order.

constexpr int kRun = 4;

// Horizontal pass: hm[q][r][c] for the five moments q, r < h, c < wv.
template <int K>
__device__ void image_rows(const float* sx, const float* sy, float* hm, const float* sw,
                           int k, int h, int w, int wv) {
  const int plane = h * wv;
  if constexpr (K == 0) {
    row_moments<kImageThreads>(sx, sy, hm, sw, k, h, w, wv);
    return;
  } else {
    float tap[K];
#pragma unroll
    for (int j = 0; j < K; ++j) tap[j] = sw[j];
    const int runs = (wv + kRun - 1) / kRun;
    for (int it = threadIdx.x; it < h * runs; it += kImageThreads) {
      const int r = it / runs, c0 = (it % runs) * kRun;
      float a[kRun + K - 1], b[kRun + K - 1];
#pragma unroll
      for (int i = 0; i < kRun + K - 1; ++i) {
        const int c = min(c0 + i, w - 1);   // past the row only for outputs past wv
        a[i] = sx[r * w + c];
        b[i] = sy[r * w + c];
      }
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        float m1 = 0.f, m2 = 0.f, m11 = 0.f, m22 = 0.f, m12 = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float g = tap[j], u = a[i + j], v = b[i + j];
          m1 += g * u;
          m2 += g * v;
          m11 += g * (u * u);
          m22 += g * (v * v);
          m12 += g * (u * v);
        }
        if (c0 + i < wv) {
          const int o = r * wv + c0 + i;
          hm[o] = m1;
          hm[plane + o] = m2;
          hm[2 * plane + o] = m11;
          hm[3 * plane + o] = m22;
          hm[4 * plane + o] = m12;
        }
      }
    }
    __syncthreads();
  }
}

// Vertical pass: f(o, mu) for every valid output o = r * wv + c with its
// five filtered moments mu.
template <int K, typename Fn>
__device__ void image_cols(const float* hm, const float* sw, int k, int h, int hv, int wv,
                           Fn f) {
  const int plane = h * wv;
  if constexpr (K == 0) {
    for (int o = threadIdx.x; o < hv * wv; o += kImageThreads) {
      float mu[5];
      col_moments(hm, plane, wv, o, sw, k, mu);
      f(o, mu);
    }
  } else {
    float tap[K];
#pragma unroll
    for (int j = 0; j < K; ++j) tap[j] = sw[j];
    const int runs = (hv + kRun - 1) / kRun;
    for (int it = threadIdx.x; it < runs * wv; it += kImageThreads) {
      const int c = it % wv, r0 = (it / wv) * kRun;
      float mu[kRun][5];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        float col[kRun + K - 1];
#pragma unroll
        for (int i = 0; i < kRun + K - 1; ++i)
          col[i] = hm[q * plane + min(r0 + i, h - 1) * wv + c];
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) v += tap[j] * col[i + j];
          mu[i][q] = v;
        }
      }
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        if (r0 + i < hv) f((r0 + i) * wv + c, mu[i]);
    }
  }
}

// Transposed vertical pass of the asked maps: tv[q][r][c] = sum_j g[j]
// dm[q][r - j][c] over the rows r - j of the hv x wv maps.
template <int K>
__device__ void image_cols_t(const float* dm, float* tv, const float* sw, int k, int h, int hv,
                             int wv, bool need1, bool need2) {
  const int plane = h * wv, vplane = hv * wv;
  if constexpr (K == 0) {
    for (int i = threadIdx.x; i < plane; i += kImageThreads) {
      const int r = i / wv, c = i % wv;
      const int j0 = max(0, r - hv + 1), j1 = min(k - 1, r);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((q == 0 && !need1) || (q == 1 && !need2)) continue;
        float v = 0.f;
        for (int j = j0; j <= j1; ++j) v += sw[j] * dm[q * vplane + (r - j) * wv + c];
        tv[q * plane + i] = v;
      }
    }
  } else {
    float tap[K];
#pragma unroll
    for (int j = 0; j < K; ++j) tap[j] = sw[j];
    const int runs = (h + kRun - 1) / kRun;
    for (int it = threadIdx.x; it < runs * wv; it += kImageThreads) {
      const int c = it % wv, r0 = (it / wv) * kRun;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((q == 0 && !need1) || (q == 1 && !need2)) continue;
        float col[kRun + K - 1];    // rows r0 - K + 1 .. r0 + kRun - 1, zero outside
#pragma unroll
        for (int i = 0; i < kRun + K - 1; ++i) {
          const int r = r0 - (K - 1) + i;
          col[i] = r >= 0 && r < hv ? dm[q * vplane + r * wv + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) v += tap[j] * col[i + K - 1 - j];
          if (r0 + i < h) tv[q * plane + (r0 + i) * wv + c] = v;
        }
      }
    }
  }
}

// Transposed horizontal pass, then the chain rule through the moments:
// f(i, u) for every pixel i = r * w + c with u[q] = sum_j g[j] tv[q][r][c - j].
template <int K, typename Fn>
__device__ void image_rows_t(const float* tv, const float* sw, int k, int h, int w, int wv,
                             bool need1, bool need2, Fn f) {
  const int plane = h * wv;
  if constexpr (K == 0) {
    for (int i = threadIdx.x; i < h * w; i += kImageThreads) {
      const int r = i / w, c = i % w;
      const int j0 = max(0, c - wv + 1), j1 = min(k - 1, c);
      float u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if ((q == 0 && !need1) || (q == 1 && !need2)) continue;
        const float* row = tv + q * plane + r * wv + c;
        float v = 0.f;
        for (int j = j0; j <= j1; ++j) v += sw[j] * row[-j];
        u[q] = v;
      }
      f(i, u);
    }
  } else {
    float tap[K];
#pragma unroll
    for (int j = 0; j < K; ++j) tap[j] = sw[j];
    const int runs = (w + kRun - 1) / kRun;
    for (int it = threadIdx.x; it < h * runs; it += kImageThreads) {
      const int r = it / runs, c0 = (it % runs) * kRun;
      float u[kRun][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < kRun; ++i) u[i][q] = 0.f;
        if ((q == 0 && !need1) || (q == 1 && !need2)) continue;
        float row[kRun + K - 1];    // columns c0 - K + 1 .. c0 + kRun - 1, zero outside
#pragma unroll
        for (int i = 0; i < kRun + K - 1; ++i) {
          const int c = c0 - (K - 1) + i;
          row[i] = c >= 0 && c < wv ? tv[q * plane + r * wv + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) v += tap[j] * row[i + K - 1 - j];
          u[i][q] = v;
        }
      }
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        if (c0 + i < w) f(r * w + c0 + i, u[i]);
    }
  }
}

// Dynamic shared memory: sx, sy [h * w], hm [5][h][wv].
template <int K>
__global__ void __launch_bounds__(kImageThreads)
ssim_image(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ max_val, Taps taps, int k, int h, int w, int channels,
           float k1, float k2, bool vec4, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sw[kMaxTaps];
  const int hw = h * w, hv = h - k + 1, wv = w - k + 1;
  float* sx = smem;
  float* sy = sx + hw;
  float* hm = sy + hw;
  if (threadIdx.x < k) sw[threadIdx.x] = taps.w[threadIdx.x];
  const Consts kc = consts(max_val, k1, k2);
  float acc = 0.f;
  for (int ch = 0; ch < channels; ++ch) {
    const long long img = (long long)blockIdx.x * channels + ch;
    stage_image<kImageThreads>(sx, sy, x + img * hw, y + img * hw, hw, vec4);
    image_rows<K>(sx, sy, hm, sw, k, h, w, wv);
    image_cols<K>(hm, sw, k, h, hv, wv, [&](int, const float (&mu)[5]) {
      acc += ssim_value(mu[0], mu[1], mu[2], mu[3], mu[4], kc);
    });
    __syncthreads();
  }
  const float s = block_sum<kImageThreads>(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = s / ((float)channels * (float)hv * (float)wv);
}

// Dynamic shared memory: sx, sy [h * w], hm [5][h][wv] (then the transposed
// vertical pass's [4][h][wv]), dm [4][hv][wv]. dx, dy may be null (not
// asked); part [n_out] takes each block's d max_val partial, summed into
// *dmv (if not null) by the last block.
template <int K>
__global__ void __launch_bounds__(kImageThreads)
ssim_image_bwd(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ max_val, const float* __restrict__ gs, Taps taps,
               int k, int h, int w, int channels, float k1, float k2, bool vec4,
               float* __restrict__ dx, float* __restrict__ dy, float* part, float* dmv,
               unsigned* counter) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sw[kMaxTaps];
  const int hw = h * w, hv = h - k + 1, wv = w - k + 1, plane = h * wv, vplane = hv * wv;
  float* sx = smem;
  float* sy = sx + hw;
  float* hm = sy + hw;
  float* dm = hm + 5 * plane;
  if (threadIdx.x < k) sw[threadIdx.x] = taps.w[threadIdx.x];
  const Consts kc = consts(max_val, k1, k2);
  const float scale = gs[blockIdx.x] / ((float)channels * (float)hv * (float)wv);
  const bool need1 = dx != nullptr, need2 = dy != nullptr;
  float acc = 0.f;
  for (int ch = 0; ch < channels; ++ch) {
    const long long img = (long long)blockIdx.x * channels + ch;
    stage_image<kImageThreads>(sx, sy, x + img * hw, y + img * hw, hw, vec4);
    image_rows<K>(sx, sy, hm, sw, k, h, w, wv);
    image_cols<K>(hm, sw, k, h, hv, wv, [&](int o, const float (&mu)[5]) {
      float d[4];
      acc += ssim_grads(mu[0], mu[1], mu[2], mu[3], mu[4], kc, scale, d);
#pragma unroll
      for (int q = 0; q < 4; ++q) dm[q * vplane + o] = d[q];
    });
    __syncthreads();
    if (!need1 && !need2) continue;
    float* tv = hm;     // the row moments are spent
    image_cols_t<K>(dm, tv, sw, k, h, hv, wv, need1, need2);
    __syncthreads();
    image_rows_t<K>(tv, sw, k, h, w, wv, need1, need2, [&](int i, const float (&u)[4]) {
      const float a = sx[i], b = sy[i];
      if (need1) dx[img * hw + i] = u[0] + 2.f * a * u[2] + b * u[3];
      if (need2) dy[img * hw + i] = u[1] + 2.f * b * u[2] + a * u[3];
    });
    __syncthreads();
  }
  const float s = block_sum<kImageThreads>(acc);
  if (dmv == nullptr) return;
  if (threadIdx.x == 0) part[blockIdx.x] = s;
  if (!last_arrival(counter, gridDim.x)) return;
  const float total = sum_partials<kImageThreads>(part, gridDim.x);
  if (threadIdx.x == 0) *dmv = total;
}

// ---------------------------------------------------------------------------
// tiles regime
// ---------------------------------------------------------------------------

struct Tile {
  long long img;   // folded image index
  int tile, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int tiles, int tiles_x) {
  Tile t;
  t.img = blockIdx.x / tiles;
  t.tile = blockIdx.x % tiles;
  t.y0 = (t.tile / tiles_x) * kTileH;
  t.x0 = (t.tile % tiles_x) * kTileW;
  return t;
}

// Stage the (kTileH + k - 1) x (kTileW + k - 1) patch of x and y at the
// tile (zeros past the image edge, never used by a valid output) and run
// the horizontal pass into hm [5][rows][kTileW].
__device__ void tile_row_moments(const float* __restrict__ x, const float* __restrict__ y,
                                 const Tile& tl, const float* sw, int k, int h, int w,
                                 float* sx, float* sy, float* hm) {
  const int rows = kTileH + k - 1, cols = kTileW + k - 1, plane = rows * kTileW;
  const float* xi = x + tl.img * h * w;
  const float* yi = y + tl.img * h * w;
  for (int i = threadIdx.x; i < rows * cols; i += kTileThreads) {
    const int r = i / cols, c = i % cols;
    const int gy = tl.y0 + r, gx = tl.x0 + c;
    const bool in = gy < h && gx < w;
    sx[i] = in ? xi[(long long)gy * w + gx] : 0.f;
    sy[i] = in ? yi[(long long)gy * w + gx] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < plane; i += kTileThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const float* px = sx + r * cols + c;
    const float* py = sy + r * cols + c;
    float m1 = 0.f, m2 = 0.f, m11 = 0.f, m22 = 0.f, m12 = 0.f;
    for (int j = 0; j < k; ++j) {
      const float g = sw[j], a = px[j], b = py[j];
      m1 += g * a;
      m2 += g * b;
      m11 += g * (a * a);
      m22 += g * (b * b);
      m12 += g * (a * b);
    }
    hm[i] = m1;
    hm[plane + i] = m2;
    hm[2 * plane + i] = m11;
    hm[3 * plane + i] = m22;
    hm[4 * plane + i] = m12;
  }
  __syncthreads();
}

// Dynamic shared memory: sx, sy [rows * cols], hm [5][rows][kTileW]. One
// float32 partial per (image, tile); the last tile of an output to arrive
// writes out[n] = its channels' partials summed in order / count.
__global__ void __launch_bounds__(kTileThreads)
ssim_tiles(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ max_val, Taps taps, int k, int h, int w, int channels,
           int tiles_x, int tiles, float k1, float k2, float* partial, unsigned* counters,
           float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sw[kMaxTaps];
  const int rows = kTileH + k - 1, cols = kTileW + k - 1, plane = rows * kTileW;
  float* sx = smem;
  float* sy = sx + rows * cols;
  float* hm = sy + rows * cols;
  const Tile tl = tile_of(tiles, tiles_x);
  const int hv = h - k + 1, wv = w - k + 1;
  if (threadIdx.x < k) sw[threadIdx.x] = taps.w[threadIdx.x];
  __syncthreads();
  tile_row_moments(x, y, tl, sw, k, h, w, sx, sy, hm);
  const Consts kc = consts(max_val, k1, k2);
  float acc = 0.f;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kTileThreads) {
    const int r = i / kTileW, c = i % kTileW;
    if (tl.y0 + r >= hv || tl.x0 + c >= wv) continue;
    float mu[5];
    col_moments(hm, plane, kTileW, i, sw, k, mu);
    acc += ssim_value(mu[0], mu[1], mu[2], mu[3], mu[4], kc);
  }
  const float s = block_sum<kTileThreads>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
  const long long n = tl.img / channels;
  const int per_out = channels * tiles;
  if (!last_arrival(counters + n, (unsigned)per_out)) return;
  const float total = sum_partials<kTileThreads>(partial + n * per_out, per_out);
  if (threadIdx.x == 0) out[n] = total / ((float)channels * (float)hv * (float)wv);
}

// Backward launch 1: the tile's derivative maps into maps [img][4][hv][wv],
// its d max_val partial into part[blockIdx.x], summed into *dmv (if not
// null) by the last block of the grid.
__global__ void __launch_bounds__(kTileThreads)
ssim_tiles_bwd(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ max_val, const float* __restrict__ gs, Taps taps,
               int k, int h, int w, int channels, int tiles_x, int tiles, float k1, float k2,
               float* __restrict__ maps, float* part, float* dmv, unsigned* counter) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sw[kMaxTaps];
  const int rows = kTileH + k - 1, cols = kTileW + k - 1, plane = rows * kTileW;
  float* sx = smem;
  float* sy = sx + rows * cols;
  float* hm = sy + rows * cols;
  const Tile tl = tile_of(tiles, tiles_x);
  const int hv = h - k + 1, wv = w - k + 1;
  const long long vplane = (long long)hv * wv;
  if (threadIdx.x < k) sw[threadIdx.x] = taps.w[threadIdx.x];
  __syncthreads();
  tile_row_moments(x, y, tl, sw, k, h, w, sx, sy, hm);
  const Consts kc = consts(max_val, k1, k2);
  const float scale = gs[tl.img / channels] / ((float)channels * (float)hv * (float)wv);
  float* mi = maps + tl.img * 4 * vplane;
  float acc = 0.f;
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kTileThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int oy = tl.y0 + r, ox = tl.x0 + c;
    if (oy >= hv || ox >= wv) continue;
    float mu[5], d[4];
    col_moments(hm, plane, kTileW, i, sw, k, mu);
    acc += ssim_grads(mu[0], mu[1], mu[2], mu[3], mu[4], kc, scale, d);
#pragma unroll
    for (int q = 0; q < 4; ++q) mi[q * vplane + (long long)oy * wv + ox] = d[q];
  }
  const float s = block_sum<kTileThreads>(acc);
  if (dmv == nullptr) return;
  if (threadIdx.x == 0) part[blockIdx.x] = s;
  if (!last_arrival(counter, gridDim.x)) return;
  const float total = sum_partials<kTileThreads>(part, gridDim.x);
  if (threadIdx.x == 0) *dmv = total;
}

// Backward launch 2: over kTileH x kTileW pixel tiles (grid n_img *
// ptiles), each needed map is staged with its halo of k - 1 rows and
// columns above and left (zeros outside the hv x wv map, which makes the
// window bounds of F^T implicit), filtered back, vertical then horizontal,
// and chained into d x and d y. Dynamic shared memory: st [rows][cols],
// tv [kTileH][cols].
__global__ void __launch_bounds__(kTileThreads)
ssim_pixels_bwd(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ maps, Taps taps, int k, int h, int w,
                int ptiles_x, int ptiles, float* __restrict__ dx, float* __restrict__ dy) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sw[kMaxTaps];
  constexpr int kPix = kTileH * kTileW / kTileThreads;   // pixels a thread
  const int rows = kTileH + k - 1, cols = kTileW + k - 1;
  float* st = smem;
  float* tv = st + rows * cols;
  const Tile tl = tile_of(ptiles, ptiles_x);
  const int hv = h - k + 1, wv = w - k + 1;
  const long long vplane = (long long)hv * wv;
  const float* mi = maps + tl.img * 4 * vplane;
  const bool need1 = dx != nullptr, need2 = dy != nullptr;
  if (threadIdx.x < k) sw[threadIdx.x] = taps.w[threadIdx.x];
  float d1[kPix], d2[kPix], a[kPix], b[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int i = threadIdx.x + p * kTileThreads;
    const int gy = tl.y0 + i / kTileW, gx = tl.x0 + i % kTileW;
    const bool in = gy < h && gx < w;
    const long long o = tl.img * h * w + (long long)gy * w + gx;
    a[p] = in ? x[o] : 0.f;
    b[p] = in ? y[o] : 0.f;
    d1[p] = d2[p] = 0.f;
  }
  for (int q = 0; q < 4; ++q) {
    if ((q == 0 && !need1) || (q == 1 && !need2)) continue;
    __syncthreads();     // the previous map's passes are done with st and tv
    for (int i = threadIdx.x; i < rows * cols; i += kTileThreads) {
      const int r = tl.y0 - (k - 1) + i / cols, c = tl.x0 - (k - 1) + i % cols;
      st[i] = (r >= 0 && r < hv && c >= 0 && c < wv) ? mi[q * vplane + (long long)r * wv + c]
                                                     : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTileH * cols; i += kTileThreads) {
      const int r = i / cols, c = i % cols;
      float v = 0.f;
      for (int j = 0; j < k; ++j) v += sw[j] * st[(r + k - 1 - j) * cols + c];
      tv[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int i = threadIdx.x + p * kTileThreads;
      const int r = i / kTileW, c = i % kTileW;
      const float* row = tv + r * cols + c + k - 1;
      float u = 0.f;
      for (int j = 0; j < k; ++j) u += sw[j] * row[-j];
      if (q == 0) d1[p] += u;
      else if (q == 1) d2[p] += u;
      else if (q == 2) {
        d1[p] += 2.f * a[p] * u;
        d2[p] += 2.f * b[p] * u;
      } else {
        d1[p] += b[p] * u;
        d2[p] += a[p] * u;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int i = threadIdx.x + p * kTileThreads;
    const int gy = tl.y0 + i / kTileW, gx = tl.x0 + i % kTileW;
    if (gy >= h || gx >= w) continue;
    const long long o = tl.img * h * w + (long long)gy * w + gx;
    if (need1) dx[o] = d1[p];
    if (need2) dy[o] = d2[p];
  }
}

// kernels this library has launched, for callers that check a plan's count
long long g_launched = 0;

cudaError_t launched(cudaError_t err) {
  if (err == cudaSuccess) ++g_launched;
  return err;
}

Taps load_taps(const float* taps_host, int k) {
  Taps taps;
  for (int i = 0; i < kMaxTaps; ++i) taps.w[i] = i < k ? taps_host[i] : 0.f;
  return taps;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t image_smem(int h, int w, int k, bool backward) {
  const size_t hv = h - k + 1, wv = w - k + 1;
  return sizeof(float) * (2 * (size_t)h * w + 5 * (size_t)h * wv + (backward ? 4 * hv * wv : 0));
}

bool check_shape(int k, long long n_out, int channels, int h, int w) {
  return k >= 1 && k <= kMaxTaps && h >= k && w >= k && n_out >= 1 && channels >= 1 &&
         n_out * channels <= 0x7fffffffLL;
}

}  // namespace

// Forward. x, y [n_out * channels, h, w] float32 on the device; max_val a
// device float; taps k float32 values in host memory (k <= kMaxTaps); regime
// 0 image (smem = image_smem, vec4: h*w % 4 == 0 and 16-byte aligned
// images), 1 tiles (partial [n_out * channels * tiles] scratch, counters
// n_out zeroed unsigned ints); out [n_out]. Returns the cudaError_t of the
// launch (0 on success); launches on `stream`, does not synchronise,
// allocates nothing.
extern "C" int dl4ds_ssim(const float* x, const float* y, const float* max_val,
                          const float* taps_host, int k, long long n_out, int channels, int h,
                          int w, int regime, int vec4, float k1, float k2, float* partial,
                          unsigned* counters, float* out, void* stream) {
  if (!check_shape(k, n_out, channels, h, w)) return (int)cudaErrorInvalidValue;
  const Taps taps = load_taps(taps_host, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regime == 0) {
    const size_t smem = image_smem(h, w, k, false);
    auto kernel = k == kFixedTaps ? ssim_image<kFixedTaps> : ssim_image<0>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)n_out, kImageThreads, smem, s>>>(x, y, max_val, taps, k, h, w, channels,
                                                        k1, k2, vec4 != 0, out);
    return (int)launched(cudaGetLastError());
  }
  if (regime != 1) return (int)cudaErrorInvalidValue;
  const int tiles_x = (w - k + 1 + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((h - k + 1 + kTileH - 1) / kTileH);
  const long long blocks = n_out * channels * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int rows = kTileH + k - 1, cols = kTileW + k - 1;
  const size_t smem = sizeof(float) * (size_t)(2 * rows * cols + 5 * rows * kTileW);
  ssim_tiles<<<(unsigned)blocks, kTileThreads, smem, s>>>(
      x, y, max_val, taps, k, h, w, channels, tiles_x, tiles, k1, k2, partial, counters, out);
  return (int)launched(cudaGetLastError());
}

// Backward. gs [n_out] the upstream gradient; dx, dy [n_out * channels, h,
// w] or null where not asked; dmv a device float or null; part: regime 0
// [n_out], regime 1 [n_out * channels * tiles] float32 scratch; maps
// (regime 1) [n_out * channels, 4, hv, wv] float32 scratch; counter one
// zeroed unsigned int. Regime 1 makes two launches (the second only when
// dx or dy is asked).
extern "C" int dl4ds_ssim_bwd(const float* x, const float* y, const float* max_val,
                              const float* gs, const float* taps_host, int k, long long n_out,
                              int channels, int h, int w, int regime, int vec4, float k1,
                              float k2, float* dx, float* dy, float* dmv, float* part,
                              float* maps, unsigned* counter, void* stream) {
  if (!check_shape(k, n_out, channels, h, w)) return (int)cudaErrorInvalidValue;
  const Taps taps = load_taps(taps_host, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regime == 0) {
    const size_t smem = image_smem(h, w, k, true);
    auto kernel = k == kFixedTaps ? ssim_image_bwd<kFixedTaps> : ssim_image_bwd<0>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)n_out, kImageThreads, smem, s>>>(x, y, max_val, gs, taps, k, h, w,
                                                        channels, k1, k2, vec4 != 0, dx, dy,
                                                        part, dmv, counter);
    return (int)launched(cudaGetLastError());
  }
  if (regime != 1) return (int)cudaErrorInvalidValue;
  const int tiles_x = (w - k + 1 + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((h - k + 1 + kTileH - 1) / kTileH);
  const long long n_img = n_out * channels;
  if (n_img * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int rows = kTileH + k - 1, cols = kTileW + k - 1;
  const size_t smem = sizeof(float) * (size_t)(2 * rows * cols + 5 * rows * kTileW);
  ssim_tiles_bwd<<<(unsigned)(n_img * tiles), kTileThreads, smem, s>>>(
      x, y, max_val, gs, taps, k, h, w, channels, tiles_x, tiles, k1, k2, maps, part, dmv,
      counter);
  cudaError_t err = launched(cudaGetLastError());
  if (err != cudaSuccess || (dx == nullptr && dy == nullptr)) return (int)err;
  const int ptiles_x = (w + kTileW - 1) / kTileW;
  const int ptiles = ptiles_x * ((h + kTileH - 1) / kTileH);
  if (n_img * ptiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t psmem = sizeof(float) * (size_t)((rows + kTileH) * cols);
  ssim_pixels_bwd<<<(unsigned)(n_img * ptiles), kTileThreads, psmem, s>>>(
      x, y, maps, taps, k, h, w, ptiles_x, ptiles, dx, dy);
  return (int)launched(cudaGetLastError());
}

// The number of kernels this library has launched since it was loaded.
extern "C" long long dl4ds_ssim_launched() { return g_launched; }

// The dynamic shared memory a block may opt into on `device`, less
// kStaticSmemReserve: the limit `_ssim_plan` takes.
extern "C" int dl4ds_ssim_limits(int device, int* smem_optin) {
  const cudaError_t err =
      cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  *smem_optin -= kStaticSmemReserve;
  return 0;
}

// Fused per-image SSIM (K6) for NVIDIA Hopper (sm_90a).
//
// For each single-channel image pair (x, y) of [N, H, W] float32, with the
// K-tap Gaussian g and VALID filtering (Hv = H - K + 1, Wv = W - K + 1):
//   mu_x, mu_y, E[x^2], E[y^2], E[xy]  = g (x) g applied to x, y, x^2, y^2, xy
//   lum = (2 mu_x mu_y + c1) / (mu_x^2 + mu_y^2 + c1)
//   cs  = (2 (E[xy] - mu_x mu_y) + c2) / (E[x^2] - mu_x^2 + E[y^2] - mu_y^2 + c2)
//   ssim = mean over the Hv x Wv positions of lum * cs,
// with c1 = (k1 max_val)^2 and c2 = (k2 max_val)^2 formed here from max_val,
// which is read from device memory (the loss passes the data range of its
// inputs as a device scalar, so no host read is needed). Every sum is
// float32; the taps are the float32 taps of the host's Gaussian.
//
// Replaces: dl4ds_tpu/ops/pallas_ops.py `_ssim_forward` -> `_ssim_kernel`
// (a grid step per 8 images, each image's five moments filtered by two
// dense band matmuls on the MXU, [Hv, H] @ [H, W] @ [W, Wv]).
//
// Bound: the kernel is launch- and latency-bound at the loss's shape. At
// [128, 64, 64] and 11 taps the separable filters need (64*54 + 54*54) * 11
// * 5 = 350,460 multiply-adds an image, 89.7 MFLOP for the batch (1.34 us
// at 67 TFLOP/s of float32) against 4.19 MB read (1.25 us at 3.35 TB/s).
//
// Design: the TPU's 54x64 band matrices are 83% zeros and exist only to feed
// the MXU; here the filters are direct. Each block takes one image and a
// tile of kTileH x kTileW output positions:
//   1. stage the (kTileH + K - 1) x (kTileW + K - 1) input patch of x and y
//      in shared memory (zeros past the image edge, never used by a valid
//      output);
//   2. horizontal pass: the five row-filtered moments of every staged row
//      for the tile's kTileW columns, into shared memory;
//   3. vertical pass: each thread filters its output positions' five
//      moments down the columns, runs the SSIM algebra and sums lum * cs;
//   4. a fixed-order block reduction writes one float32 partial per (image,
//      tile).
// A second launch sums each output's partials in a fixed order (its C
// channels' tiles, for inputs folded from [..., H, W, C]) and divides by
// C * Hv * Wv. No atomics: the bits repeat from run to run. Tiling rows and
// columns keeps shared memory under 48 KB for any H, W >= K, for K up to
// kMaxTaps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 25;   // compiled maximum filter size
constexpr int kTileH = 16;     // output rows a block
constexpr int kTileW = 32;     // output columns a block
constexpr int kThreads = 256;

struct Taps {
  float w[kMaxTaps];
};

// Dynamic shared memory: sx, sy [rows * cols], then the five row-filtered
// moments [5][rows * kTileW], rows = kTileH + k - 1, cols = kTileW + k - 1.
__global__ void __launch_bounds__(kThreads)
ssim_tiles(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ max_val, Taps taps, int k, int h, int w,
           int tiles_x, int tiles, float k1, float k2,
           float* __restrict__ partial) {
  extern __shared__ float smem[];
  __shared__ float sw[kMaxTaps];
  __shared__ float warp_sums[kThreads / 32];
  const int rows = kTileH + k - 1;
  const int cols = kTileW + k - 1;
  float* sx = smem;
  float* sy = sx + rows * cols;
  float* hm = sy + rows * cols;           // [5][rows][kTileW]
  const int plane = rows * kTileW;

  const int64_t img = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int y0 = (tile / tiles_x) * kTileH;
  const int x0 = (tile % tiles_x) * kTileW;
  const int hv = h - k + 1;
  const int wv = w - k + 1;
  const int t = threadIdx.x;

  if (t < k) sw[t] = taps.w[t];
  const float* xi = x + img * h * w;
  const float* yi = y + img * h * w;
  for (int i = t; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    const int gy = y0 + r, gx = x0 + c;
    const bool in = gy < h && gx < w;
    sx[i] = in ? xi[(int64_t)gy * w + gx] : 0.f;
    sy[i] = in ? yi[(int64_t)gy * w + gx] : 0.f;
  }
  __syncthreads();

  for (int i = t; i < plane; i += kThreads) {
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

  const float a1 = k1 * *max_val, a2 = k2 * *max_val;
  const float c1 = a1 * a1, c2 = a2 * a2;
  float acc = 0.f;
  for (int i = t; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    if (y0 + r >= hv || x0 + c >= wv) continue;
    float mu1 = 0.f, mu2 = 0.f, mu11 = 0.f, mu22 = 0.f, mu12 = 0.f;
    for (int j = 0; j < k; ++j) {
      const int o = (r + j) * kTileW + c;
      const float g = sw[j];
      mu1 += g * hm[o];
      mu2 += g * hm[plane + o];
      mu11 += g * hm[2 * plane + o];
      mu22 += g * hm[3 * plane + o];
      mu12 += g * hm[4 * plane + o];
    }
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
    const float lum = (2.f * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1);
    const float cs = (2.f * (mu12 - mu1_mu2) + c2) /
                     ((mu11 - mu1_sq) + (mu22 - mu2_sq) + c2);
    acc += lum * cs;
  }

  // fixed-order block sum: butterfly within each warp, then warp 0 over the
  // warps' sums in order
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((t & 31) == 0) warp_sums[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) s += warp_sums[i];
    partial[img * tiles + tile] = s;
  }
}

// out[i] = sum of partial[i * per_out .. (i + 1) * per_out) / count.
__global__ void __launch_bounds__(kThreads)
ssim_finish(const float* __restrict__ partial, float* __restrict__ out,
            int64_t n_out, int per_out, float count) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const float* p = partial + i * per_out;
  float s = 0.f;
  for (int j = 0; j < per_out; ++j) s += p[j];
  out[i] = s / count;
}

}  // namespace

// x, y [n_out * channels, h, w] float32 on the device; max_val a device
// float; taps k float32 values in host memory (k <= kMaxTaps); partial
// [n_out * channels, tiles] float32 scratch and out [n_out] from the caller,
// who counts the tiles with the same tile sizes (checked here). Returns the
// cudaError_t of the launches (0 on success); launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int dl4ds_ssim(const float* x, const float* y, const float* max_val,
                          const float* taps_host, int k, long long n_out,
                          int channels, int h, int w, int tiles, float k1,
                          float k2, float* partial, float* out, void* stream) {
  if (k < 1 || k > kMaxTaps || h < k || w < k || n_out < 1 || channels < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_y = (h - k + 1 + kTileH - 1) / kTileH;
  const int tiles_x = (w - k + 1 + kTileW - 1) / kTileW;
  if (tiles != tiles_y * tiles_x) return (int)cudaErrorInvalidValue;
  const long long blocks = n_out * channels * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < kMaxTaps; ++i) taps.w[i] = i < k ? taps_host[i] : 0.f;
  const int rows = kTileH + k - 1;
  const int cols = kTileW + k - 1;
  const size_t shmem = sizeof(float) * (size_t)(2 * rows * cols + 5 * rows * kTileW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssim_tiles<<<(unsigned)blocks, kThreads, shmem, s>>>(
      x, y, max_val, taps, k, h, w, tiles_x, tiles, k1, k2, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long finish_blocks = (n_out + kThreads - 1) / kThreads;
  const float count = (float)channels * (float)(h - k + 1) * (float)(w - k + 1);
  ssim_finish<<<(unsigned)finish_blocks, kThreads, 0, s>>>(
      partial, out, n_out, channels * tiles, count);
  return (int)cudaGetLastError();
}

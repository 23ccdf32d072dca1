// Fused ConvLSTM layer forward (K2) for NVIDIA Hopper (sm_90a), in its
// inference variant (ys only) and its training variant (ys plus the cs and
// zs residuals that the BPTT backward K3, csrc/convlstm_bwd.cu, reads).
//
//   z   = conv_same(x_t, wx) + bx + conv_same(h_{t-1}, wh)     gates i, f, c, o
//   c_t = hs(z_f) * c_{t-1} + hs(z_i) * tanh(z_c)
//   h_t = hs(z_o) * tanh(c_t)             ys[:, t] = h_t,  h_{-1} = c_{-1} = 0
//
// with hs the Keras hard sigmoid clip(0.2 z + 0.5, 0, 1). x is
// [B, T, H, W, Cin] and ys [B, T, H, W, F], float32, NHWC per frame; wx
// [kh, kw, Cin, 4F] and wh [kh, kw, F, 4F] are HWIO with the gates split
// along 4F; bx [4F]. Odd kh, kw (symmetric SAME padding). All arithmetic is
// float32 FMA, no TF32 and no fast-math intrinsics; the gate products and
// sums are rounded one by one (__fmul_rn, __fadd_rn) as PyTorch's
// elementwise ops round them.
//
// Replaces: dl4ds_tpu/ops/pallas_convlstm.py `_forward_pallas` ->
// `_fwd_kernel` (one grid step per batch tile holding h and c in VMEM for
// the whole window, the convs as banded matmuls over 128-lane rows), in its
// inference variant that emits ys only.
//
// Bound: operations. Each output (b, t, y, x, f) needs kh*kw*Cin FMAs per
// gate for the input conv and, from t = 1 on (h_{-1} = 0), kh*kw*F more for
// the recurrent one: 2*B*H*W*kh*kw*4F*(T*Cin + (T-1)*F) flops against about
// 4*B*T*H*W*(Cin+F) bytes in and out. For the recresnet_spc x4 model
// (BASELINE config 4, F = 8, 128x128 LR, T = 4) the six layers of one
// batch-8 forward do 42.9 GFLOP and move about 0.2 GB: 0.64 ms at
// 67 TFLOP/s of float32 outside the tensor cores against 0.06 ms at
// 3.35 TB/s, so arithmetic bounds it by 11x.
//
// Design: a sample's h at 128x128x8 (512 KB) is larger than an SM's 227 KB of
// shared memory, and each step reads an h halo that crosses any spatial
// tile, so every step needs all of h_{t-1} before any block reads it. The
// layer is therefore T launches of one step kernel on the caller's stream.
// A block computes one spatial tile (8*PY rows x 32 columns) of one sample
// for a group of 8 output channels (the last group of an F that is not a
// multiple of 8 is padded with zero weights and not written) and all four
// gates:
//   - each thread owns PY pixels of one column (rows ty, ty + 8, ...) and
//     holds PY*4*8 accumulators, so each weight it loads feeds PY pixels
//     and each input value feeds 32 FMAs;
//   - the block walks its sources (x_t with Cin channels, then h_{t-1} with
//     F channels read from ys[:, t-1], skipped at t = 0) in chunks of 8
//     input channels. For each chunk it stages the input tile with its halo
//     in shared memory as [channel][row][column], so a warp (one row) reads
//     32 consecutive words, and the chunk's weights as [tap][channel][gate]
//     [8], so a thread reads its 32 weights of one input value as float4
//     broadcasts. The stage is about 48 KB at 5x5, so two blocks share an
//     SM, and it does not grow with Cin or F: every width runs this path;
//   - c lives in a float32 [B, H, W, F] scratch the caller allocates, read
//     and written by the thread that owns the pixel. The training variant
//     (TRAIN, a zs output given) reads c_{t-1} from cs[:, t-1] and writes
//     c_t to cs[:, t] instead, and writes the accumulators, z with the bias
//     and the recurrent term, to zs[:, t] before the gates. It is a template
//     flag, not a runtime branch: a uniform branch in the epilogue cost the
//     inference variant 1.5% (chip_smoke.py, parent and change in turns on
//     one H100 SXM at 700 W);
//   - 3x3 and 5x5 are compiled with the kernel size known, which folds the
//     tile geometry into constants (about 4% at the (8, 8, 5x5) layer
//     against the generic body, by chip_smoke.py on an H100 SXM at 700 W);
//     any other odd size runs the generic body. With PY in {1, 2} that
//     makes six instantiations of each variant.
// Per input value and tap a thread issues PY shared loads of x or h, 8
// float4 weight loads and PY*32 FMAs (64 at PY = 2). A later PR would keep
// h and c on chip across steps (a cluster or a persistent grid with a
// barrier between steps), overlap the next chunk's staging with the FMAs,
// and take the recurrence's FMAs to 3xTF32 mma tiles, which keep float32
// accuracy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;                // columns of a tile, one per lane
constexpr int kTY = 8;                 // warps of a block, one row each
constexpr int kThreads = kTX * kTY;
constexpr int kCC = 8;                 // input channels staged per pass
constexpr int kFG = 8;                 // output channels of a block
constexpr int kMaxSmem = 227 * 1024;
static_assert(4 * kFG == kTX, "weight staging gives each lane one (gate, channel)");

__device__ __forceinline__ float hard_sigmoid(float z) {
  return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, z), 0.5f), 0.f), 1.f);
}

constexpr int smem_floats(int py, int kh, int kw) {
  return kCC * (kTY * py + kh - 1) * (kTX + kw - 1) + kh * kw * kCC * 4 * kFG;
}

// One time step. Grid: (spatial tiles, ceil(F / 8) channel groups, B). K is
// the kernel size when it is 3 or 5 (the tile geometry is then known at
// compile time), 0 for any other odd kh x kw. TRAIN: the training variant.
template <int PY, int K, bool TRAIN>
__global__ void __launch_bounds__(kThreads, 2)
convlstm_step(const float* __restrict__ x, const float* __restrict__ wx,
              const float* __restrict__ bx, const float* __restrict__ wh,
              float* __restrict__ ys, float* __restrict__ cst,
              float* __restrict__ zs, int t_steps,
              int step, int h, int wd, int cin, int f, int kh_, int kw_,
              int tiles_x) {
  constexpr int TH = kTY * PY;
  const int kh = K ? K : kh_;
  const int kw = K ? K : kw_;
  const int rows = TH + kh - 1;
  const int rw = kTX + kw - 1;
  const int plane = rows * rw;
  extern __shared__ float4 smem4[];
  float* in_s = reinterpret_cast<float*>(smem4);
  float* w_s = in_s + kCC * plane;   // 16-byte aligned: kCC is 8
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * kTX;
  const int f0 = blockIdx.y * kFG;
  const int nf = min(kFG, f - f0);   // channels of this group that exist
  const int b = blockIdx.z;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int ph = kh / 2, pw = kw / 2;
  const int64_t hw = (int64_t)h * wd;
  const int64_t frame = (int64_t)b * t_steps + step;

  float acc[PY][4][kFG];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < kFG; ++j) {
      const float bias = j < nf ? __ldg(bx + g * f + f0 + j) : 0.f;
#pragma unroll
      for (int p = 0; p < PY; ++p) acc[p][g][j] = bias;
    }

  const int n_src = step == 0 ? 1 : 2;
  for (int s = 0; s < n_src; ++s) {
    const float* src = s == 0 ? x + frame * hw * cin : ys + (frame - 1) * hw * f;
    const float* w = s == 0 ? wx : wh;
    const int c = s == 0 ? cin : f;
    const bool vec = c % 4 == 0;   // then cc is 4 or 8 and rows are aligned
    for (int c0 = 0; c0 < c; c0 += kCC) {
      const int cc = min(kCC, c - c0);
      __syncthreads();  // the previous chunk is no longer read
      // input tile with halo, [channel][row][column]; a lane per column
      for (int r = ty; r < rows; r += kTY) {
        const int yy = y0 - ph + r;
        for (int q = tx; q < rw; q += kTX) {
          const int xx = x0 - pw + q;
          float* dst = in_s + r * rw + q;
          if (yy >= 0 && yy < h && xx >= 0 && xx < wd) {
            const float* sp = src + ((int64_t)yy * wd + xx) * c + c0;
            if (vec) {
              for (int ci = 0; ci < cc; ci += 4) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(sp + ci));
                dst[ci * plane] = v.x;
                dst[(ci + 1) * plane] = v.y;
                dst[(ci + 2) * plane] = v.z;
                dst[(ci + 3) * plane] = v.w;
              }
            } else {
              for (int ci = 0; ci < cc; ++ci) dst[ci * plane] = __ldg(sp + ci);
            }
          } else {
            for (int ci = 0; ci < cc; ++ci) dst[ci * plane] = 0.f;
          }
        }
      }
      // this chunk's weights, [tap][channel][gate][8]; a lane per (g, j),
      // zero for the channels past F
      for (int row = ty; row < kh * kw * cc; row += kTY) {
        const int tap = row / cc;
        const int ci = row - tap * cc;
        const float* wr = w + ((int64_t)tap * c + c0 + ci) * 4 * f + f0;
        float* dst = w_s + (tap * kCC + ci) * 4 * kFG;
        const int g = tx / kFG, j = tx % kFG;   // 4 * kFG == kTX lanes
        dst[tx] = j < nf ? __ldg(wr + g * f + j) : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int dy = 0; dy < kh; ++dy) {
#pragma unroll 1
        for (int dx = 0; dx < kw; ++dx) {
          const float* ip = in_s + (ty + dy) * rw + tx + dx;
          const float* wp = w_s + (dy * kw + dx) * kCC * 4 * kFG;
#pragma unroll
          for (int ci = 0; ci < kCC; ++ci) {
            if (ci >= cc) break;
            float v[PY];
#pragma unroll
            for (int p = 0; p < PY; ++p) v[p] = ip[ci * plane + kTY * p * rw];
            const float* wc = wp + ci * 4 * kFG;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
#pragma unroll
              for (int j = 0; j < kFG; j += 4) {
                const float4 q = *reinterpret_cast<const float4*>(wc + g * kFG + j);
#pragma unroll
                for (int p = 0; p < PY; ++p) {
                  acc[p][g][j] = fmaf(v[p], q.x, acc[p][g][j]);
                  acc[p][g][j + 1] = fmaf(v[p], q.y, acc[p][g][j + 1]);
                  acc[p][g][j + 2] = fmaf(v[p], q.z, acc[p][g][j + 2]);
                  acc[p][g][j + 3] = fmaf(v[p], q.w, acc[p][g][j + 3]);
                }
              }
            }
          }
        }
      }
    }
  }

  const int xq = x0 + tx;
#pragma unroll
  for (int p = 0; p < PY; ++p) {
    const int y = y0 + ty + kTY * p;
    if (y >= h || xq >= wd) continue;
    const int64_t pix = (int64_t)y * wd + xq;
    // inference: c in the [B, H, W, F] scratch; training: c_t in cs[:, t]
    // and c_{t-1} in cs[:, t-1], z in zs[:, t]
    float* cp = TRAIN ? cst + (frame * hw + pix) * f + f0
                      : cst + ((int64_t)b * hw + pix) * f + f0;
    const float* cprev = TRAIN && step > 0 ? cp - hw * f : cp;
    float* yp = ys + (frame * hw + pix) * f + f0;
    if (TRAIN) {
      float* zp = zs + (frame * hw + pix) * 4 * f + f0;
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < kFG; ++j)
          if (j < nf) zp[g * f + j] = acc[p][g][j];
    }
#pragma unroll
    for (int j = 0; j < kFG; ++j) {
      if (j >= nf) break;
      const float c_prev = step == 0 ? 0.f : cprev[j];
      const float c_new =
          __fadd_rn(__fmul_rn(hard_sigmoid(acc[p][1][j]), c_prev),
                    __fmul_rn(hard_sigmoid(acc[p][0][j]), tanhf(acc[p][2][j])));
      cp[j] = c_new;
      yp[j] = __fmul_rn(hard_sigmoid(acc[p][3][j]), tanhf(c_new));
    }
  }
}

template <int PY, int K>
cudaError_t launch(const float* x, const float* wx, const float* bx, const float* wh,
                   float* ys, float* c, float* zs, int b, int t_steps, int step, int h,
                   int wd, int cin, int f, int kh, int kw, cudaStream_t stream) {
  auto kern = zs ? convlstm_step<PY, K, true> : convlstm_step<PY, K, false>;
  const int shmem = (int)sizeof(float) * smem_floats(PY, kh, kw);
  if (shmem > kMaxSmem) return cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    if (err != cudaSuccess) return err;
  }
  const int tiles_x = (wd + kTX - 1) / kTX;
  const int tiles_y = (h + kTY * PY - 1) / (kTY * PY);
  const dim3 grid(tiles_x * tiles_y, (f + kFG - 1) / kFG, b);
  kern<<<grid, kThreads, shmem, stream>>>(x, wx, bx, wh, ys, c, zs, t_steps, step, h,
                                          wd, cin, f, kh, kw, tiles_x);
  return cudaGetLastError();
}

template <int PY>
cudaError_t launch_k(const float* x, const float* wx, const float* bx, const float* wh,
                     float* ys, float* c, float* zs, int b, int t_steps, int step, int h,
                     int wd, int cin, int f, int kh, int kw, cudaStream_t s) {
  if (kh == 5 && kw == 5)
    return launch<PY, 5>(x, wx, bx, wh, ys, c, zs, b, t_steps, step, h, wd, cin, f, kh,
                         kw, s);
  if (kh == 3 && kw == 3)
    return launch<PY, 3>(x, wx, bx, wh, ys, c, zs, b, t_steps, step, h, wd, cin, f, kh,
                         kw, s);
  return launch<PY, 0>(x, wx, bx, wh, ys, c, zs, b, t_steps, step, h, wd, cin, f, kh, kw,
                       s);
}

}  // namespace

// One time step `step` of the layer. py (1 or 2) is the number of rows a
// thread computes. ys [B, T, H, W, F] is the caller's. With zs NULL
// (inference) c is a [B, H, W, F] scratch; with zs [B, T, H, W, 4F]
// (training) c is the cs residual [B, T, H, W, F]. Steps must run in order
// on one stream. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a shape the kernel does not take); does not
// synchronise.
extern "C" int dl4ds_convlstm_step(const float* x, const float* wx, const float* bx,
                                   const float* wh, float* ys, float* c, float* zs,
                                   int b, int t_steps, int step, int h, int wd,
                                   int cin, int f, int kh, int kw, int py,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (py == 2)
    err = launch_k<2>(x, wx, bx, wh, ys, c, zs, b, t_steps, step, h, wd, cin, f, kh, kw,
                      s);
  else if (py == 1)
    err = launch_k<1>(x, wx, bx, wh, ys, c, zs, b, t_steps, step, h, wd, cin, f, kh, kw,
                      s);
  return (int)err;
}

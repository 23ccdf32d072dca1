// ConvLSTM sequential BPTT chain (K4) for NVIDIA Hopper (sm_90a): the dh/dc
// chain of the backward alone, writing dz for every step. The T-parallel
// rest of the backward (dx, dWx, dWh, db) is float32 GEMMs outside any kernel
// (`convlstm_backward_tail` in ops/convlstm.py).
//
// From the residuals of the forward's training variant (csrc/convlstm.cu: zs,
// the pre-activations z = (z_i, z_f, z_c, z_o) of every step; cs) and dys,
// the gradient of ys, with hs the Keras hard sigmoid and hs' its derivative
// (0.2 where hs lies strictly between 0 and 1, else 0; `_d_hard_sigmoid`):
//   dh_t  = dys_t + convT(dz_{t+1}, wh)       (no recurrent term at t = T-1)
//   do    = dh_t tanh(c_t)
//   dc_t  = dh_t hs(z_o) (1 - tanh(c_t)^2) + dc_{t+1} hs(z_f,t+1)
//   dz_i  = dc_t tanh(z_c) hs'(z_i)          dz_f = dc_t c_{t-1} hs'(z_f)
//   dz_c  = dc_t hs(z_i) (1 - tanh(z_c)^2)   dz_o = do hs'(z_o)   (c_{-1} = 0)
// convT(dz, wh)[p, o] = sum_{dy, dx, s} dz[p + (dy - ph, dx - pw), s]
// whT[dy, dx, s, o], with whT[dy, dx, s, o] = wh[kh-1-dy, kw-1-dx, o, s]: the
// wrapper flips and transposes the recurrent kernel once a layer. Layouts as
// in csrc/convlstm.cu: [B, T, H, W, C] activations, gates i, f, c, o along
// 4F. All arithmetic is float32 FMA, no TF32; the gate algebra rounds product
// by product (__fmul_rn, __fadd_rn) as PyTorch's elementwise ops do. No
// atomics: two runs give the same bits.
//
// Replaces: dl4ds_tpu/ops/pallas_convlstm.py `_seq_pallas` ->
// `_bwd_seq_kernel` (one grid step per batch tile carrying dh and dc in VMEM,
// the recurrent conv as kh band matmuls), the kernel of `_backward_split`.
//
// Bound: operations. Each step but the last is a GEMM of M = B*H*W pixels,
// N = F output channels and K = kh*kw*4F: 2*B*(T-1)*H*W*kh*kw*F*4F flops
// against about 4*B*T*H*W*(2*4F + 3F) bytes. At width 64 (batch 128, T 4,
// 16x16) that is 80.5 GFLOP (1.20 ms at 67 TFLOP/s of float32 outside the
// tensor cores) for a 5x5 layer and 29.0 GFLOP (0.43 ms) for a 3x3 one,
// against 0.37 GB (0.11 ms at 3.35 TB/s).
//
// Design: every step needs all of dz_{t+1} with a halo before any block
// reads it, so a layer is T launches of one step kernel on the caller's
// stream, as K3's chain. K3's chain step stages dz_{t+1} for a group of only
// 8 output channels, so at F = 64 eight blocks stage the same halo tile and
// each loaded value feeds 8 FMAs. Here the step is treated as the GEMM it is:
//   - a block takes a pixel tile of 8 rows x 16 columns of one sample and up
//     to 64 output channels (16 groups of 4; more blocks along y for F > 64);
//     a thread owns one column of the tile (8 pixels) and one group of 4
//     channels: a register micro-tile of 8 x 4 accumulators;
//   - the block walks K in chunks of 8 dz channels: it stages the chunk's
//     halo tile of dz_{t+1} as [channel][row][column] and the chunk's slice of
//     whT for all taps as [tap][channel][output] in shared memory (59 KB at
//     5x5 and F = 64, so two blocks share an SM);
//   - per dz channel and tap column dx a thread loads the 8 + kh - 1 values
//     of its column once and reuses them for all kh rows of taps: per
//     (channel, dx) 12 scalar and 5 float4 shared loads feed 160 FMAs at 5x5,
//     so the FMA pipe, not shared memory, is the limit;
//   - then the gate derivatives on the saved zs and cs write the four gates
//     of dz_t, and dc * hs(z_f) is carried to step t-1 in a [B, H, W, F]
//     scratch, as K3 carries it;
//   - the kernel size is known at compile time up to kh <= 3, 5 or 7, so the
//     register arrays stay in registers; kw is any odd size.
// A later PR would double-buffer the staging (cp.async or TMA), keep whT
// resident across chunks of a persistent block, and take the products to
// 3xTF32 mma tiles, which keep float32 accuracy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTW = 16;     // columns of a pixel tile, one per thread column
constexpr int kTH = 8;      // rows of a pixel tile, all of them each thread's
constexpr int kCK = 8;      // dz channels staged per chunk
constexpr int kGroups = 16; // groups of 4 output channels a block at most
constexpr int kMaxThreads = kTW * kGroups;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float hard_sigmoid(float z) {
  return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, z), 0.5f), 0.f), 1.f);
}

__device__ __forceinline__ float d_hard_sigmoid(float z) {
  const float g = hard_sigmoid(z);
  return g > 0.f && g < 1.f ? 0.2f : 0.f;
}

// floats of shared memory a block uses: whT's chunk for all taps, then the
// dz halo tile of the chunk
__host__ __device__ constexpr int smem_floats(int kh, int kw, int groups) {
  return kh * kw * kCK * 4 * groups + kCK * (kTH + kh - 1) * (kTW + kw - 1);
}

// Step `step` of the reverse chain. Grid: (pixel tiles of one frame, output
// channel blocks of 64, B); blockDim = 16 * groups, groups = min(16, ceil(F /
// 4)); requires kh <= KMAX.
template <int KMAX>
__global__ void __launch_bounds__(kMaxThreads, 2)
seq_chain_step(const float* __restrict__ zs, const float* __restrict__ cs,
               const float* __restrict__ dys, const float* __restrict__ whT,
               float* __restrict__ dzs, float* __restrict__ dcs, int t_steps,
               int step, int h, int wd, int f, int kh, int kw, int tiles_x,
               int groups) {
  extern __shared__ float4 smem4[];
  const int nbp = 4 * groups;                         // output channels staged
  float* w_s = reinterpret_cast<float*>(smem4);       // [tap][kCK][nbp]
  float* a_s = w_s + kh * kw * kCK * nbp;             // [kCK][rows][rw]
  const int rows = kTH + kh - 1, rw = kTW + kw - 1, plane = rows * rw;
  const int ph = kh / 2, pw = kw / 2;
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const int o0 = blockIdx.y * 4 * kGroups;
  const int b = blockIdx.z;
  const int f4 = 4 * f;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int col = tid % kTW;
  const int cg = tid / kTW;
  const int64_t hw = (int64_t)h * wd;
  const int64_t frame = (int64_t)b * t_steps + step;

  float acc[kTH][4];
#pragma unroll
  for (int i = 0; i < kTH; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (step + 1 < t_steps) {   // dh_next = convT(dz_{t+1}, wh)
    const float* src = dzs + (frame + 1) * hw * f4;
    for (int c0 = 0; c0 < f4; c0 += kCK) {
      const int cc = min(kCK, f4 - c0);   // 4 or 8: 4F is a multiple of 4
      __syncthreads();  // the previous chunk is no longer read
      for (int i = tid; i < plane; i += nthreads) {
        const int r = i / rw;
        const int yy = y0 - ph + r, xx = x0 - pw + (i - r * rw);
        if (yy >= 0 && yy < h && xx >= 0 && xx < wd) {
          const float* sp = src + ((int64_t)yy * wd + xx) * f4 + c0;
          for (int ci = 0; ci < cc; ci += 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(sp + ci));
            a_s[ci * plane + i] = v.x;
            a_s[(ci + 1) * plane + i] = v.y;
            a_s[(ci + 2) * plane + i] = v.z;
            a_s[(ci + 3) * plane + i] = v.w;
          }
        } else {
          for (int ci = 0; ci < cc; ++ci) a_s[ci * plane + i] = 0.f;
        }
      }
      // whT [kh, kw, 4F, F] -> [tap][chunk channel][output], zero past F
      for (int i = tid; i < kh * kw * kCK * nbp; i += nthreads) {
        const int j = i % nbp;
        const int row = i / nbp;
        const int ci = row % kCK;
        const int tap = row / kCK;
        const int o = o0 + j;
        w_s[i] = ci < cc && o < f ? __ldg(whT + ((int64_t)tap * f4 + c0 + ci) * f + o)
                                  : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int ci = 0; ci < cc; ++ci) {
        const float* ap = a_s + ci * plane + col;
#pragma unroll 1
        for (int dx = 0; dx < kw; ++dx) {
          float a[kTH + KMAX - 1];
#pragma unroll
          for (int r = 0; r < kTH + KMAX - 1; ++r)
            a[r] = r < kTH + kh - 1 ? ap[r * rw + dx] : 0.f;
          const float* wp = w_s + ((int64_t)dx * kCK + ci) * nbp + cg * 4;
#pragma unroll
          for (int dy = 0; dy < KMAX; ++dy) {
            if (dy >= kh) break;
            const float4 q = *reinterpret_cast<const float4*>(wp + dy * kw * kCK * nbp);
#pragma unroll
            for (int i = 0; i < kTH; ++i) {
              acc[i][0] = fmaf(a[i + dy], q.x, acc[i][0]);
              acc[i][1] = fmaf(a[i + dy], q.y, acc[i][1]);
              acc[i][2] = fmaf(a[i + dy], q.z, acc[i][2]);
              acc[i][3] = fmaf(a[i + dy], q.w, acc[i][3]);
            }
          }
        }
      }
    }
  }

  const int x = x0 + col;
  if (x >= wd) return;
#pragma unroll
  for (int i = 0; i < kTH; ++i) {
    const int y = y0 + i;
    if (y >= h) break;
    const int64_t pix = (int64_t)y * wd + x;
    const int64_t e = frame * hw + pix;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + cg * 4 + j;
      if (o >= f) break;
      const float* zp = zs + e * f4 + o;
      const float zi = zp[0], zf = zp[f], zc = zp[2 * f], zo = zp[3 * f];
      const float gi = hard_sigmoid(zi), gf = hard_sigmoid(zf);
      const float gg = tanhf(zc), go = hard_sigmoid(zo);
      const float tc = tanhf(cs[e * f + o]);
      const float c_prev = step > 0 ? cs[(e - hw) * f + o] : 0.f;
      float* dcp = dcs + ((int64_t)b * hw + pix) * f + o;
      const float dc_next = step + 1 < t_steps ? *dcp : 0.f;
      const float dh = __fadd_rn(dys[e * f + o], acc[i][j]);
      const float d_o = __fmul_rn(dh, tc);
      const float dc = __fadd_rn(
          __fmul_rn(__fmul_rn(dh, go), __fsub_rn(1.f, __fmul_rn(tc, tc))), dc_next);
      float* dzp = dzs + e * f4 + o;
      dzp[0] = __fmul_rn(__fmul_rn(dc, gg), d_hard_sigmoid(zi));
      dzp[f] = __fmul_rn(__fmul_rn(dc, c_prev), d_hard_sigmoid(zf));
      dzp[2 * f] = __fmul_rn(__fmul_rn(dc, gi), __fsub_rn(1.f, __fmul_rn(gg, gg)));
      dzp[3 * f] = __fmul_rn(d_o, d_hard_sigmoid(zo));
      *dcp = __fmul_rn(dc, gf);
    }
  }
}

template <int KMAX>
cudaError_t launch_step(const float* zs, const float* cs, const float* dys,
                        const float* whT, float* dzs, float* dcs, int b, int t_steps,
                        int step, int h, int wd, int f, int kh, int kw,
                        cudaStream_t stream) {
  auto kern = seq_chain_step<KMAX>;
  const int groups = min(kGroups, (f + 3) / 4);
  const int shmem = (int)sizeof(float) * smem_floats(kh, kw, groups);
  if (shmem > kMaxSmem) return cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern), cudaFuncAttributeMaxDynamicSharedMemorySize,
        shmem);
    if (err != cudaSuccess) return err;
  }
  const int tiles_x = (wd + kTW - 1) / kTW;
  const int tiles_y = (h + kTH - 1) / kTH;
  const dim3 grid(tiles_x * tiles_y, (f + 4 * kGroups - 1) / (4 * kGroups), b);
  kern<<<grid, kTW * groups, shmem, stream>>>(zs, cs, dys, whT, dzs, dcs, t_steps, step,
                                              h, wd, f, kh, kw, tiles_x, groups);
  return cudaGetLastError();
}

}  // namespace

// Step `step` (run T-1 down to 0, in order, on one stream) of the reverse
// chain: reads zs [B, T, H, W, 4F], cs and dys [B, T, H, W, F], whT [kh, kw,
// 4F, F] (the flipped, transposed recurrent kernel) and dz_{step+1} from dzs;
// writes dz_step to dzs [B, T, H, W, 4F]. The dc carry dcs [B, H, W, F] is
// the caller's scratch. Odd kh <= 7 and odd kw. Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a shape the kernel does not take);
// does not synchronise.
extern "C" int dl4ds_convlstm_seq_step(const float* zs, const float* cs,
                                       const float* dys, const float* whT,
                                       float* dzs, float* dcs, int b, int t_steps,
                                       int step, int h, int wd, int f, int kh, int kw,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || h < 1 || wd < 1 || f < 1 || step < 0 || step >= t_steps ||
      kh < 1 || kw < 1 || kh % 2 == 0 || kw % 2 == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (kh <= 3)
    err = launch_step<3>(zs, cs, dys, whT, dzs, dcs, b, t_steps, step, h, wd, f, kh, kw, s);
  else if (kh <= 5)
    err = launch_step<5>(zs, cs, dys, whT, dzs, dcs, b, t_steps, step, h, wd, f, kh, kw, s);
  else if (kh <= 7)
    err = launch_step<7>(zs, cs, dys, whT, dzs, dcs, b, t_steps, step, h, wd, f, kh, kw, s);
  return (int)err;
}

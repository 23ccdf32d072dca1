// ConvLSTM BPTT backward (K3) for NVIDIA Hopper (sm_90a).
//
// From the residuals of the forward's training variant (csrc/convlstm.cu:
// zs, the pre-activations z = (z_i, z_f, z_c, z_o) of every step with the
// bias and the recurrent term; cs; ys) and dys, the gradient of ys, with hs
// the Keras hard sigmoid and hs' its derivative (0.2 where hs lies strictly
// between 0 and 1, else 0; `_d_hard_sigmoid`):
//   dh_t  = dys_t + convT(dz_{t+1}, wh)       (no recurrent term at t = T-1)
//   do    = dh_t tanh(c_t)
//   dc_t  = dh_t hs(z_o) (1 - tanh(c_t)^2) + dc_{t+1} hs(z_f,t+1)
//   dz_i  = dc_t tanh(z_c) hs'(z_i)          dz_f = dc_t c_{t-1} hs'(z_f)
//   dz_c  = dc_t hs(z_i) (1 - tanh(z_c)^2)   dz_o = do hs'(z_o)   (c_{-1} = 0)
//   dx    = convT(dz, wx) over all B*T frames
//   dwx[dy, dx, c, g] = sum_p x_pad[p + (dy - ph, dx - pw), c] dz[p, g]
//   dwh   = the same with h_{t-1} (ys one step back; t = 0 adds nothing)
//   dbx   = sum_p dz[p, :]
// convT(dz, w) is the adjoint of the forward's SAME conv: the SAME conv of
// dz with w flipped in both spatial axes and its channel axes swapped.
// Layouts as in csrc/convlstm.cu: [B, T, H, W, C] activations, HWIO kernels
// with the gates i, f, c, o along 4F. All arithmetic is float32 FMA, no TF32;
// the gate algebra rounds product by product (__fmul_rn, __fadd_rn) as
// PyTorch's elementwise ops do. No atomics: two runs give the same bits.
//
// Replaces: dl4ds_tpu/ops/pallas_convlstm.py `_backward_pallas` ->
// `_bwd_kernel` (one grid step per batch tile: the reverse dh/dc loop with
// the recurrent band matmuls, then dx and the band-matrix gradients as
// T-batched matmuls; the per-tile gradient partials are summed after the
// call). The band matrices are the TPU's layout and are not reproduced.
//
// Bound: operations. dx and dWx need 2*B*T*H*W*kh*kw*Cin*4F flops each, the
// dh chain and dWh 2*B*(T-1)*H*W*kh*kw*F*4F each (h_{-1} = 0), against
// about 4*B*T*H*W*(2 Cin + 7F) bytes. For the recresnet_spc x4 training step
// (BASELINE config 4: batch 128, T = 4, 16x16 LR patches, F = 8) the six
// layers need 20.8 GFLOP and move about 0.2 GB: 0.31 ms at 67 TFLOP/s of
// float32 outside the tensor cores against 0.06 ms at 3.35 TB/s.
//
// Design, in three kinds of launch:
//   (a) dl4ds_convlstm_bptt_step, launched T times in reverse: the mirror of
//       K2's step kernel. A block takes one spatial tile (8*PY rows x 32
//       columns) of one sample and a group of 8 channels of h; it stages
//       dz_{t+1} with its halo, 8 of its 4F channels at a time, and the
//       flipped wh for its 8 outputs in shared memory, and each thread sums
//       convT for PY pixels x 8 channels. Then, per pixel and channel, the
//       gate derivatives on the saved zs, cs[t] and cs[t-1] write the four
//       gates of dz_t, and dc * hs(z_f) is carried to step t-1 in a
//       [B, H, W, F] scratch that only the owning thread touches, as K2
//       carries c.
//   (b) dl4ds_convlstm_dx: the same tiled convT over all B*T frames in one
//       launch, for groups of 8 input channels; skipped when x needs no
//       gradient (the model's first layer).
//   (c) dl4ds_convlstm_wgrad: a weight gradient is a reduction over the
//       pixels. A block walks `tpb` consecutive pixel tiles (up to 256
//       pixels of one frame each) in a fixed order; per tile it stages the
//       source (x, or h_{t-1} from ys) with its halo as [pixel][8 channels]
//       and dz as [pixel][32 gate channels], and each thread accumulates a
//       4 x 8 block of dW (4 source channels of one tap x 8 gate channels):
//       per pixel one float4 of the source, two of dz (broadcast across the
//       warp), 32 FMAs. The Wx pass also sums dz for dbx. Each block writes
//       its float32 partials; dl4ds_convlstm_wgrad_reduce then sums them row
//       by row in a fixed order. The weight gradients stay float32 end to
//       end.
// A later PR would keep dz_t on chip between chain steps (a cluster or a
// persistent grid), run the source staging of (c) asynchronously, and take
// the products to 3xTF32 mma tiles, which keep float32 accuracy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;                // columns of a tile, one per lane
constexpr int kTY = 8;                 // warps of a block, one row each
constexpr int kThreads = kTX * kTY;
constexpr int kCC = 8;                 // source channels staged per pass
constexpr int kFG = 8;                 // output channels of a block
constexpr int kWC = 8;                 // weight gradient: source channels of a block
constexpr int kWG = 32;                // weight gradient: gate channels of a block
constexpr int kWRT = 64;               // weight gradient: row tiles of a block
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float hard_sigmoid(float z) {
  return fminf(fmaxf(__fadd_rn(__fmul_rn(0.2f, z), 0.5f), 0.f), 1.f);
}

__device__ __forceinline__ float d_hard_sigmoid(float z) {
  const float g = hard_sigmoid(z);
  return g > 0.f && g < 1.f ? 0.2f : 0.f;
}

constexpr int convt_smem_floats(int py, int kh, int kw) {
  return kCC * (kTY * py + kh - 1) * (kTX + kw - 1) + kh * kw * kCC * kFG;
}

// acc[p][j] += convT(src, w) at the thread's PY pixels (rows y0 + ty + 8p,
// column x0 + tx) for the output channels o0 + j, j < no:
//   sum over taps (dy, dx) and source channels s of
//   src[y + dy - ph, x + dx - pw, s] * w[kh-1-dy, kw-1-dx, o0 + j, s].
// src is one frame [H, W, cs] with cs = 4F (a multiple of 4) and w the
// forward's HWIO kernel [kh, kw, co, cs]. For each chunk of 8 source
// channels the block stages the tile with its halo as [channel][row]
// [column] and the flipped weights as [tap][channel][8 outputs]. Every
// thread of the block calls it.
template <int PY, int K>
__device__ __forceinline__ void convt_accumulate(
    const float* __restrict__ src, const float* __restrict__ w, int h, int wd,
    int cs, int co, int o0, int no, int kh_, int kw_, int y0, int x0, float* in_s,
    float* w_s, float (&acc)[PY][kFG]) {
  constexpr int TH = kTY * PY;
  const int kh = K ? K : kh_;
  const int kw = K ? K : kw_;
  const int rows = TH + kh - 1;
  const int rw = kTX + kw - 1;
  const int plane = rows * rw;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int ph = kh / 2, pw = kw / 2;
  for (int c0 = 0; c0 < cs; c0 += kCC) {
    const int cc = min(kCC, cs - c0);   // 4 or 8
    __syncthreads();  // the previous chunk is no longer read
    for (int r = ty; r < rows; r += kTY) {
      const int yy = y0 - ph + r;
      for (int q = tx; q < rw; q += kTX) {
        const int xx = x0 - pw + q;
        float* dst = in_s + r * rw + q;
        if (yy >= 0 && yy < h && xx >= 0 && xx < wd) {
          const float* sp = src + ((int64_t)yy * wd + xx) * cs + c0;
          for (int ci = 0; ci < cc; ci += 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(sp + ci));
            dst[ci * plane] = v.x;
            dst[(ci + 1) * plane] = v.y;
            dst[(ci + 2) * plane] = v.z;
            dst[(ci + 3) * plane] = v.w;
          }
        } else {
          for (int ci = 0; ci < cc; ++ci) dst[ci * plane] = 0.f;
        }
      }
    }
    // the flipped weights of this chunk, zero for the outputs past no
    for (int i = threadIdx.x; i < kh * kw * cc * kFG; i += kThreads) {
      const int j = i % kFG;
      const int row = i / kFG;
      const int tap = row / cc;
      const int ci = row - tap * cc;
      const int dy = tap / kw;
      const int ftap = (kh - 1 - dy) * kw + (kw - 1 - (tap - dy * kw));
      w_s[(tap * kCC + ci) * kFG + j] =
          j < no ? __ldg(w + ((int64_t)ftap * co + o0 + j) * cs + c0 + ci) : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int dy = 0; dy < kh; ++dy) {
#pragma unroll 1
      for (int dx = 0; dx < kw; ++dx) {
        const float* ip = in_s + (ty + dy) * rw + tx + dx;
        const float* wp = w_s + (dy * kw + dx) * kCC * kFG;
#pragma unroll
        for (int ci = 0; ci < kCC; ++ci) {
          if (ci >= cc) break;
          float v[PY];
#pragma unroll
          for (int p = 0; p < PY; ++p) v[p] = ip[ci * plane + kTY * p * rw];
          const float4 q0 = *reinterpret_cast<const float4*>(wp + ci * kFG);
          const float4 q1 = *reinterpret_cast<const float4*>(wp + ci * kFG + 4);
#pragma unroll
          for (int p = 0; p < PY; ++p) {
            acc[p][0] = fmaf(v[p], q0.x, acc[p][0]);
            acc[p][1] = fmaf(v[p], q0.y, acc[p][1]);
            acc[p][2] = fmaf(v[p], q0.z, acc[p][2]);
            acc[p][3] = fmaf(v[p], q0.w, acc[p][3]);
            acc[p][4] = fmaf(v[p], q1.x, acc[p][4]);
            acc[p][5] = fmaf(v[p], q1.y, acc[p][5]);
            acc[p][6] = fmaf(v[p], q1.z, acc[p][6]);
            acc[p][7] = fmaf(v[p], q1.w, acc[p][7]);
          }
        }
      }
    }
  }
}

// (a) Step `step` of the reverse chain. Grid: (spatial tiles, ceil(F / 8)
// channel groups, B).
template <int PY, int K>
__global__ void __launch_bounds__(kThreads, 2)
bptt_step(const float* __restrict__ zs, const float* __restrict__ cs,
          const float* __restrict__ dys, const float* __restrict__ wh,
          float* __restrict__ dzs, float* __restrict__ dcs, int t_steps, int step,
          int h, int wd, int f, int kh, int kw, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* in_s = reinterpret_cast<float*>(smem4);
  float* w_s = in_s + kCC * (kTY * PY + (K ? K : kh) - 1) * (kTX + (K ? K : kw) - 1);
  const int y0 = (blockIdx.x / tiles_x) * kTY * PY;
  const int x0 = (blockIdx.x % tiles_x) * kTX;
  const int f0 = blockIdx.y * kFG;
  const int nf = min(kFG, f - f0);    // channels of this group that exist
  const int b = blockIdx.z;
  const int f4 = 4 * f;
  const int64_t hw = (int64_t)h * wd;
  const int64_t frame = (int64_t)b * t_steps + step;

  float acc[PY][kFG];
#pragma unroll
  for (int p = 0; p < PY; ++p)
#pragma unroll
    for (int j = 0; j < kFG; ++j) acc[p][j] = 0.f;
  if (step + 1 < t_steps)   // dh_next = convT(dz_{t+1}, wh)
    convt_accumulate<PY, K>(dzs + (frame + 1) * hw * f4, wh, h, wd, f4, f, f0, nf, kh,
                            kw, y0, x0, in_s, w_s, acc);

  const int xq = x0 + threadIdx.x % kTX;
#pragma unroll
  for (int p = 0; p < PY; ++p) {
    const int y = y0 + threadIdx.x / kTX + kTY * p;
    if (y >= h || xq >= wd) continue;
    const int64_t pix = (int64_t)y * wd + xq;
    const int64_t e = frame * hw + pix;
    const float* zp = zs + e * f4 + f0;
    const float* cp = cs + e * f + f0;
    const float* dyp = dys + e * f + f0;
    float* dzp = dzs + e * f4 + f0;
    float* dcp = dcs + ((int64_t)b * hw + pix) * f + f0;
#pragma unroll
    for (int j = 0; j < kFG; ++j) {
      if (j >= nf) break;
      const float zi = zp[j], zf = zp[f + j], zc = zp[2 * f + j], zo = zp[3 * f + j];
      const float gi = hard_sigmoid(zi), gf = hard_sigmoid(zf);
      const float gg = tanhf(zc), go = hard_sigmoid(zo);
      const float tc = tanhf(cp[j]);
      const float c_prev = step > 0 ? cp[j - hw * f] : 0.f;
      const float dc_next = step + 1 < t_steps ? dcp[j] : 0.f;
      const float dh = __fadd_rn(dyp[j], acc[p][j]);
      const float d_o = __fmul_rn(dh, tc);
      const float dc = __fadd_rn(
          __fmul_rn(__fmul_rn(dh, go), __fsub_rn(1.f, __fmul_rn(tc, tc))), dc_next);
      dzp[j] = __fmul_rn(__fmul_rn(dc, gg), d_hard_sigmoid(zi));
      dzp[f + j] = __fmul_rn(__fmul_rn(dc, c_prev), d_hard_sigmoid(zf));
      dzp[2 * f + j] = __fmul_rn(__fmul_rn(dc, gi), __fsub_rn(1.f, __fmul_rn(gg, gg)));
      dzp[3 * f + j] = __fmul_rn(d_o, d_hard_sigmoid(zo));
      dcp[j] = __fmul_rn(dc, gf);
    }
  }
}

// (b) dx = convT(dz, wx) for one frame per blockIdx.z (B*T of them) and a
// group of 8 input channels per blockIdx.y.
template <int PY, int K>
__global__ void __launch_bounds__(kThreads, 2)
dx_frames(const float* __restrict__ dzs, const float* __restrict__ wx,
          float* __restrict__ dx, int h, int wd, int cin, int f, int kh, int kw,
          int tiles_x) {
  extern __shared__ float4 smem4[];
  float* in_s = reinterpret_cast<float*>(smem4);
  float* w_s = in_s + kCC * (kTY * PY + (K ? K : kh) - 1) * (kTX + (K ? K : kw) - 1);
  const int y0 = (blockIdx.x / tiles_x) * kTY * PY;
  const int x0 = (blockIdx.x % tiles_x) * kTX;
  const int o0 = blockIdx.y * kFG;
  const int no = min(kFG, cin - o0);
  const int f4 = 4 * f;
  const int64_t hw = (int64_t)h * wd;
  const int64_t frame = blockIdx.z;

  float acc[PY][kFG];
#pragma unroll
  for (int p = 0; p < PY; ++p)
#pragma unroll
    for (int j = 0; j < kFG; ++j) acc[p][j] = 0.f;
  convt_accumulate<PY, K>(dzs + frame * hw * f4, wx, h, wd, f4, cin, o0, no, kh, kw,
                          y0, x0, in_s, w_s, acc);

  const int xq = x0 + threadIdx.x % kTX;
#pragma unroll
  for (int p = 0; p < PY; ++p) {
    const int y = y0 + threadIdx.x / kTX + kTY * p;
    if (y >= h || xq >= wd) continue;
    float* dp = dx + (frame * hw + (int64_t)y * wd + xq) * cin + o0;
#pragma unroll
    for (int j = 0; j < kFG; ++j)
      if (j < no) dp[j] = acc[p][j];
  }
}

// (c) Partial weight gradient over `tpb` consecutive pixel tiles (tile i of
// the frames used: frame i / tiles_frame, tile i % tiles_frame). The frames
// used are t = t_skip .. T-1 of every sample; the source frame is t - t_skip
// (x: t_skip = 0; h_{t-1} from ys: t_skip = 1). Grid: (pixel chunks,
// source-channel chunks x row-tile chunks x gate chunks). A block writes
// part[blockIdx.x][(tap * cs + c) * f4 + g] for its 8 source channels c and
// 32 gate channels g; with `with_db`, the blocks of the first source and
// row-tile chunk also write sum_p dz[p, g] at part[blockIdx.x][kh*kw*cs*f4
// + g].
__global__ void __launch_bounds__(256)
wgrad_partial(const float* __restrict__ src, const float* __restrict__ dzs,
              float* __restrict__ part, int64_t part_len, int with_db, int t_steps,
              int t_skip, int h, int wd, int cs, int f4, int kh, int kw, int tph,
              int tpw, int tiles_x, int tiles_frame, int n_tiles, int tpb,
              int n_cchunks, int n_rchunks) {
  extern __shared__ float4 smem4[];
  const int srows = tph + kh - 1, scols = tpw + kw - 1;
  float* src_s = reinterpret_cast<float*>(smem4);     // [srows * scols][kWC]
  float* dz_s = src_s + srows * scols * kWC;          // [tph * tpw][kWG]
  const int cchunk = blockIdx.y % n_cchunks;
  const int rchunk = (blockIdx.y / n_cchunks) % n_rchunks;
  const int gchunk = blockIdx.y / (n_cchunks * n_rchunks);
  const int c0 = cchunk * kWC;
  const int cc = min(kWC, cs - c0);
  const int cq = (cc + 3) / 4;           // row tiles per tap
  const int g0 = gchunk * kWG;
  const int gn = min(kWG, f4 - g0);
  const int ngg = (gn + 7) / 8;
  const int rt0 = rchunk * kWRT;
  const int nrt = min(kWRT, kh * kw * cq - rt0);
  if (nrt <= 0) return;                  // uniform: a short last channel chunk
  const int tid = threadIdx.x;
  const bool active = tid < nrt * ngg;
  // this thread's 4 x 8 block: row tile rt (tap, 4 channels from c4), gate
  // channels gg*8 .. gg*8 + 7
  const int rt = rt0 + tid % nrt;
  const int gg = tid / nrt;
  const int tap = rt / cq;
  const int c4 = (rt - tap * cq) * 4;
  const int dy = tap / kw;
  const int soff = (dy * scols + tap - dy * kw) * kWC + c4;
  const bool db_thread = with_db && cchunk == 0 && rchunk == 0 && tid < gn;
  const int ph = kh / 2, pw = kw / 2;
  const int frames = t_steps - t_skip;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float db = 0.f;

  const int it_end = min(n_tiles, (blockIdx.x + 1) * tpb);
  for (int it = blockIdx.x * tpb; it < it_end; ++it) {
    const int fi = it / tiles_frame;
    const int tile = it - fi * tiles_frame;
    const int bb = fi / frames;
    const int64_t dframe = (int64_t)bb * t_steps + (fi - bb * frames) + t_skip;
    const int64_t sframe = dframe - t_skip;
    const int y0 = (tile / tiles_x) * tph;
    const int x0 = (tile % tiles_x) * tpw;
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < srows * scols * kWC; i += blockDim.x) {
      const int c = i % kWC;
      const int pix = i / kWC;
      const int r = pix / scols;
      const int yy = y0 - ph + r, xx = x0 - pw + (pix - r * scols);
      src_s[i] = c < cc && yy >= 0 && yy < h && xx >= 0 && xx < wd
                     ? __ldg(src + ((sframe * h + yy) * wd + xx) * cs + c0 + c)
                     : 0.f;
    }
    for (int i = tid; i < tph * tpw * kWG; i += blockDim.x) {
      const int g = i % kWG;
      const int pix = i / kWG;
      const int r = pix / tpw;
      const int y = y0 + r, x = x0 + (pix - r * tpw);
      dz_s[i] = g < gn && y < h && x < wd
                    ? __ldg(dzs + ((dframe * h + y) * wd + x) * f4 + g0 + g)
                    : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int r = 0; r < tph; ++r) {
        const float* sp = src_s + r * scols * kWC + soff;
        const float* dp = dz_s + r * tpw * kWG + gg * 8;
#pragma unroll 4
        for (int q = 0; q < tpw; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(sp + q * kWC);
          const float4 d0 = *reinterpret_cast<const float4*>(dp + q * kWG);
          const float4 d1 = *reinterpret_cast<const float4*>(dp + q * kWG + 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
        }
      }
    }
    if (db_thread)
      for (int pix = 0; pix < tph * tpw; ++pix) db = __fadd_rn(db, dz_s[pix * kWG + tid]);
  }

  float* pp = part + (int64_t)blockIdx.x * part_len;
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (c4 + i >= cc) break;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (gg * 8 + j < gn)
          pp[((int64_t)tap * cs + c0 + c4 + i) * f4 + g0 + gg * 8 + j] = acc[i][j];
    }
  }
  if (db_thread) pp[(int64_t)kh * kw * cs * f4 + g0 + tid] = db;
}

// Row sums in a fixed order: oa[k] = sum_r pa[r * la + k] for k < la, then
// the same for (pb, nb, lb, ob). nb may be 0 (then ob is zero).
__global__ void __launch_bounds__(256)
wgrad_reduce(const float* __restrict__ pa, int na, int64_t la, float* __restrict__ oa,
             const float* __restrict__ pb, int nb, int64_t lb, float* __restrict__ ob) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float* p = pa;
  int n = na;
  int64_t l = la, k = i;
  float* o = oa;
  if (i >= la) {
    if (i >= la + lb) return;
    p = pb;
    n = nb;
    l = lb;
    k = i - la;
    o = ob;
  }
  float s = 0.f;
#pragma unroll 8
  for (int r = 0; r < n; ++r) s = __fadd_rn(s, __ldg(p + r * l + k));
  o[k] = s;
}

cudaError_t set_smem(const void* kern, int shmem) {
  if (shmem > kMaxSmem) return cudaErrorInvalidValue;
  if (shmem > 48 * 1024)
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                shmem);
  return cudaSuccess;
}

template <int PY, int K>
cudaError_t launch_step(const float* zs, const float* cs, const float* dys,
                        const float* wh, float* dzs, float* dcs, int b, int t_steps,
                        int step, int h, int wd, int f, int kh, int kw,
                        cudaStream_t stream) {
  auto kern = bptt_step<PY, K>;
  const int shmem = (int)sizeof(float) * convt_smem_floats(PY, kh, kw);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kern), shmem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + kTX - 1) / kTX;
  const int tiles_y = (h + kTY * PY - 1) / (kTY * PY);
  const dim3 grid(tiles_x * tiles_y, (f + kFG - 1) / kFG, b);
  kern<<<grid, kThreads, shmem, stream>>>(zs, cs, dys, wh, dzs, dcs, t_steps, step, h,
                                          wd, f, kh, kw, tiles_x);
  return cudaGetLastError();
}

template <int PY, int K>
cudaError_t launch_dx(const float* dzs, const float* wx, float* dx, int frames, int h,
                      int wd, int cin, int f, int kh, int kw, cudaStream_t stream) {
  auto kern = dx_frames<PY, K>;
  const int shmem = (int)sizeof(float) * convt_smem_floats(PY, kh, kw);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(kern), shmem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (wd + kTX - 1) / kTX;
  const int tiles_y = (h + kTY * PY - 1) / (kTY * PY);
  const dim3 grid(tiles_x * tiles_y, (cin + kFG - 1) / kFG, frames);
  kern<<<grid, kThreads, shmem, stream>>>(dzs, wx, dx, h, wd, cin, f, kh, kw, tiles_x);
  return cudaGetLastError();
}

}  // namespace

// (a) Step `step` (run T-1 down to 0, in order, on one stream) of the
// reverse chain: reads zs, cs [B, T, H, W, 4F | F], dys [B, T, H, W, F],
// wh and dz_{step+1} from dzs; writes dz_step to dzs [B, T, H, W, 4F]; the
// dc carry dcs [B, H, W, F] is the caller's scratch. py (1 or 2) is the
// number of rows a thread computes. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape the kernel does not take); does not
// synchronise.
extern "C" int dl4ds_convlstm_bptt_step(const float* zs, const float* cs,
                                        const float* dys, const float* wh, float* dzs,
                                        float* dcs, int b, int t_steps, int step, int h,
                                        int wd, int f, int kh, int kw, int py,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool k5 = kh == 5 && kw == 5, k3 = kh == 3 && kw == 3;
  cudaError_t err = cudaErrorInvalidValue;
  if (py == 2)
    err = k5 ? launch_step<2, 5>(zs, cs, dys, wh, dzs, dcs, b, t_steps, step, h, wd, f,
                                 kh, kw, s)
          : k3 ? launch_step<2, 3>(zs, cs, dys, wh, dzs, dcs, b, t_steps, step, h, wd,
                                   f, kh, kw, s)
               : launch_step<2, 0>(zs, cs, dys, wh, dzs, dcs, b, t_steps, step, h, wd,
                                   f, kh, kw, s);
  else if (py == 1)
    err = k5 ? launch_step<1, 5>(zs, cs, dys, wh, dzs, dcs, b, t_steps, step, h, wd, f,
                                 kh, kw, s)
          : k3 ? launch_step<1, 3>(zs, cs, dys, wh, dzs, dcs, b, t_steps, step, h, wd,
                                   f, kh, kw, s)
               : launch_step<1, 0>(zs, cs, dys, wh, dzs, dcs, b, t_steps, step, h, wd,
                                   f, kh, kw, s);
  return (int)err;
}

// (b) dx [frames, H, W, Cin] = convT(dzs, wx) over `frames` = B*T frames.
extern "C" int dl4ds_convlstm_dx(const float* dzs, const float* wx, float* dx,
                                 int frames, int h, int wd, int cin, int f, int kh,
                                 int kw, int py, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool k5 = kh == 5 && kw == 5, k3 = kh == 3 && kw == 3;
  cudaError_t err = cudaErrorInvalidValue;
  if (py == 2)
    err = k5   ? launch_dx<2, 5>(dzs, wx, dx, frames, h, wd, cin, f, kh, kw, s)
          : k3 ? launch_dx<2, 3>(dzs, wx, dx, frames, h, wd, cin, f, kh, kw, s)
               : launch_dx<2, 0>(dzs, wx, dx, frames, h, wd, cin, f, kh, kw, s);
  else if (py == 1)
    err = k5   ? launch_dx<1, 5>(dzs, wx, dx, frames, h, wd, cin, f, kh, kw, s)
          : k3 ? launch_dx<1, 3>(dzs, wx, dx, frames, h, wd, cin, f, kh, kw, s)
               : launch_dx<1, 0>(dzs, wx, dx, frames, h, wd, cin, f, kh, kw, s);
  return (int)err;
}

// (c) Partial weight gradients of the source src [B, T, H, W, cs] (x with
// t_skip 0, ys with t_skip 1) against dzs, over pixel tiles of tph x tpw,
// `tpb` tiles a block; part is [n_chunks, part_len] with part_len =
// kh*kw*cs*4F (+ 4F with_db). n_chunks must be the number of blocks that
// this plan gives (checked). Returns a cudaError_t.
extern "C" int dl4ds_convlstm_wgrad(const float* src, const float* dzs, float* part,
                                    int n_chunks, int with_db, int b, int t_steps,
                                    int t_skip, int h, int wd, int cs, int f, int kh,
                                    int kw, int tph, int tpw, int tpb, void* stream) {
  const int f4 = 4 * f;
  const int tiles_x = (wd + tpw - 1) / tpw;
  const int tiles_frame = tiles_x * ((h + tph - 1) / tph);
  const int64_t n_tiles = (int64_t)b * (t_steps - t_skip) * tiles_frame;
  if (tph < 1 || tpw < 1 || tpb < 1 || n_tiles < 1 || n_tiles > INT32_MAX ||
      (n_tiles + tpb - 1) / tpb != n_chunks)
    return (int)cudaErrorInvalidValue;
  const int n_cchunks = (cs + kWC - 1) / kWC;
  const int cq_max = (min(kWC, cs) + 3) / 4;
  const int n_rchunks = (kh * kw * cq_max + kWRT - 1) / kWRT;
  const int n_gchunks = (f4 + kWG - 1) / kWG;
  const int64_t grid_y = (int64_t)n_cchunks * n_rchunks * n_gchunks;
  if (grid_y > 65535) return (int)cudaErrorInvalidValue;
  const int64_t part_len = (int64_t)kh * kw * cs * f4 + (with_db ? f4 : 0);
  const int threads =
      (min(kWRT, kh * kw * cq_max) * ((min(kWG, f4) + 7) / 8) + 31) / 32 * 32;
  const int shmem =
      (int)sizeof(float) * ((tph + kh - 1) * (tpw + kw - 1) * kWC + tph * tpw * kWG);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(wgrad_partial), shmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_chunks, (unsigned)grid_y);
  wgrad_partial<<<grid, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      src, dzs, part, part_len, with_db, t_steps, t_skip, h, wd, cs, f4, kh, kw, tph, tpw,
      tiles_x, tiles_frame, (int)n_tiles, tpb, n_cchunks, n_rchunks);
  return (int)cudaGetLastError();
}

// oa [la] = the sum of the na rows of pa [na, la] and ob [lb] that of the nb
// rows of pb, each row after row in order.
extern "C" int dl4ds_convlstm_wgrad_reduce(const float* pa, int na, int64_t la,
                                           float* oa, const float* pb, int nb,
                                           int64_t lb, float* ob, void* stream) {
  const int64_t n = la + lb;
  if (n < 1 || (n + 255) / 256 > INT32_MAX) return (int)cudaErrorInvalidValue;
  wgrad_reduce<<<(unsigned)((n + 255) / 256), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(pa, na, la, oa, pb, nb, lb, ob);
  return (int)cudaGetLastError();
}

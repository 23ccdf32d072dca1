// The ConvLSTM BPTT chain step (K4, and K3's chain) and K3's dx pass for
// NVIDIA Hopper (sm_90a): one implicit-GEMM tile of the transposed SAME conv
// with two epilogues.
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
//   dx    = convT(dz, wx) over all B*T frames
// convT(dz, w)[p, o] = sum_{dy, dx, s} dz[p + (dy - ph, dx - pw), s]
// wT[dy, dx, s, o], with wT[dy, dx, s, o] = w[kh-1-dy, kw-1-dx, o, s]: the
// wrapper flips and transposes the kernel once a layer, so the tile computes
// a SAME conv of dz with an HWIO kernel [kh, kw, 4F, N]. Layouts as in
// csrc/convlstm.cu: [B, T, H, W, C] activations, gates i, f, c, o along 4F.
// The gate algebra rounds product by product (__fmul_rn, __fadd_rn) as
// PyTorch's elementwise ops do. No atomics: two runs give the same bits.
// In bfloat16 (every tensor) the products are bfloat16 mma.sync m16n8k16
// with float32 partials (csrc/bf16_mma.cuh), the recurrent term and dx
// rounded once to bfloat16 (JAX's acc_h.astype(dt) and acc_x.astype(dt)),
// and every op of the chain, the dh and dc carries and dz rounded to
// bfloat16, as `_bwd_seq_kernel` carries them in the model dtype
// (pallas_convlstm.py:289-333): K4's six width-64 layers take 5.53 ms
// against a 0.39 ms bound, K3's chain and dx within its 1.24 ms at width 8
// (chip_smoke.py phase 12, NVIDIA H100 80GB HBM3 at 700 W).
//
// Replaces: dl4ds_tpu/ops/pallas_convlstm.py `_seq_pallas` ->
// `_bwd_seq_kernel` (:269; one grid step per batch tile carrying dh and dc
// in VMEM, the recurrent conv as kh band matmuls), the kernel of
// `_backward_split`; and the reverse loop and the dx contraction of
// `_bwd_kernel` (:335), whose weight gradients are csrc/convlstm_bwd.cu.
//
// Bound: operations. Each chain step but the last is a GEMM of M = B*H*W
// pixels, N = F output channels and K = kh*kw*4F: 2*B*(T-1)*H*W*kh*kw*F*4F
// flops against about 4*B*T*H*W*(2*4F + 3F) bytes. At width 64 (batch 128,
// T 4, 16x16) that is 80.5 GFLOP for a 5x5 layer and 29.0 GFLOP for a 3x3
// one: 1.20 / 0.43 ms at 67 TFLOP/s of float32 outside the tensor cores,
// 0.49 / 0.18 ms at 165 TFLOP/s, a third of the 495 TFLOP/s of dense TF32
// that 3xTF32 spends three products on; 0.37 GB of traffic takes 0.11 ms.
// dx is the same GEMM over all B*T frames with N = Cin.
//
// Design: the step is K2's implicit-GEMM step tile (csrc/convlstm.cu) with
// the GEMM transposed. Every step needs all of dz_{t+1} with its halo before
// any block reads it, so the chain is T launches on the caller's stream.
//   - A block (8 warps) computes a 128-pixel tile of one frame, tw = min(W,
//     32) columns x th = min(128 / tw, H) rows (a 16x16 frame is two whole
//     tiles, no idle lane; ragged tiles are masked), for NS = 8, 16, 32 or
//     64 output channels (channels past N get zero weights and are not
//     written). At NS 64 a warp owns 2 m16 pixel runs x 4 n8 channel tiles,
//     the warps 4 x 2; below it one m16 run x NS/8 tiles, the warps 8 x 1.
//     So F = 8 makes 256 blocks a step at batch 128 for the 132 SMs.
//   - The K loop walks chunks of cw = 8 or 4 of the 4F dz channels and, in
//     each, rps = kh or 1 tap rows a stage, as K2's: the chunk's dz tile with
//     its halo (12 floats a pixel: 8 channels, a zero the padded k rows point
//     at, padding for conflict-free A fragments) is staged once for all NS
//     channels and tap rows; a stage's wT rows, (tap, channel) pairs
//     flattened and padded to a multiple of 8, at a row stride of max(24, NS
//     + 8) floats (conflict-free B fragments); both double-buffered with
//     cp.async, the next stage loading while this one computes.
//   - The products are 3xTF32 mma.sync m16n8k8 from the shared header
//     csrc/tf32_mma.cuh (hi*lo + lo*hi + hi*hi, cvt.rna splits), and every 4
//     k-steps the fresh partial accumulators are added into the float32
//     result, round to nearest: over a K of 6,400 the tensor cores' truncated
//     accumulation would otherwise drift past 1e-5.
//   - The epilogue takes the block's sums through shared memory, so that a
//     warp then holds consecutive channels of a pixel and its loads and
//     stores cover whole sectors (in the fragment layout a store touches 8
//     pixels and every other channel, which measured slower); it loads
//     every input of 4 values before their stores, which the compiler must
//     assume alias them. The chain epilogue forms dh for (pixel, o) and writes the
//     four gates of dz_t for o; dc * hs(z_f) is carried to step t-1 in a
//     [B, H, W, F] scratch that only that thread touches. The dx epilogue
//     stores the sums.
// The kernel size is a runtime value: the k rows of a stage are flattened
// (tap, channel) pairs read through an offset table, as in K2, so every odd
// kh and kw take the same body; the plan (ops/convlstm.py `_seq_plan`) takes
// the deepest stage that leaves room for two blocks an SM. NS and the
// epilogue are template parameters: 12 bodies an element type,
// `chain_step<NS>` (K3's chain), `split_chain<NS>` (K4's: the same body
// under its own name, so that a device trace tells the routes apart) and
// `dx_frames<NS>`, over one tile.
//
// The member mode (a deep ensemble's M members in one launch): the kernel
// wT is stacked [M, kh, kw, C, N], each member's flipped and transposed in
// turn, and the frames are M members of `per_member` frames (samples for a
// chain step, B*T frames for dx); a block of frame x reads member x /
// per_member's wT. A block covers one frame and the wrapper plans from a
// member's own frame count, so the blocks are those of M one-member
// launches: the same bits. A launch of more than one member runs the
// kernels' MEMBERS instantiation; one layer's launch runs the one without
// it, whose single wT needs no member index: the member index cost
// dx_frames<float, 8> 90 registers against 80, two blocks an SM against
// three, and K3's dx at width 8 9% (chip_smoke.py phase 6's split by
// launch; NVIDIA H100 80GB HBM3, 700.00 W).
//
// Measured (chip_smoke.py phase 6, medians of 40 CUDA-event timings with
// L2 flushed, and tools/torch_chain_probe.py; NVIDIA H100 80GB HBM3, 700.00
// W): K4's six width-64 layers (batch 128, T 4, 16x16) take 8.63-8.64 ms
// against 21.49-21.50 ms for the float32 FMA kernel this replaced, bounds
// 4.90 ms (float32) and 1.99 ms (3xTF32): 2.04 ms a 5x5 layer (39.5
// TFLOP/s), 0.84 ms a 3x3 one (34.5 TFLOP/s); a step with its recurrent
// term 654 / 268 us, the last step (the epilogue alone) 44 us. K3's chain
// at F = 8 takes 33 / 21 us a step at 5x5 / 3x3, about 9 us of it the
// epilogue-only step's time, and dx 110 / 61 us. What holds it back: at 64
// channels, as in K2, issue slots (a shared load and a 5-instruction split
// per fragment value, three mma.sync per product) and mma.sync's rate; at
// 8 channels, one n8 tile a warp, so each dz value loaded and split feeds
// one product. Splitting the staged dz tile once a chunk into shared
// memory, separate accumulators for the three products, and splitting the
// k-steps over two warp groups at four blocks an SM all measured no faster
// on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "smem_attr.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kPS = 12;                 // elements a staged pixel: 8 channels,
constexpr int kZero = 8;                // a zero, padding
constexpr int kFlush = 4;               // k-steps a partial accumulator takes
constexpr int kMaxSmem = 227 * 1024;

template <typename T>
struct Args {
  const T* src;   // dzs [frames, H, W, C]: dz_{t+1} (chain) or dz (dx)
  const T* w;     // wT [kh, kw, C, N]: whT (chain) or wxT (dx)
  T* out;         // chain: dzs (dz_t written); dx: [frames, H, W, N]
  const T* zs;    // chain only: zs [B, T, H, W, C]
  const T* cs;    //   cs, dys [B, T, H, W, N]
  const T* dys;
  T* dcs;         //   the dc carry [B, H, W, N]
  int t_steps, step, h, wd, c, n, kh, kw, th, tw, cw, rps, tiles_x, tiles;
  int per_member; // frames a member: w is stacked [frames / per_member, ...]
};

// staged weight row stride of a block of NS output channels: 8 or 24 mod
// 32, so the 4 k rows x 8 columns of a B fragment fall in distinct banks
__host__ __device__ constexpr int w_stride(int ns) {
  return ns + 8 > 24 ? ns + 8 : 24;
}

constexpr int kBM = 128;                // pixels of a block

// k rows of a mma k-step: 8 (TF32 m16n8k8) or 16 (bfloat16 m16n8k16)
template <typename T>
constexpr int kK = kIsBf16<T> ? 16 : 8;

// k rows of a stage: rps tap rows x kw taps x cw channels, padded to a k-step
__host__ __device__ inline int stage_rows(int rps, int kw, int cw, int kstep) {
  return (rps * kw * cw + kstep - 1) / kstep * kstep;
}

// Shared memory of a block, in bytes: two dz tiles with their halo, two
// stages of weight rows, two k-offset tables; the epilogue then reuses it
// for the block's float32 sums (th*tw rows of ns + 8).
__host__ __device__ inline int smem_bytes(int elem, int ns, int th, int tw, int kh, int kw,
                                          int cw, int rps) {
  const int kp = stage_rows(rps, kw, cw, elem == 2 ? 16 : 8);
  const int staged = elem * (2 * (th + kh - 1) * (tw + kw - 1) * kPS + 2 * kp * w_stride(ns)) +
                     4 * 2 * kp;
  const int sums = 4 * th * tw * (ns + 8);
  return staged > sums ? staged : sums;
}

// The tile: out[p, n] = sum_{dy, dx, s} src[p + (dy - ph, dx - pw), s] *
// w[dy, dx, s, n] for the block's 128 pixels and NS channels, then the
// chain's gate epilogue (CHAIN) or a plain store. Chain: grid.x = B*tiles,
// block x // tiles the sample; dx: grid.x = B*T*tiles, the frame. grid.y:
// ceil(N / NS) channel slices. T float: 3xTF32 products and the float32
// chain; T bf16: bfloat16 products, the sums rounded once to bfloat16 (dh's
// recurrent term, dx), every op of the chain and the carries in bfloat16.
template <typename T, int NS, bool CHAIN, bool MEMBERS>
__device__ __forceinline__ void convt_tile(const Args<T>& a) {
  constexpr bool BF = kIsBf16<T>;
  constexpr int KS = kK<T>;
  constexpr int WARPS_N = NS == 64 ? 2 : 1;  // warp columns
  constexpr int WN = NS / 8 / WARPS_N;       // n8 tiles a warp
  constexpr int WM = NS == 64 ? 2 : 1;       // m16 tiles a warp
  constexpr int WS = w_stride(NS);
  const int C = a.c, N = a.n, kh = a.kh, kw = a.kw, th = a.th, tw = a.tw;
  const int cw = a.cw, rps = a.rps;
  const int SW = tw + kw - 1, npix = (th + kh - 1) * SW;
  const int KP = stage_rows(rps, kw, cw, KS);
  extern __shared__ float4 smem4[];
  T* in_s = reinterpret_cast<T*>(smem4);                  // [2][npix][kPS]
  T* w_s = in_s + 2 * npix * kPS;                         // [2][KP][WS]
  int* koff_s = reinterpret_cast<int*>(w_s + 2 * KP * WS);  // [2][KP]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;   // fragment row group, column
  const int wn = warp % WARPS_N;
  const int mb = (warp / WARPS_N) * WM * 16; // first pixel of this warp
  const int tile = blockIdx.x % a.tiles;
  const int fr = blockIdx.x / a.tiles;       // sample (chain) or frame (dx)
  const int64_t frame = CHAIN ? (int64_t)fr * a.t_steps + a.step : fr;
  const int64_t hw = (int64_t)a.h * a.wd;
  const int ty0 = (tile / a.tiles_x) * th, tx0 = (tile % a.tiles_x) * tw;
  const int n0 = blockIdx.y * NS;
  // this frame's member: its wT
  const T* wm =
      MEMBERS ? a.w + (int64_t)(fr / a.per_member) * kh * kw * C * N : a.w;
  const int ph = kh / 2, pw = kw / 2;
  // the chain's last step has no recurrent term
  const bool has_src = !CHAIN || a.step + 1 < a.t_steps;
  const T* src = has_src ? a.src + (frame + (CHAIN ? 1 : 0)) * hw * C : a.src;
  const int n_chunks = (C + cw - 1) / cw;
  const int spc = kh / rps;                  // stages a chunk
  const int n_iter = has_src ? n_chunks * spc : 0;
  const bool vec_w = N % 4 == 0;             // then 4 channels align
  const int nv_w = vec_w ? 4 : 1;

  // k row (tap row, tap, channel) -> offset in a staged dz tile, for the
  // full chunks and for the last; padded rows point at the zero slot
  for (int i = tid; i < 2 * KP; i += kThreads) {
    const int cc = i < KP ? min(cw, C) : C - (n_chunks - 1) * cw;
    const int kk = i < KP ? i : i - KP;
    const int tap = kk / cc;
    koff_s[i] = kk < rps * kw * cc
                    ? ((tap / kw) * SW + tap % kw) * kPS + kk % cc
                    : kZero;
  }
  for (int i = tid; i < 2 * npix; i += kThreads) in_s[i * kPS + kZero] = from_f<T>(0.f);

  // stage u: channel chunk u / spc, tap rows from dy = (u % spc) * rps. Its
  // weight rows go to buffer u & 1 and, with the chunk's first stage, the
  // chunk's dz tile to buffer chunk & 1; by cp.async (a single bfloat16 by
  // a plain copy), zero-filled out of the frame or past N. C = 4F is a
  // multiple of 4, so a chunk is 4 or 8 channels and its copies are of 4.
  auto stage = [&](int u) {
    const int ci0 = u / spc, dy = (u - ci0 * spc) * rps;
    const int c0 = ci0 * cw, cc = min(cw, C - c0);
    const int rows = rps * kw * cc;
    T* ws = w_s + (u & 1) * KP * WS;
    for (int i = tid; i < rows * NS / nv_w; i += kThreads) {
      const int e = i * nv_w;
      const int kk = e / NS, j = e - kk * NS;
      const int tap = kk / cc, ci = kk - tap * cc;
      const bool ok = n0 + j < N;
      const T* sp = wm + ((int64_t)(dy * kw + tap) * C + c0 + ci) * N + n0 + j;
      copy_elems<T>(ws + kk * WS + j, ok ? sp : wm, nv_w, ok);
    }
    for (int i = tid; i < (KP - rows) * NS; i += kThreads)
      ws[(rows + i / NS) * WS + i % NS] = from_f<T>(0.f);
    if (dy != 0) return;
    T* is = in_s + (ci0 & 1) * npix * kPS;
    for (int i = tid; i < npix * cc / 4; i += kThreads) {
      const int e = i * 4;
      const int p = e / cc, ci = e - p * cc;
      const int r = p / SW, q = p - r * SW;
      const int yy = ty0 - ph + r, xx = tx0 - pw + q;
      const bool ok = yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd;
      const T* sp = src + ((int64_t)yy * a.wd + xx) * C + c0 + ci;
      copy_elems<T>(is + p * kPS + ci, ok ? sp : src, 4, ok);
    }
  };

  // the staged offsets of this thread's fragment rows (rows past the tile
  // read pixel 0 and are not stored)
  int po[WM][2];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = mb + mt * 16 + gq + 8 * hf;
      po[mt][hf] = m < th * tw ? ((m / tw) * SW + m % tw) * kPS : 0;
    }

  // accumulators [m tile][n tile][fragment value]: value i is pixel
  // mb + mt*16 + gq + 8 * (i >> 1), channel n0 + (wn*WN + j)*8 + 2*tq + (i & 1)
  float acc[WM][WN][4] = {};

  if (n_iter > 0) stage(0);
  cp_async_commit();
  for (int u = 0; u < n_iter; ++u) {
    if (u + 1 < n_iter) stage(u + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int ci0 = u / spc, dy = (u - ci0 * spc) * rps;
    const int cc = min(cw, C - ci0 * cw);
    const int ksteps = (rps * kw * cc + KS - 1) / KS;
    const T* is = in_s + (ci0 & 1) * npix * kPS + dy * SW * kPS;
    const T* ws = w_s + (u & 1) * KP * WS + wn * WN * 8 + gq;
    const int* ko = koff_s + (ci0 == n_chunks - 1 ? KP : 0);
    // the products in fresh accumulators, added to acc in float32 (round
    // to nearest) every kFlush k-steps
    float part[WM][WN][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k0 = ks * KS;
      if constexpr (BF) {
        const int o0 = ko[k0 + 2 * tq], o1 = ko[k0 + 2 * tq + 1];
        const int o2 = ko[k0 + 2 * tq + 8], o3 = ko[k0 + 2 * tq + 9];
        uint32_t bb[WN][2], aa[WM][4];
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const T* wc = ws + j * 8;
          bb[j][0] = pack_bf16(wc[(k0 + 2 * tq) * WS], wc[(k0 + 2 * tq + 1) * WS]);
          bb[j][1] = pack_bf16(wc[(k0 + 2 * tq + 8) * WS], wc[(k0 + 2 * tq + 9) * WS]);
        }
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
          const T* r0 = is + po[mt][0];
          const T* r1 = is + po[mt][1];
          aa[mt][0] = pack_bf16(r0[o0], r0[o1]);
          aa[mt][1] = pack_bf16(r1[o0], r1[o1]);
          aa[mt][2] = pack_bf16(r0[o2], r0[o3]);
          aa[mt][3] = pack_bf16(r1[o2], r1[o3]);
        }
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int j = 0; j < WN; ++j) mma_bf16(part[mt][j], aa[mt], bb[j][0], bb[j][1]);
      } else {
        const int o0 = ko[k0 + tq], o1 = ko[k0 + tq + 4];
        uint32_t bh[WN][2], bl[WN][2], ah[WM][4], al[WM][4];
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          split_tf32(to_f(ws[(k0 + tq) * WS + j * 8]), bh[j][0], bl[j][0]);
          split_tf32(to_f(ws[(k0 + tq + 4) * WS + j * 8]), bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
          split_tf32(to_f(is[po[mt][0] + o0]), ah[mt][0], al[mt][0]);
          split_tf32(to_f(is[po[mt][1] + o0]), ah[mt][1], al[mt][1]);
          split_tf32(to_f(is[po[mt][0] + o1]), ah[mt][2], al[mt][2]);
          split_tf32(to_f(is[po[mt][1] + o1]), ah[mt][3], al[mt][3]);
        }
        // hi*lo, then lo*hi, then hi*hi, each over the independent tiles
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int j = 0; j < WN; ++j)
            mma_tf32(part[mt][j], ah[mt], bl[j][0], bl[j][1]);
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int j = 0; j < WN; ++j)
            mma_tf32(part[mt][j], al[mt], bh[j][0], bh[j][1]);
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int j = 0; j < WN; ++j)
            mma_tf32(part[mt][j], ah[mt], bh[j][0], bh[j][1]);
      }
      if (ks % kFlush == kFlush - 1 || ks == ksteps - 1) {
#pragma unroll
        for (int mt = 0; mt < WM; ++mt)
#pragma unroll
          for (int j = 0; j < WN; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[mt][j][i] += part[mt][j][i];
              part[mt][j][i] = 0.f;
            }
      }
    }
    __syncthreads();   // this stage's buffers may be refilled
  }

  // the epilogue: the sums go through shared memory, so that a warp then
  // takes consecutive channels of a pixel and its loads and stores of zs,
  // cs, dys, dz and the dc carry cover whole sectors (a fragment holds 8
  // pixels and every other channel). Four values a thread at a time, every
  // input loaded before any store: the compiler must assume that the
  // stores alias the loads.
  constexpr int EW = NS + 8;                 // row stride of the sums
  float* ep_s = reinterpret_cast<float*>(smem4);   // [th*tw][EW]
  const int P = th * tw;
  __syncthreads();                           // the staging is done with
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mb + mt * 16 + gq + 8 * (i >> 1);
        if (m < P) ep_s[m * EW + (wn * WN + j) * 8 + 2 * tq + (i & 1)] = acc[mt][j][i];
      }
  __syncthreads();
  for (int base = 0; base < P * NS; base += 4 * kThreads) {
    int64_t e[4], pix[4];
    int o[4], idx[4];
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      idx[i] = base + i * kThreads + tid;
      const int m = idx[i] / NS;
      const int y = ty0 + m / tw, x = tx0 + m % tw;
      o[i] = n0 + idx[i] % NS;
      ok[i] = idx[i] < P * NS && y < a.h && x < a.wd && o[i] < N;
      pix[i] = (int64_t)y * a.wd + x;
      e[i] = frame * hw + pix[i];
    }
    if (!CHAIN) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ok[i]) a.out[e[i] * N + o[i]] = from_f<T>(ep_s[(idx[i] / NS) * EW + idx[i] % NS]);
      continue;
    }
    float z[4][4], c_t[4], c_prev[4], dc_next[4], dy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ok[i]) continue;
      const T* zp = a.zs + e[i] * C + o[i];
#pragma unroll
      for (int g = 0; g < 4; ++g) z[i][g] = to_f(zp[g * N]);
      c_t[i] = to_f(a.cs[e[i] * N + o[i]]);
      c_prev[i] = a.step > 0 ? to_f(a.cs[(e[i] - hw) * N + o[i]]) : 0.f;
      dc_next[i] = a.step + 1 < a.t_steps
                       ? to_f(a.dcs[((int64_t)fr * hw + pix[i]) * N + o[i]])
                       : 0.f;
      dy[i] = to_f(a.dys[e[i] * N + o[i]]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ok[i]) continue;
      const float zi = z[i][0], zf = z[i][1], zc = z[i][2], zo = z[i][3];
      const float gi = hsig<T>(zi), gf = hsig<T>(zf);
      const float gg = tanh_<T>(zc), go = hsig<T>(zo);
      const float tc = tanh_<T>(c_t[i]);
      // bfloat16: the recurrent term is rounded once, as JAX's acc_h.astype
      const float dh = add<T>(dy[i], op<T>(ep_s[(idx[i] / NS) * EW + idx[i] % NS]));
      const float d_o = mul<T>(dh, tc);
      const float dc =
          add<T>(mul<T>(mul<T>(dh, go), sub<T>(1.f, mul<T>(tc, tc))), dc_next[i]);
      T* dzp = a.out + e[i] * C + o[i];
      dzp[0] = from_f<T>(mul<T>(mul<T>(dc, gg), d_hsig<T>(zi)));
      dzp[N] = from_f<T>(mul<T>(mul<T>(dc, c_prev[i]), d_hsig<T>(zf)));
      dzp[2 * N] = from_f<T>(mul<T>(mul<T>(dc, gi), sub<T>(1.f, mul<T>(gg, gg))));
      dzp[3 * N] = from_f<T>(mul<T>(d_o, d_hsig<T>(zo)));
      a.dcs[((int64_t)fr * hw + pix[i]) * N + o[i]] = from_f<T>(mul<T>(dc, gf));
    }
  }
}

template <typename T, int NS, bool MEMBERS>
__global__ void __launch_bounds__(kThreads, 2) chain_step(const Args<T> a) {
  convt_tile<T, NS, true, MEMBERS>(a);
}

template <typename T, int NS, bool MEMBERS>
__global__ void __launch_bounds__(kThreads, 2) split_chain(const Args<T> a) {
  convt_tile<T, NS, true, MEMBERS>(a);
}

template <typename T, int NS, bool MEMBERS>
__global__ void __launch_bounds__(kThreads, 2) dx_frames(const Args<T> a) {
  convt_tile<T, NS, false, MEMBERS>(a);
}

enum Kind { kChain, kSplitChain, kDx };

template <typename T, int NS, int KIND, bool MEMBERS>
cudaError_t launch(Args<T>& a, int64_t frames, cudaStream_t s) {
  auto kern = KIND == kChain        ? chain_step<T, NS, MEMBERS>
              : KIND == kSplitChain ? split_chain<T, NS, MEMBERS>
                                    : dx_frames<T, NS, MEMBERS>;
  const size_t shmem =
      (size_t)smem_bytes((int)sizeof(T), NS, a.th, a.tw, a.kh, a.kw, a.cw, a.rps);
  if (shmem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    const cudaError_t err = dl4ds::reserve_smem(kern, shmem);
    if (err != cudaSuccess) return err;
  }
  a.tiles_x = (a.wd + a.tw - 1) / a.tw;
  const int64_t tiles = (int64_t)a.tiles_x * ((a.h + a.th - 1) / a.th);
  const int64_t blocks = frames * tiles;
  const int slices = (a.n + NS - 1) / NS;
  if (blocks > INT32_MAX || slices > 65535) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  kern<<<dim3((unsigned)blocks, slices), kThreads, shmem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND, bool MEMBERS>
cudaError_t launch_by_ns(Args<T>& a, int64_t frames, int ns, cudaStream_t s) {
  if (ns == 8) return launch<T, 8, KIND, MEMBERS>(a, frames, s);
  if (ns == 16) return launch<T, 16, KIND, MEMBERS>(a, frames, s);
  if (ns == 32) return launch<T, 32, KIND, MEMBERS>(a, frames, s);
  if (ns == 64) return launch<T, 64, KIND, MEMBERS>(a, frames, s);
  return cudaErrorInvalidValue;
}

// the member mode's instantiation for more than one member, the one-layer
// instantiation (one wT, no member index) for one
template <typename T, int KIND>
cudaError_t launch_ns(Args<T>& a, int64_t frames, int ns, cudaStream_t s) {
  if (frames < 1 || a.h < 1 || a.wd < 1 || a.n < 1 || a.c < 4 || a.c % 4 ||
      a.per_member < 1 || frames % a.per_member ||
      a.kh < 1 || a.kw < 1 || a.kh % 2 == 0 || a.kw % 2 == 0 ||
      (a.cw != 4 && a.cw != 8) || (a.rps != 1 && a.rps != a.kh) ||
      a.th < 1 || a.tw < 1 || a.th * a.tw > kBM)
    return cudaErrorInvalidValue;
  return a.per_member < frames ? launch_by_ns<T, KIND, true>(a, frames, ns, s)
                               : launch_by_ns<T, KIND, false>(a, frames, ns, s);
}

template <typename T, int KIND>
cudaError_t seq_step(const void* zs, const void* cs, const void* dys, const void* wht,
                     void* dzs, void* dcs, int b, int t_steps, int step, int h, int wd, int f,
                     int kh, int kw, int ns, int th, int tw, int cw, int rps, int per_member,
                     cudaStream_t s) {
  Args<T> a{static_cast<const T*>(dzs), static_cast<const T*>(wht), static_cast<T*>(dzs),
            static_cast<const T*>(zs), static_cast<const T*>(cs), static_cast<const T*>(dys),
            static_cast<T*>(dcs), t_steps, step, h, wd, 4 * f, f, kh, kw, th, tw, cw, rps, 0, 0,
            per_member};
  return launch_ns<T, KIND>(a, b, ns, s);
}

template <typename T>
cudaError_t dx(const void* dzs, const void* wxt, void* out, int frames, int h, int wd, int cin,
               int f, int kh, int kw, int ns, int th, int tw, int cw, int rps, int per_member,
               cudaStream_t s) {
  Args<T> a{static_cast<const T*>(dzs), static_cast<const T*>(wxt), static_cast<T*>(out),
            nullptr, nullptr, nullptr, nullptr, 1, 0, h, wd, 4 * f, cin, kh, kw, th, tw, cw,
            rps, 0, 0, per_member};
  return launch_ns<T, kDx>(a, frames, ns, s);
}

template <int KIND>
int chain(int dtype, const void* zs, const void* cs, const void* dys, const void* wht,
          void* dzs, void* dcs, int b, int t_steps, int step, int h, int wd, int f, int kh,
          int kw, int ns, int th, int tw, int cw, int rps, int per_member, void* stream) {
  if (b < 1 || step < 0 || step >= t_steps) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)seq_step<float, KIND>(zs, cs, dys, wht, dzs, dcs, b, t_steps, step, h, wd, f,
                                      kh, kw, ns, th, tw, cw, rps, per_member, s);
  if (dtype == 1)
    return (int)seq_step<bf16, KIND>(zs, cs, dys, wht, dzs, dcs, b, t_steps, step, h, wd, f,
                                     kh, kw, ns, th, tw, cw, rps, per_member, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Step `step` (run T-1 down to 0, in order, on one stream) of the reverse
// chain of K3 (the fused route): reads zs [B, T, H, W, 4F], cs and dys [B,
// T, H, W, F], whT [kh, kw, 4F, F] (the flipped, transposed recurrent
// kernel) and dz_{step+1} from dzs; writes dz_step to dzs [B, T, H, W, 4F].
// The dc carry dcs [B, H, W, F] is the caller's scratch. dtype: 0 float32,
// 1 bfloat16 (every tensor). The plan comes from the wrapper
// (ops/convlstm.py `_seq_plan`): ns (8, 16, 32 or 64 output channels a
// block), the th x tw pixel tile (at most 128 pixels), cw (4 or 8 dz
// channels a chunk) and rps (1 or kh tap rows a stage). Odd kh and kw.
// per_member: the member mode's samples a member (whT stacked [b /
// per_member, ...]; b for one layer's kernel). Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a shape or plan the kernel does not
// take); does not synchronise.
extern "C" int dl4ds_convlstm_seq_step(int dtype, const void* zs, const void* cs,
                                       const void* dys, const void* wht, void* dzs, void* dcs,
                                       int b, int t_steps, int step, int h, int wd, int f,
                                       int kh, int kw, int ns, int th, int tw, int cw, int rps,
                                       int per_member, void* stream) {
  return chain<kChain>(dtype, zs, cs, dys, wht, dzs, dcs, b, t_steps, step, h, wd, f, kh, kw,
                       ns, th, tw, cw, rps, per_member, stream);
}

// The same step for K4 (the split route), launched as `split_chain`.
extern "C" int dl4ds_convlstm_split_step(int dtype, const void* zs, const void* cs,
                                         const void* dys, const void* wht, void* dzs,
                                         void* dcs, int b, int t_steps, int step, int h, int wd,
                                         int f, int kh, int kw, int ns, int th, int tw, int cw,
                                         int rps, int per_member, void* stream) {
  return chain<kSplitChain>(dtype, zs, cs, dys, wht, dzs, dcs, b, t_steps, step, h, wd, f, kh,
                            kw, ns, th, tw, cw, rps, per_member, stream);
}

// dx [frames, H, W, Cin] = convT(dzs, wx) over `frames` = B*T frames of dzs
// [frames, H, W, 4F], with wxT [kh, kw, 4F, Cin] the flipped, transposed
// input kernel (stacked [frames / per_member, ...] in the member mode, a
// member's B*T frames each). dtype, plan and return value as
// dl4ds_convlstm_seq_step's.
extern "C" int dl4ds_convlstm_dx(int dtype, const void* dzs, const void* wxt, void* out,
                                 int frames, int h, int wd, int cin, int f, int kh, int kw,
                                 int ns, int th, int tw, int cw, int rps, int per_member,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dx<float>(dzs, wxt, out, frames, h, wd, cin, f, kh, kw, ns, th, tw, cw, rps,
                          per_member, s);
  if (dtype == 1)
    return (int)dx<bf16>(dzs, wxt, out, frames, h, wd, cin, f, kh, kw, ns, th, tw, cw, rps,
                         per_member, s);
  return (int)cudaErrorInvalidValue;
}

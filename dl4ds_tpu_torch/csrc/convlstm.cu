// Fused ConvLSTM layer forward (K2) for NVIDIA Hopper (sm_90a), in its
// inference variant (ys only) and its training variant (ys plus the cs and
// zs residuals that the BPTT backwards, K3 in csrc/convlstm_seq.cu and
// csrc/convlstm_bwd.cu and K4 in csrc/convlstm_seq.cu, read). The cp.async,
// TF32 split and mma helpers are csrc/tf32_mma.cuh, shared with them.
//
//   zx  = conv_same(x_t, wx) + bx                       all T frames at once
//   z   = zx_t + conv_same(h_{t-1}, wh)                 gates i, f, c, o
//   c_t = hs(z_f) * c_{t-1} + hs(z_i) * tanh(z_c)
//   h_t = hs(z_o) * tanh(c_t)             ys[:, t] = h_t,  h_{-1} = c_{-1} = 0
//
// with hs the Keras hard sigmoid clip(0.2 z + 0.5, 0, 1). x is
// [B, T, H, W, Cin] and ys [B, T, H, W, F], float32, NHWC per frame; wx
// [kh, kw, Cin, 4F] and wh [kh, kw, F, 4F] are HWIO with the gates split
// along 4F; bx [4F]. Odd kh, kw (symmetric SAME padding). The gate products
// and sums are rounded one by one (__fmul_rn, __fadd_rn) as PyTorch's
// elementwise ops round them; tanhf, no fast-math intrinsics.
//
// bfloat16 (every tensor; the dtype of a bfloat16 model, whose JAX kernel
// runs its operands and gate algebra in the model dtype with float32
// accumulation, pallas_convlstm.py:188-201, :235-262): the products are one
// mma.sync m16n8k16 with bfloat16 operands and float32 partials
// (csrc/bf16_mma.cuh), a stage's k rows padded to 16; zx = bf(bf(conv) +
// bx), z = bf(zx_t + bf(recurrent conv)) (the conv rounded before its bias
// or zx_t is added, as JAX's bfloat16 conv output is), and every gate op,
// c and h rounded to bfloat16 (`rb`), 0.2 itself a bfloat16, as JAX's
// bfloat16 ops round them. At the width-64 training step the six layers
// take 10.64 ms against a 0.67 ms bound at the dense bfloat16 rate (1.03
// ms at the 643 TFLOP/s mma.sync peak); 1.13 ms for the six layers of a
// batch-8 recresnet_spc forward (chip_smoke.py phase 12, NVIDIA H100 80GB
// HBM3 at 700 W). Copies of fewer than 4 bytes (a single bfloat16 channel)
// are plain loads and stores, which the barrier before a stage orders.
//
// Replaces: dl4ds_tpu/ops/pallas_convlstm.py `_forward_pallas` ->
// `_fwd_kernel` (:219; phase 1, :219-245, the input conv over all B*T
// frames through `_band_conv_bt`; phase 2, :247-266, the recurrence), in
// both its variants (save_residuals False and True).
//
// Bound: operations. Each output (b, t, y, x, f) needs kh*kw*Cin FMAs per
// gate for the input conv and, from t = 1 on (h_{-1} = 0), kh*kw*F more for
// the recurrent one: 2*B*H*W*kh*kw*4F*(T*Cin + (T-1)*F) flops against about
// 4*B*T*H*W*(Cin+F) bytes in and out. At the width-64 training step (batch
// 128, T 4, 16x16, 64 -> 64 5x5) a layer does 188 GFLOP: 2.80 ms at 67
// TFLOP/s of float32 outside the tensor cores, 1.14 ms at 165 TFLOP/s, a
// third of the 495 TFLOP/s of dense TF32 that 3xTF32 spends three products
// on.
//
// Design. A layer is T launches on the caller's stream:
//   1. `convlstm_tile<FS, false, TRAIN>`, the input conv hoisted out of the
//      recurrence as `_fwd_kernel` hoists it: one implicit GEMM over all
//      B*T frames, M = B*T*H*W pixels, N = 4F gate channels, K =
//      kh*kw*Cin. It writes zx (bias included) into zs (training) or into a
//      [B, T, H, W, 4F] scratch (inference), and for the frames of t = 0,
//      which have no recurrent term, it also runs the gate epilogue;
//   2. `convlstm_tile<FS, true, TRAIN>` for each t >= 1, in order: the
//      accumulators start from zx_t and add conv_same(h_{t-1}, wh) (M =
//      B*H*W, K = kh*kw*F), h_{t-1} read from ys[:, t-1]; the training
//      variant writes z back to zs[:, t]; then the gate epilogue. The sum
//      order is (bx + sum of x terms) + sum of h terms, as the plain version
//      and the JAX kernel form it.
// Every step needs all of h_{t-1} before any block reads its halo, and a
// sample's h at 128x128x8 (512 KB) is larger than an SM's shared memory, so
// the recurrence stays one launch a step.
//
// A block (8 warps) computes all four gates of FS = 8 or 16 output channels
// (channels past F get zero weights and are not written) for a tile of TH
// rows x TW columns of one frame, 256 pixels at FS 8 and 128 at FS 16 (TW =
// min(W, 32), TH = min(pixels / TW, H), from the wrapper's plan): a 16x16
// frame is one or two whole tiles with no idle lane; ragged tiles are
// masked.
// A warp owns two m16 runs of pixels and the four gate n8 tiles of one
// 8-channel sub-slice, so that one thread holds i, f, c and o of its pixels
// and channels for the epilogue. The K loop walks chunks of CW = 8 or 4
// source channels and, in each, RPS = kh or 1 tap rows a stage (the plan
// takes the deepest stage whose double buffers leave room for two blocks
// an SM):
//   - the chunk's input tile with its halo ((TH+kh-1) x (TW+kw-1) pixels, 12
//     floats a pixel: 8 channels, a zero the padded k rows point at, and
//     padding that makes the A fragment loads free of bank conflicts) is
//     staged once for the whole N tile and all its tap rows, so each staged
//     value feeds all 4FS gate channels;
//   - a stage's weights, RPS*kw*CW k rows of 4FS gate channels (row stride
//     4FS+8, conflict-free B fragment loads);
//   - both are double-buffered with cp.async (zero-filled out of the frame
//     or past F), so the next stage loads while this one computes;
//   - the k rows of a stage are (tap, channel) pairs, flattened and padded
//     to a multiple of 8 with zero weights, so Cin = 1 or 2 take the same
//     path at one k-step for 8 taps.
// The products run on the tensor cores in 3xTF32:
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 from shared-memory
// fragments; each float32 operand a is split into hi = rna(a) and lo =
// rna(a - hi), rna rounding as cvt.rna.tf32.f32 does, and hi*lo, lo*hi and
// hi*hi are accumulated in float32 (lo*lo is below float32's rounding).
// The tensor cores truncate what they add into an accumulator: over the
// 400 k-steps of a 64 -> 64 5x5 layer that drifted past K2's 1e-5 check on
// the card, so every 4 k-steps go into a fresh partial accumulator that is
// then added to the layer's in float32, round to nearest. That keeps
// float32 accuracy: a CPU emulation of this arithmetic over whole layers
// stays within 1.2e-6 of the float32 plain version, closer to float64 than
// it (tests/test_torch_convlstm.py), and the card's results stay within
// 2e-6 of it (chip_smoke.py). The split runs in registers at each fragment
// load: splitting into shared memory once a stage instead measured slower
// (twice the shared-memory traffic, another pass and barrier).
// mma.sync and cp.async, not wgmma and TMA: the tiles here are small (128
// or 256 pixels, a stage's K of 40 to 200) and the N tile must hold the
// four gates of a channel for the epilogue; mma.sync is the simpler correct
// first step. It does not reach wgmma's dense TF32 rate
// (tools/torch_mma_peak.py measures it), which caps 3xTF32 here below the
// 165 TFLOP/s bound; the 64-row warpgroup products with TMA-fed tiles are
// left for a later PR.
// FS and the two launch kinds are template parameters, as is TRAIN (a
// uniform branch in the epilogue measured 1.5% slower on the inference
// variant): 8 instantiations, every kernel size through the same body.
//
// The member mode (a deep ensemble's M members in one launch, the
// counterpart of vmapping the layer over stacked weights): wx, bx and wh are
// stacked [M, ...] and the B samples are M members of `per_member` samples
// in turn; a block of sample b reads the weights of member b / per_member.
// A block covers one frame, so no tile straddles two members, and the
// wrapper plans the launch from the per-member batch, so a member-mode call
// runs, block for block, the blocks of M one-member calls: the same bits.
// One layer's call is the member mode with M = 1 (per_member = B).
//
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, medians of
// 40 CUDA-event timings with L2 flushed): the training variant at batch
// 128, T 4, 16x16 takes 2.26 ms at 1 -> 64 5x5, 1.92 ms at 64 -> 64 3x3 and
// 4.78 ms at 64 -> 64 5x5, 17.56 ms for the six layers of a width-64 step
// against 18.94 ms for the plain version (cuDNN float32) and bounds of
// 9.87 ms (float32) and 4.01 ms (3xTF32): 35-39 TFLOP/s on the wide
// layers, 23% of the 3xTF32 bound. The six layers of a width-8 step take
// 0.58 ms, those of a batch-8 recresnet_spc forward (T 4, 128x128) 1.60
// ms. What holds it back: issue slots (each fragment value costs a load
// and a 5-instruction split, each product three mma), the 128-register cap
// that two blocks an SM impose, and mma.sync's rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "smem_attr.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWM = 2;                  // m16 pixel tiles a warp
constexpr int kPS = 12;                 // elements a staged pixel: 8 channels,
constexpr int kZero = 8;                // a zero, padding
constexpr int kFlush = 4;               // k-steps a partial accumulator takes
constexpr int kMaxSmem = 227 * 1024;

template <typename T>
struct Args {
  const T* x;     // [B, T, H, W, Cin] (input launch)
  const T* w;     // wx (input launch) or wh (step launch), HWIO
  const T* bx;    // [4F]
  T* zx;          // [B, T, H, W, 4F]: zs (training) or the scratch
  T* ys;          // [B, T, H, W, F]
  T* c;           // training: cs [B, T, H, W, F]; inference [B, H, W, F]
  int t_steps, step, h, wd, cin, f, kh, kw, th, tw, cw, rps, tiles_x, tiles;
  int per_member; // samples a member: w and bx are stacked [B / per_member, ...]
};

// k rows of a mma k-step: 8 (TF32 m16n8k8) or 16 (bfloat16 m16n8k16)
template <typename T>
constexpr int kK = kIsBf16<T> ? 16 : 8;

// k rows of a stage: rps tap rows x kw taps x cw channels, padded to a k-step
__host__ __device__ inline int stage_rows(int rps, int kw, int cw, int kstep) {
  return (rps * kw * cw + kstep - 1) / kstep * kstep;
}

// Shared memory of a block, in bytes: two input tiles with their halo
// ((th+kh-1) x (tw+kw-1) pixels of kPS elements), two stages of weight rows
// (KP rows of 4FS gate channels, row stride 4FS+8), two k-offset tables.
__host__ __device__ inline int smem_bytes(int elem, int fs, int th, int tw, int kh, int kw,
                                          int cw, int rps) {
  const int kp = stage_rows(rps, kw, cw, elem == 2 ? 16 : 8);
  return elem * (2 * (th + kh - 1) * (tw + kw - 1) * kPS + 2 * kp * (4 * fs + 8)) + 4 * 2 * kp;
}

// One launch of the layer: STEP false is the input conv over all B*T frames
// (grid.x = B*T*tiles), with the gate epilogue of t = 0; STEP true is time
// step a.step >= 1 (grid.x = B*tiles). grid.y: ceil(F / FS) channel slices.
// T float: 3xTF32 products, the float32 gate algebra; T bf16: bfloat16
// products, every stored value and gate op rounded to bfloat16.
template <typename T, int FS, bool STEP, bool TRAIN>
__global__ void __launch_bounds__(kThreads, 2) convlstm_tile(const Args<T> a) {
  constexpr bool BF = kIsBf16<T>;
  constexpr int KS = kK<T>;       // k rows a mma k-step
  constexpr int NSUB = FS / 8;    // warp columns: 8-channel sub-slices
  constexpr int BN = 4 * FS;      // gate channels of the N tile
  constexpr int WS = BN + 8;      // staged weight row stride
  const int C = STEP ? a.f : a.cin;     // source channels
  const int f = a.f, kh = a.kh, kw = a.kw, th = a.th, tw = a.tw;
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
  const int wn = warp % NSUB;                // sub-slice of this warp
  const int mb = (warp / NSUB) * kWM * 16;   // first pixel of this warp
  const int tile = blockIdx.x % a.tiles;
  const int fr = blockIdx.x / a.tiles;       // frame (input) or sample (step)
  const int b = STEP ? fr : fr / a.t_steps;
  const int t = STEP ? a.step : fr % a.t_steps;
  const int64_t frame = (int64_t)b * a.t_steps + t;
  const int64_t hw = (int64_t)a.h * a.wd;
  // this sample's member: its weights and bias
  const int member = b / a.per_member;
  const T* wm = a.w + (int64_t)member * kh * kw * C * 4 * f;
  const T* bm = STEP ? nullptr : a.bx + (int64_t)member * 4 * f;
  const int ty0 = (tile / a.tiles_x) * th, tx0 = (tile % a.tiles_x) * tw;
  const int f0 = blockIdx.y * FS;
  const int ph = kh / 2, pw = kw / 2;
  const T* src = STEP ? a.ys + (frame - 1) * hw * f : a.x + frame * hw * C;
  const int n_chunks = (C + cw - 1) / cw;
  const int spc = kh / rps;                  // stages a chunk
  const int n_iter = n_chunks * spc;
  const bool vec_src = C % 4 == 0;           // then every chunk is 4 or 8 wide
  const bool vec_w = f % 4 == 0;             // then 4 gate channels align
  const int nv_w = vec_w ? 4 : 1;

  // k row (tap row, tap, channel) -> offset in a staged input tile, for
  // the full chunks and for the last; padded rows point at the zero slot
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
  // chunk's input tile to buffer chunk & 1; by cp.async (a single
  // bfloat16 by a plain copy), zero-filled out of the frame or past F
  auto stage = [&](int u) {
    const int ci0 = u / spc, dy = (u - ci0 * spc) * rps;
    const int c0 = ci0 * cw, cc = min(cw, C - c0);
    const int rows = rps * kw * cc;
    T* ws = w_s + (u & 1) * KP * WS;
    for (int i = tid; i < rows * BN / nv_w; i += kThreads) {
      const int e = i * nv_w;
      const int kk = e / BN, n = e - kk * BN;
      const int g = n / FS, j = n - g * FS;
      const int tap = kk / cc, ci = kk - tap * cc;
      const bool ok = f0 + j < f;
      const T* sp = wm + ((int64_t)(dy * kw + tap) * C + c0 + ci) * 4 * f +
                    g * f + f0 + j;
      copy_elems<T>(ws + kk * WS + n, ok ? sp : wm, nv_w, ok);
    }
    for (int i = tid; i < (KP - rows) * BN; i += kThreads)
      ws[(rows + i / BN) * WS + i % BN] = from_f<T>(0.f);
    if (dy != 0) return;
    T* is = in_s + (ci0 & 1) * npix * kPS;
    const int nv = vec_src ? 4 : 1;
    for (int i = tid; i < npix * cc / nv; i += kThreads) {
      const int e = i * nv;
      const int p = e / cc, ci = e - p * cc;
      const int r = p / SW, q = p - r * SW;
      const int yy = ty0 - ph + r, xx = tx0 - pw + q;
      const bool ok = yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd;
      const T* sp = src + ((int64_t)yy * a.wd + xx) * C + c0 + ci;
      copy_elems<T>(is + p * kPS + ci, ok ? sp : src, nv, ok);
    }
  };

  // the staged offsets of this thread's fragment rows (rows past the tile
  // read pixel 0 and are not stored)
  int po[kWM][2];
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = mb + mt * 16 + gq + 8 * hf;
      po[mt][hf] = m < th * tw ? ((m / tw) * SW + m % tw) * kPS : 0;
    }

  // accumulators [m tile][gate][fragment value]: value i is pixel
  // mb + mt*16 + gq + 8 * (i >> 1), channel f0 + wn*8 + 2*tq + (i & 1).
  // float32: started from bx (input launch) or zx_t (step), as the plain
  // version sums; bfloat16: from zero, the conv rounded before its bias or
  // zx_t is added, as JAX's bfloat16 conv output is
  float acc[kWM][4][4];
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = mb + mt * 16 + gq + 8 * (i >> 1);
      const int fo = f0 + wn * 8 + 2 * tq + (i & 1);
      const int y = ty0 + m / tw, xq = tx0 + m % tw;
      const bool ok = !BF && m < th * tw && y < a.h && xq < a.wd && fo < f;
      const T* zp = a.zx + (frame * hw + (int64_t)y * a.wd + xq) * 4 * f + fo;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[mt][g][i] = !ok ? 0.f : STEP ? to_f(zp[g * f]) : to_f(bm[g * f + fo]);
    }

  stage(0);
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
    const T* ws = w_s + (u & 1) * KP * WS + wn * 8 + gq;
    const int* ko = koff_s + (ci0 == n_chunks - 1 ? KP : 0);
    // the products in fresh accumulators, added to acc in float32 (round
    // to nearest) every kFlush k-steps: the tensor cores truncate what they
    // accumulate, which over a whole K of 3200 drifted past 1e-5
    float part[kWM][4][4] = {};
#pragma unroll 1
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k0 = ks * KS;
      if constexpr (BF) {
        // k rows 2tq, 2tq+1 (a0, a1, b0) and 2tq+8, 2tq+9 (a2, a3, b1)
        const int o0 = ko[k0 + 2 * tq], o1 = ko[k0 + 2 * tq + 1];
        const int o2 = ko[k0 + 2 * tq + 8], o3 = ko[k0 + 2 * tq + 9];
        uint32_t bb[4][2], aa[kWM][4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const T* wc = ws + g * FS;
          bb[g][0] = pack_bf16(wc[(k0 + 2 * tq) * WS], wc[(k0 + 2 * tq + 1) * WS]);
          bb[g][1] = pack_bf16(wc[(k0 + 2 * tq + 8) * WS], wc[(k0 + 2 * tq + 9) * WS]);
        }
#pragma unroll
        for (int mt = 0; mt < kWM; ++mt) {
          const T* r0 = is + po[mt][0];
          const T* r1 = is + po[mt][1];
          aa[mt][0] = pack_bf16(r0[o0], r0[o1]);
          aa[mt][1] = pack_bf16(r1[o0], r1[o1]);
          aa[mt][2] = pack_bf16(r0[o2], r0[o3]);
          aa[mt][3] = pack_bf16(r1[o2], r1[o3]);
        }
#pragma unroll
        for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
          for (int g = 0; g < 4; ++g) mma_bf16(part[mt][g], aa[mt], bb[g][0], bb[g][1]);
      } else {
        const int o0 = ko[k0 + tq], o1 = ko[k0 + tq + 4];
        uint32_t bh[4][2], bl[4][2], ah[kWM][4], al[kWM][4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          split_tf32(to_f(ws[(k0 + tq) * WS + g * FS]), bh[g][0], bl[g][0]);
          split_tf32(to_f(ws[(k0 + tq + 4) * WS + g * FS]), bh[g][1], bl[g][1]);
        }
#pragma unroll
        for (int mt = 0; mt < kWM; ++mt) {
          split_tf32(to_f(is[po[mt][0] + o0]), ah[mt][0], al[mt][0]);
          split_tf32(to_f(is[po[mt][1] + o0]), ah[mt][1], al[mt][1]);
          split_tf32(to_f(is[po[mt][0] + o1]), ah[mt][2], al[mt][2]);
          split_tf32(to_f(is[po[mt][1] + o1]), ah[mt][3], al[mt][3]);
        }
        // hi*lo, then lo*hi, then hi*hi, each over the 8 independent tiles
#pragma unroll
        for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            mma_tf32(part[mt][g], ah[mt], bl[g][0], bl[g][1]);
#pragma unroll
        for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            mma_tf32(part[mt][g], al[mt], bh[g][0], bh[g][1]);
#pragma unroll
        for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            mma_tf32(part[mt][g], ah[mt], bh[g][0], bh[g][1]);
      }
      if (ks % kFlush == kFlush - 1 || ks == ksteps - 1) {
#pragma unroll
        for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[mt][g][i] += part[mt][g][i];
              part[mt][g][i] = 0.f;
            }
      }
    }
    __syncthreads();   // this stage's buffers may be refilled
  }

  // epilogue: zx (input launch) or z (training step) out, then the gates
  // where h_{t-1} is known: every step launch, and the input launch's t = 0
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = mb + mt * 16 + gq + 8 * (i >> 1);
      const int fo = f0 + wn * 8 + 2 * tq + (i & 1);
      const int y = ty0 + m / tw, xq = tx0 + m % tw;
      if (m >= th * tw || y >= a.h || xq >= a.wd || fo >= f) continue;
      const int64_t pix = (int64_t)y * a.wd + xq;
      T* zp = a.zx + (frame * hw + pix) * 4 * f + fo;
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        // bfloat16: zx = bf(bf(conv) + bx); z = bf(zx_t + bf(conv))
        z[g] = !BF    ? acc[mt][g][i]
               : STEP ? add<T>(to_f(zp[g * f]), rb(acc[mt][g][i]))
                      : add<T>(rb(acc[mt][g][i]), to_f(bm[g * f + fo]));
        if (!STEP || TRAIN) zp[g * f] = from_f<T>(z[g]);
      }
      if (!STEP && t != 0) continue;
      // inference: c in the [B, H, W, F] scratch; training: c_t in
      // cs[:, t] and c_{t-1} in cs[:, t-1]
      T* cp = TRAIN ? a.c + (frame * hw + pix) * f + fo
                    : a.c + ((int64_t)b * hw + pix) * f + fo;
      const float c_prev = !STEP ? 0.f : TRAIN ? to_f(cp[-hw * f]) : to_f(*cp);
      const float c_new = add<T>(mul<T>(hsig<T>(z[1]), c_prev),
                                 mul<T>(hsig<T>(z[0]), tanh_<T>(z[2])));
      *cp = from_f<T>(c_new);
      a.ys[(frame * hw + pix) * f + fo] = from_f<T>(mul<T>(hsig<T>(z[3]), tanh_<T>(c_new)));
    }
}

template <typename T, int FS, bool STEP>
cudaError_t launch(Args<T>& a, int frames, int train, cudaStream_t s) {
  constexpr int kBM = (8 / (FS / 8)) * kWM * 16;   // pixels of a block
  if (a.th < 1 || a.tw < 1 || a.th * a.tw > kBM) return cudaErrorInvalidValue;
  auto kern = train ? convlstm_tile<T, FS, STEP, true> : convlstm_tile<T, FS, STEP, false>;
  const size_t shmem = (size_t)smem_bytes((int)sizeof(T), FS, a.th, a.tw, a.kh, a.kw, a.cw,
                                          a.rps);
  if (shmem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    const cudaError_t err = dl4ds::reserve_smem(kern, shmem);
    if (err != cudaSuccess) return err;
  }
  a.tiles_x = (a.wd + a.tw - 1) / a.tw;
  const int64_t tiles = (int64_t)a.tiles_x * ((a.h + a.th - 1) / a.th);
  const int64_t blocks = frames * tiles;
  const int slices = (a.f + FS - 1) / FS;
  if (blocks > INT32_MAX || slices > 65535) return cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  kern<<<dim3((unsigned)blocks, slices), kThreads, shmem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool STEP>
cudaError_t launch_fs(Args<T>& a, int64_t frames, int fs, int train, cudaStream_t s) {
  if (a.kh < 1 || a.kw < 1 || a.kh % 2 == 0 || a.kw % 2 == 0 || a.f < 1 || a.per_member < 1 ||
      (a.cw != 4 && a.cw != 8) || (a.rps != 1 && a.rps != a.kh) ||
      frames > INT32_MAX)
    return cudaErrorInvalidValue;
  if (fs == 8) return launch<T, 8, STEP>(a, (int)frames, train, s);
  if (fs == 16) return launch<T, 16, STEP>(a, (int)frames, train, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t input(const void* x, const void* wx, const void* bx, void* zx, void* ys, void* c,
                  int b, int t_steps, int h, int wd, int cin, int f, int kh, int kw, int fs,
                  int th, int tw, int cw, int rps, int train, int per_member, cudaStream_t s) {
  Args<T> a{static_cast<const T*>(x), static_cast<const T*>(wx), static_cast<const T*>(bx),
            static_cast<T*>(zx), static_cast<T*>(ys), static_cast<T*>(c), t_steps, 0, h, wd,
            cin, f, kh, kw, th, tw, cw, rps, 0, 0, per_member};
  return launch_fs<T, false>(a, (int64_t)b * t_steps, fs, train, s);
}

template <typename T>
cudaError_t step(const void* wh, void* zx, void* ys, void* c, int b, int t_steps, int st,
                 int h, int wd, int f, int kh, int kw, int fs, int th, int tw, int cw, int rps,
                 int train, int per_member, cudaStream_t s) {
  Args<T> a{nullptr, static_cast<const T*>(wh), nullptr, static_cast<T*>(zx),
            static_cast<T*>(ys), static_cast<T*>(c), t_steps, st, h, wd, 0, f, kh, kw,
            th, tw, cw, rps, 0, 0, per_member};
  return launch_fs<T, true>(a, b, fs, train, s);
}

}  // namespace

// The layer's first launch: zx = conv_same(x, wx) + bx over all B*T frames
// into zx ([B, T, H, W, 4F]: zs in training, a scratch in inference), and
// the gates of t = 0 into ys[:, 0] and c (training: cs [B, T, H, W, F];
// inference: a [B, H, W, F] scratch). dtype: 0 float32, 1 bfloat16 (every
// tensor). The plan comes from the wrapper: fs (8 or 16 output channels a
// block), the th x tw pixel tile (at most 256 pixels at fs 8, 128 at fs
// 16), cw (4 or 8 source channels a chunk) and rps (1 or kh tap rows a
// stage). per_member: the member mode's samples a member (wx, bx and wh
// stacked [b / per_member, ...]; b for one layer's weights). Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// shape or plan the kernel does not take); does not synchronise.
extern "C" int dl4ds_convlstm_input(int dtype, const void* x, const void* wx, const void* bx,
                                    void* zx, void* ys, void* c, int b, int t_steps, int h,
                                    int wd, int cin, int f, int kh, int kw, int fs, int th,
                                    int tw, int cw, int rps, int train, int per_member,
                                    void* stream) {
  if (b < 1 || t_steps < 1 || h < 1 || wd < 1 || cin < 1 || per_member < 1 ||
      b % per_member)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)input<float>(x, wx, bx, zx, ys, c, b, t_steps, h, wd, cin, f, kh, kw, fs, th,
                             tw, cw, rps, train, per_member, s);
  if (dtype == 1)
    return (int)input<bf16>(x, wx, bx, zx, ys, c, b, t_steps, h, wd, cin, f, kh, kw, fs, th,
                            tw, cw, rps, train, per_member, s);
  return (int)cudaErrorInvalidValue;
}

// Time step `step` (1 <= step < T) of the layer, after the input launch and
// the steps before it on the same stream: z = zx[:, step] +
// conv_same(ys[:, step-1], wh) (written back to zx in training), then the
// gates into ys[:, step] and c. Arguments as dl4ds_convlstm_input's.
extern "C" int dl4ds_convlstm_step(int dtype, const void* wh, void* zx, void* ys, void* c,
                                   int b, int t_steps, int st, int h, int wd, int f, int kh,
                                   int kw, int fs, int th, int tw, int cw, int rps, int train,
                                   int per_member, void* stream) {
  if (b < 1 || st < 1 || st >= t_steps || h < 1 || wd < 1 || per_member < 1 ||
      b % per_member)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)step<float>(wh, zx, ys, c, b, t_steps, st, h, wd, f, kh, kw, fs, th, tw, cw,
                            rps, train, per_member, s);
  if (dtype == 1)
    return (int)step<bf16>(wh, zx, ys, c, b, t_steps, st, h, wd, f, kh, kw, fs, th, tw, cw,
                           rps, train, per_member, s);
  return (int)cudaErrorInvalidValue;
}

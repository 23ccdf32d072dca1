// ConvLSTM BPTT weight gradients (K3's T-parallel half) for NVIDIA Hopper
// (sm_90a). K3, the 'fused' backward route, is T chain-step launches and a
// dx launch of the tile in csrc/convlstm_seq.cu, then the two passes and the
// reduction here.
//
// From dz, the gradient of every step's pre-activations (the chain's dzs
// [B, T, H, W, 4F], gates i, f, c, o along 4F), and the layer's inputs:
//   dwx[dy, dx, c, g] = sum_p x_pad[p + (dy - ph, dx - pw), c] dz[p, g]
//   dwh   = the same with h_{t-1} (ys one step back; t = 0 adds nothing)
//   dbx   = sum_p dz[p, :]
// over all B*T frames (B*(T-1) for dwh), HWIO kernels. Layouts as in
// csrc/convlstm.cu. No atomics: two runs give the same bits. In bfloat16
// the source and dz are bfloat16, the k-steps 16 pixels of one mma.sync
// m16n8k16 (csrc/bf16_mma.cuh), the partials float32 and the fixed-order
// reduction rounds each sum once to bfloat16, as dwx.astype(wx_sd.dtype)
// rounds JAX's (pallas_convlstm.py:1001-1002).
//
// Replaces: dl4ds_tpu/ops/pallas_convlstm.py `_backward_pallas` ->
// `_bwd_kernel` (:335): its band-matrix weight gradients as T-batched
// matmuls and the per-tile gradient partials summed after the call (:647).
// The band matrices are the TPU's layout and are not reproduced.
//
// Bound: operations. Each pass is a GEMM of M = kh*kw*C rows (tap,
// channel), N = 4F gate columns and K = the pixels: 2*B*T*H*W*kh*kw*Cin*4F
// flops for dWx, 2*B*(T-1)*H*W*kh*kw*F*4F for dWh. For the recresnet_spc x4
// training step (batch 128, T 4, 16x16, F 8) the six layers' passes need
// 10.5 GFLOP: 0.16 ms at 67 TFLOP/s of float32 FMA, 0.06 ms at the 165
// TFLOP/s of 3xTF32.
//
// Design, a split-K GEMM on the tensor cores (dl4ds_convlstm_wgrad):
//   - A block takes `tpb` consecutive pixel tiles (a 16x16 frame is one 256-
//     pixel tile) in a fixed order and, by grid.y, one chunk of cwc source
//     channels (8, fewer when C < 8, 4 when kh*kw*8 rows would pass 255)
//     with up to tpc taps, and 32 gate columns: a block row (tap, channel)
//     of at most 255 rows, and with the Wx pass's first chunk one more row
//     of ones, whose product with dz is db.
//   - Per tile it stages the source with its halo as [pixel][4 or 8
//     channels] and dz as [pixel][32 columns] (row stride 40: conflict-free
//     B fragments), both double-buffered with cp.async, the next tile
//     loading while this one computes.
//   - A warp owns 2 m16 row tiles x the 4 n8 column tiles; the A fragment
//     of row (tap, c) and pixel k is the staged source at pixel k's offset
//     plus the tap's, read through a per-pixel offset table. Where the rows
//     leave warps over (3x3 or a single source channel), the warps split
//     the tile's 8-pixel k-steps round robin and their sums are added in
//     shared memory in a fixed order at the end.
//   - 3xTF32 mma.sync m16n8k8 from csrc/tf32_mma.cuh, the partial
//     accumulators added in float32 every 4 k-steps (32 pixels).
//   - Each block writes its float32 partial row; dl4ds_convlstm_wgrad_reduce
//     then sums the rows of both passes in a fixed order.
// The plan (ops/convlstm.py `_wgrad_plan`) picks tpb so that the blocks of
// a pass make about one wave of two blocks an SM.
//
// The member mode (a deep ensemble's M members in one launch): the source
// and dz hold M members of b samples in turn, and the gradients are M
// stacks. Each member's tiles are cut into chunks of its own, `tpb` tiles
// from the plan of a b-sample call, so no chunk straddles two members: the
// grid is M times the chunks of one member, block x summing tiles of member
// x / chunks. The reduction sums each member's partial rows, in order, into
// its own [M, ...] gradients. The partials and sums are those of M
// one-member calls: the same bits. One layer's call is M = 1.
//
// Measured (tools/torch_chain_probe.py and chip_smoke.py phase 6's split of
// K3 by launch kind; NVIDIA H100 80GB HBM3, 700.00 W): at batch 128, T 4,
// 16x16 and F = 8 the Wx and Wh passes take 65 and 63 us at 5x5 (26
// TFLOP/s), 42 and 41 us at 3x3; the six width-8 layers' passes 0.54 ms and
// their reductions 0.06 ms, where the float32 FMA pass this replaced took
// 0.93 ms (torch_train_profile.py). K3 as a whole, chain and dx included,
// takes 1.64-1.66 ms for the six layers against 2.72-2.73 ms before,
// bounds 0.311 ms (float32) and 0.126 ms (3xTF32).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "smem_attr.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kWN = 32;                // gate columns of a block
constexpr int kGS = 40;                // staged dz row stride (32 + 8)
constexpr int kMaxRows = 256;          // block rows, the db row included
constexpr int kMaxPix = 256;           // pixels of a tile
constexpr int kFlush = 4;              // k-steps a partial accumulator takes
constexpr int kMaxSmem = 227 * 1024;

template <typename T>
struct WArgs {
  const T* src;   // x [B, T, H, W, C] or ys (h_{t-1}: t_skip 1)
  const T* dzs;   // [B, T, H, W, 4F]
  float* part;    // [grid.x, part_len]
  int64_t part_len;
  int with_db, t_steps, t_skip, h, wd, cs, f4, kh, kw, tph, tpw, tiles_x,
      tiles_frame, n_tiles, tpb, cwc, tpc, n_cchunks, n_rchunks, scs, groups,
      kgroups, ppad;
  int chunks;     // blocks (grid.x) a member; n_tiles is a member's tiles
};

// A block: grid.x = pixel chunks (tpb tiles each, `chunks` a member),
// grid.y = source-channel
// chunks x tap chunks x gate chunks. It writes part[blockIdx.x][(tap * cs
// + c) * f4 + g] for its rows and 32 gate columns; with_db, the blocks of
// the first channel and tap chunk also write sum_p dz[p, g] at
// part[blockIdx.x][kh*kw*cs*f4 + g]. T float: 3xTF32 k-steps of 8 pixels;
// T bf16: bfloat16 k-steps of 16 (ppad a multiple of 16), float32 partials.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) wgrad_tile(const WArgs<T> a) {
  constexpr bool BF = kIsBf16<T>;
  constexpr int KS = BF ? 16 : 8;
  extern __shared__ float4 smem4[];
  const int SW = a.tpw + a.kw - 1;
  const int src_len = (a.tph + a.kh - 1) * SW * a.scs;
  const int P = a.tph * a.tpw, PP = a.ppad;
  T* src_s = reinterpret_cast<T*>(smem4);                     // [2][src_len]
  T* dz_s = src_s + 2 * src_len;                              // [2][PP][kGS]
  int* pof_s = reinterpret_cast<int*>(dz_s + 2 * PP * kGS);   // [PP]

  const int cchunk = blockIdx.y % a.n_cchunks;
  const int rchunk = (blockIdx.y / a.n_cchunks) % a.n_rchunks;
  const int gchunk = blockIdx.y / (a.n_cchunks * a.n_rchunks);
  const int c0 = cchunk * a.cwc, cc = min(a.cwc, a.cs - c0);
  const int tap0 = rchunk * a.tpc, ntap = min(a.tpc, a.kh * a.kw - tap0);
  const int g0 = gchunk * kWN, gn = min(kWN, a.f4 - g0);
  const bool db_block = a.with_db && cchunk == 0 && rchunk == 0;
  const int nrow = ntap * a.cwc;         // (tap, channel) rows, then db's
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int mg = warp % a.groups, kg = warp / a.groups;
  const bool active = kg < a.kgroups;
  const int ph = a.kh / 2, pw = a.kw / 2;
  const int64_t hw = (int64_t)a.h * a.wd;
  const bool vec_src = a.cs % 4 == 0 && a.cwc % 4 == 0;

  // this thread's fragment rows: the staged offset of (tap, channel), and
  // whether the row reads the source (else 1 for the db row, 0 past the
  // rows or the chunk's channels)
  int roff[2][2];
  bool ld[2][2];
  float alt[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = (mg * 2 + mt) * 16 + gq + 8 * hf;
      const int tl = m / a.cwc, c = m - tl * a.cwc;
      const int tap = tap0 + tl, dy = tap / a.kw;
      ld[mt][hf] = m < nrow && c < cc;
      alt[mt][hf] = db_block && m == nrow ? 1.f : 0.f;
      roff[mt][hf] = ld[mt][hf] ? (dy * SW + tap - dy * a.kw) * a.scs + c : 0;
    }
  // pixel p of a tile -> its staged offset (padded pixels read pixel 0,
  // their dz rows are zero); zero dz rows past the tile and columns past gn
  for (int p = tid; p < PP; p += kThreads)
    pof_s[p] = p < P ? ((p / a.tpw) * SW + p % a.tpw) * a.scs : 0;
  for (int i = tid; i < 2 * PP * kWN; i += kThreads) {
    const int p = (i / kWN) % PP, g = i % kWN;
    if (p >= P || g >= gn) dz_s[(i / kWN) * kGS + g] = from_f<T>(0.f);
  }

  // tile it of the frames used (frame it / tiles_frame, t = t_skip .. T-1
  // of every sample; the source frame is t - t_skip) into buffer buf
  auto stage = [&](int it, int buf) {
    const int frames = a.t_steps - a.t_skip;
    const int fi = it / a.tiles_frame, tile = it - fi * a.tiles_frame;
    const int bb = fi / frames;
    const int64_t dframe = (int64_t)bb * a.t_steps + (fi - bb * frames) + a.t_skip;
    const int64_t sframe = dframe - a.t_skip;
    const int y0 = (tile / a.tiles_x) * a.tph, x0 = (tile % a.tiles_x) * a.tpw;
    T* ss = src_s + buf * src_len;
    const T* sb = a.src + sframe * hw * a.cs + c0;
    const int nv = vec_src ? 4 : 1;
    for (int i = tid; i < src_len / a.scs * cc / nv; i += kThreads) {
      const int e = i * nv;
      const int p = e / cc, ci = e - p * cc;
      const int r = p / SW;
      const int yy = y0 - ph + r, xx = x0 - pw + p - r * SW;
      const bool ok = yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd;
      const T* sp = sb + ((int64_t)yy * a.wd + xx) * a.cs + ci;
      copy_elems<T>(ss + p * a.scs + ci, ok ? sp : a.src, nv, ok);
    }
    T* ds = dz_s + buf * PP * kGS;
    const T* db = a.dzs + dframe * hw * a.f4 + g0;
    for (int i = tid; i < P * gn / 4; i += kThreads) {
      const int e = i * 4;
      const int p = e / gn, g = e - p * gn;
      const int r = p / a.tpw;
      const int y = y0 + r, x = x0 + p - r * a.tpw;
      const bool ok = y < a.h && x < a.wd;
      copy_elems<T>(ds + p * kGS + g, ok ? db + ((int64_t)y * a.wd + x) * a.f4 + g : a.dzs, 4,
                    ok);
    }
  };

  // the A value of fragment row (mt, hf) at staged pixel offset q
  auto aval = [&](const T* ss, int mt, int hf, int q) {
    return ld[mt][hf] ? ss[roff[mt][hf] + q] : from_f<T>(alt[mt][hf]);
  };

  // accumulators [m tile][n tile][fragment value]: value i is row (mg*2 +
  // mt)*16 + gq + 8 * (i >> 1), column g0 + j*8 + 2*tq + (i & 1)
  float acc[2][4][4] = {};
  const int ksteps = PP / KS;
  // this block's tiles: chunk x % chunks of member x / chunks
  const int member = blockIdx.x / a.chunks;
  const int first = member * a.n_tiles;
  const int it0 = first + (blockIdx.x - member * a.chunks) * a.tpb;
  const int it_end = min(first + a.n_tiles, it0 + a.tpb);
  stage(it0, 0);
  cp_async_commit();
  for (int it = it0; it < it_end; ++it) {
    const int buf = (it - it0) & 1;
    if (it + 1 < it_end) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (active) {
      const T* ss = src_s + buf * src_len;
      const T* ds = dz_s + buf * PP * kGS + gq;
      float part[2][4][4] = {};
      int n_part = 0;
#pragma unroll 1
      for (int ks = kg; ks < ksteps; ks += a.kgroups) {
        const int p0 = ks * KS;
        if constexpr (BF) {
          // pixels 2tq, 2tq+1 (a0, a1, b0) and 2tq+8, 2tq+9 (a2, a3, b1)
          const int q0 = pof_s[p0 + 2 * tq], q1 = pof_s[p0 + 2 * tq + 1];
          const int q2 = pof_s[p0 + 2 * tq + 8], q3 = pof_s[p0 + 2 * tq + 9];
          uint32_t aa[2][4], bb[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            aa[mt][0] = pack_bf16(aval(ss, mt, 0, q0), aval(ss, mt, 0, q1));
            aa[mt][1] = pack_bf16(aval(ss, mt, 1, q0), aval(ss, mt, 1, q1));
            aa[mt][2] = pack_bf16(aval(ss, mt, 0, q2), aval(ss, mt, 0, q3));
            aa[mt][3] = pack_bf16(aval(ss, mt, 1, q2), aval(ss, mt, 1, q3));
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const T* dc = ds + j * 8;
            bb[j][0] = pack_bf16(dc[(p0 + 2 * tq) * kGS], dc[(p0 + 2 * tq + 1) * kGS]);
            bb[j][1] = pack_bf16(dc[(p0 + 2 * tq + 8) * kGS], dc[(p0 + 2 * tq + 9) * kGS]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(part[mt][j], aa[mt], bb[j][0], bb[j][1]);
        } else {
          const int q0 = pof_s[p0 + tq], q1 = pof_s[p0 + tq + 4];
          uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            split_tf32(to_f(aval(ss, mt, 0, q0)), ah[mt][0], al[mt][0]);
            split_tf32(to_f(aval(ss, mt, 1, q0)), ah[mt][1], al[mt][1]);
            split_tf32(to_f(aval(ss, mt, 0, q1)), ah[mt][2], al[mt][2]);
            split_tf32(to_f(aval(ss, mt, 1, q1)), ah[mt][3], al[mt][3]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            split_tf32(to_f(ds[(p0 + tq) * kGS + j * 8]), bh[j][0], bl[j][0]);
            split_tf32(to_f(ds[(p0 + tq + 4) * kGS + j * 8]), bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(part[mt][j], ah[mt], bl[j][0], bl[j][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(part[mt][j], al[mt], bh[j][0], bh[j][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_tf32(part[mt][j], ah[mt], bh[j][0], bh[j][1]);
        }
        if (++n_part == kFlush) {
          n_part = 0;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[mt][j][i] += part[mt][j][i];
                part[mt][j][i] = 0.f;
              }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][j][i] += part[mt][j][i];
    }
    __syncthreads();   // this tile's buffers may be refilled
  }

  // the k-step groups' sums, added in a fixed order through shared memory
  // ([group][value][lane]: conflict-free)
  cp_async_wait_all();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem4);
  if (active && kg > 0) {
    float* rp = red + ((kg - 1) * a.groups + mg) * 32 * 32 + lane;
#pragma unroll
    for (int v = 0; v < 32; ++v) rp[v * 32] = acc[v >> 4][(v >> 2) & 3][v & 3];
  }
  __syncthreads();
  if (!active || kg > 0) return;
  for (int k = 1; k < a.kgroups; ++k) {
    const float* rp = red + ((k - 1) * a.groups + mg) * 32 * 32 + lane;
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[v >> 4][(v >> 2) & 3][v & 3] += rp[v * 32];
  }

  float* pp = a.part + (int64_t)blockIdx.x * a.part_len;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = (mg * 2 + mt) * 16 + gq + 8 * (i >> 1);
        const int g = j * 8 + 2 * tq + (i & 1);
        if (g >= gn) continue;
        const int tl = m / a.cwc, c = m - tl * a.cwc;
        if (m < nrow && c < cc)
          pp[((int64_t)(tap0 + tl) * a.cs + c0 + c) * a.f4 + g0 + g] = acc[mt][j][i];
        else if (db_block && m == nrow)
          pp[(int64_t)a.kh * a.kw * a.cs * a.f4 + g0 + g] = acc[mt][j][i];
      }
}

// Row sums in a fixed order: oa[k] = sum_r pa[r * la + k] for k < la, then
// the same for (pb, nb, lb, ob), written in O (float32, or bfloat16 rounded
// once). nb may be 0 (then ob is zero). grid.y: the member, whose na (nb)
// rows and la (lb) sums follow the members before it.
template <typename O>
__global__ void __launch_bounds__(256)
wgrad_reduce(const float* __restrict__ pa, int na, int64_t la, O* __restrict__ oa,
             const float* __restrict__ pb, int nb, int64_t lb, O* __restrict__ ob) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t m = blockIdx.y;
  pa += m * na * la;
  oa += m * la;
  pb += m * nb * lb;
  ob += m * lb;
  const float* p = pa;
  int n = na;
  int64_t l = la, k = i;
  O* o = oa;
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
  o[k] = from_f<O>(s);
}

template <typename T>
cudaError_t wgrad(const void* src, const void* dzs, float* part, int n_chunks, int with_db,
                  int b, int t_steps, int t_skip, int h, int wd, int cs, int f, int kh, int kw,
                  int tph, int tpw, int tpb, int cwc, int tpc, int members,
                  cudaStream_t stream) {
  constexpr int KS = kIsBf16<T> ? 16 : 8;
  const int f4 = 4 * f;
  if (members < 1 || b < 1 || t_skip < 0 || t_steps <= t_skip || h < 1 || wd < 1 || cs < 1 ||
      f < 1 || kh < 1 || kw < 1 || tph < 1 || tpw < 1 || tph * tpw > kMaxPix ||
      tpb < 1 || cwc < 1 || cwc > 8 || tpc < 1 || tpc * cwc + (with_db ? 1 : 0) > kMaxRows)
    return cudaErrorInvalidValue;
  const int tiles_x = (wd + tpw - 1) / tpw;
  const int tiles_frame = tiles_x * ((h + tph - 1) / tph);
  const int64_t n_tiles = (int64_t)b * (t_steps - t_skip) * tiles_frame;
  if (n_tiles * members > INT32_MAX || (n_tiles + tpb - 1) / tpb != n_chunks ||
      (int64_t)n_chunks * members > INT32_MAX)
    return cudaErrorInvalidValue;
  const int n_cchunks = (cs + cwc - 1) / cwc;
  const int n_rchunks = (kh * kw + tpc - 1) / tpc;
  const int64_t grid_y = (int64_t)n_cchunks * n_rchunks * ((f4 + kWN - 1) / kWN);
  if (grid_y > 65535) return cudaErrorInvalidValue;
  const int rows = tpc * cwc + (with_db ? 1 : 0);
  const int groups = ((rows + 15) / 16 + 1) / 2;    // warps of 2 m16 tiles
  const int kgroups = 8 / groups;
  const int scs = cwc <= 4 ? 4 : 8;
  const int ppad = (tph * tpw + KS - 1) / KS * KS;
  const int staged = (int)sizeof(T) * (2 * (tph + kh - 1) * (tpw + kw - 1) * scs +
                                       2 * ppad * kGS) + 4 * ppad;
  const int shmem = max(staged, 4 * (kgroups - 1) * groups * 32 * 32);
  if (shmem > kMaxSmem) return cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    const cudaError_t err = dl4ds::reserve_smem(wgrad_tile<T>, (size_t)shmem);
    if (err != cudaSuccess) return err;
  }
  const WArgs<T> a{static_cast<const T*>(src), static_cast<const T*>(dzs), part,
                   (int64_t)kh * kw * cs * f4 + (with_db ? f4 : 0), with_db, t_steps, t_skip,
                   h, wd, cs, f4, kh, kw, tph, tpw, tiles_x, tiles_frame, (int)n_tiles, tpb,
                   cwc, tpc, n_cchunks, n_rchunks, scs, groups, kgroups, ppad, n_chunks};
  wgrad_tile<T><<<dim3((unsigned)(n_chunks * members), (unsigned)grid_y), kThreads, shmem,
                  stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Partial weight gradients of the source src [members * b, T, H, W, cs] (x
// with t_skip 0, ys with t_skip 1) against dzs [members * b, T, H, W, 4F],
// over pixel tiles of tph x tpw (at most 256 pixels), `tpb` tiles a block,
// in chunks of cwc source channels (1 to 8) and tpc taps (tpc * cwc +
// with_db at most 256 rows); part is [members * n_chunks, part_len] float32
// with part_len = kh*kw*cs*4F (+ 4F with_db), member m's rows from m *
// n_chunks. dtype: 0 float32, 1 bfloat16 (src and dzs). n_chunks must be
// the number of blocks that this plan gives a member of b samples
// (checked). The plan comes from ops/convlstm.py `_wgrad_plan`. Returns
// the cudaError_t of the launch; does not synchronise.
extern "C" int dl4ds_convlstm_wgrad(int dtype, const void* src, const void* dzs, float* part,
                                    int n_chunks, int with_db, int b, int t_steps, int t_skip,
                                    int h, int wd, int cs, int f, int kh, int kw, int tph,
                                    int tpw, int tpb, int cwc, int tpc, int members,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)wgrad<float>(src, dzs, part, n_chunks, with_db, b, t_steps, t_skip, h, wd, cs,
                             f, kh, kw, tph, tpw, tpb, cwc, tpc, members, s);
  if (dtype == 1)
    return (int)wgrad<bf16>(src, dzs, part, n_chunks, with_db, b, t_steps, t_skip, h, wd, cs,
                            f, kh, kw, tph, tpw, tpb, cwc, tpc, members, s);
  return (int)cudaErrorInvalidValue;
}

// For each of `members` members m: oa [m, la] = the sum of its na rows of
// pa [members, na, la] and ob [m, lb] that of its nb rows of pb, each row
// after row in order; written as float32 (dtype 0) or rounded once to
// bfloat16 (dtype 1).
extern "C" int dl4ds_convlstm_wgrad_reduce(int dtype, const float* pa, int na, int64_t la,
                                           void* oa, const float* pb, int nb, int64_t lb,
                                           void* ob, int members, void* stream) {
  const int64_t n = la + lb;
  if (n < 1 || (n + 255) / 256 > INT32_MAX || (dtype != 0 && dtype != 1) || members < 1 ||
      members > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + 255) / 256), (unsigned)members);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    wgrad_reduce<float><<<grid, 256, 0, s>>>(pa, na, la, static_cast<float*>(oa), pb, nb, lb,
                                             static_cast<float*>(ob));
  else
    wgrad_reduce<bf16><<<grid, 256, 0, s>>>(pa, na, la, static_cast<bf16*>(oa), pb, nb, lb,
                                            static_cast<bf16*>(ob));
  return (int)cudaGetLastError();
}

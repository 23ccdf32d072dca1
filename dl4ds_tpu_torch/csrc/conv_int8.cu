// K7: the int8 convolution of the port's post-training quantization
// (dl4ds_tpu_torch/quantization.py), for NVIDIA Hopper (sm_90a): one launch
// computes a whole int8 site. It takes the place of the JAX package's int8
// replay at a site (dl4ds_tpu/quantization.py:276-282): the activation's
// quantization, XLA's s8 x s8 -> s32 convolution and the rescale, with
// Flax's bias add after them; no Pallas kernel computes it.
//
//   x_q = clamp(rint(fdiv_rn(float(x_site), s_x)), -127, 127)
//   y[b, oy, ox, co] = out_type(float(sum_{ky, kx, ci} x_q[b, iy, ix, ci] *
//                                     w[co, ky, kx, ci]) * scale[co])
//                      (+ bias[co], added in float and rounded once)
//
// x is the site's NHWC input (channel stride 1, any other strides): float32
// or bfloat16, quantized here at the per-tensor scale s_x read from device
// memory (x_site = x rounded to bfloat16 first where a float32 x enters a
// bfloat16 site), or int8 codes, taken as they are (the checks' form). w is
// the int8 weight packed once at quantization time (ops/conv_int8.py
// `pack_weight`), scale[co] = s_x * s_w[co] in float32 (the JAX package's
// `_requant_scale`), out_type float32, bfloat16 (round to nearest even) or
// int32 (the raw sums: the checks' form, no bias). The sum is exact in
// int32. The geometry is a correlation with `stride`, four paddings and an
// input dilation `dil` (the port's `ConvTranspose`: a transposed
// convolution is the correlation of the dilated, padded input with the
// unflipped kernel, as `lax.conv_transpose` lowers it).
//
// What bounds it: the flagship's sites do well under 300 int8 operations a
// byte of float x and y, so the card's 3.35 TB/s and not its 1,979 int8
// TOP/s set their floor, and the design is about bytes; the widest sites
// of a width-64 model (Cin 384, Co 1536) sit near the balance. Dense
// (groups 1):
//
// * A block of 8 warps owns an output tile of 8 x 16 pixels; its warps take
//   32 pixels (two m16 tiles) by nb / 2 channels of a column block of nb
//   <= 128 with mma.sync m16n8k32 s8 (s8_mma.cuh), and run every column
//   block of the site in turn over the tile. Blocks are persistent: each
//   keeps one output phase and walks the tiles, so that neighbouring blocks
//   work on neighbouring tiles and share their halos in L2.
// * The tile's input window (halo included) arrives once, in channel
//   chunks of cc, through a ring of 2 to 4 stages (more while they are
//   small): a TMA 4-D tiled box over NHWC whose out-of-bounds fill is the
//   padding's zeros, completing on an mbarrier; where TMA's 16-byte rule
//   fails (Cin 1 or 2 in float32, narrow bfloat16 or int8 widths) cp.async,
//   zero-filled, into the same ring; plain loads only where no 4-byte unit
//   divides the pixel. Later items' copies run while this one is quantized
//   and multiplied.
// * Each chunk is quantized once, in shared memory, into an int8 window of
//   every chunk; the A fragments of every tap are shifted views of it (a
//   table of byte offsets per k quad, and ldmatrix rows where 16 k of a
//   pixel lie in one tap), so taps share a 32-wide k step when Cin < 32 and
//   the input is read from device memory about once, not kh * kw times, and
//   quantized once, not once a column block.
// * A site's packed weight stays resident in shared memory where it fits
//   (one chunk, at most 96 KB); else each item's stage carries the slice of
//   its column block and chunk.
// * The epilogue applies scale, the cast and the bias (float multiply and
//   add rounded apart, no contraction; a bfloat16 bias add in float,
//   rounded once, as PyTorch's), stages the tile in shared memory (the
//   spent stage, or a region of its own) and writes whole pixels with
//   16-byte stores where the widths allow; where no shared memory is left
//   (the widest sites) lanes store pairs of channels from the registers.
// * A transposed site (dil > 1) splits into dil x dil output phases; each
//   runs only the taps that land on real input pixels, a residue class of
//   the kernel that `pack_weight` packs apart (the sub-pixel form of
//   `lax.conv_transpose`): the same sums without the dilation's zeros.
//
// Depthwise (groups = Cin = Co, the ConvNeXt block's 7x7): an integer loop,
// one thread an output value, quantizing as it loads and adding the bias as
// it stores, so that site is one launch too.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "s8_mma.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps: 4 along pixels x 2 along channels
constexpr int kTH = 8, kTW = 16;        // an output tile, in phase space
constexpr int kBM = kTH * kTW;          // 128 pixels
constexpr int kDwThreads = 256;
constexpr int kMaxSmem = 232448;        // the H100's per-block opt-in limit
constexpr int kResident = 98304;        // a weight kept whole in shared memory, at most
constexpr int kRing = 65536;            // the ring's bytes, up to which it takes 3 or 4 stages

long long g_launched = 0;

struct Geo {
  int batch, h, w, cin;
  long long sb, sh, sw;      // x strides in elements; the channel stride is 1
  int ho, wo, co;
  int kh, kw, stride, dil, pad_t, pad_l;
  // the plan (ops/conv_int8.py `_layout`): channel chunk, chunks, a chunk's
  // packed k extent, column block, padded rows of a class
  int cc, n_chunks, kcp, nb, co_pad;
  // derived on the host (`derive`)
  int khc, kwc, wh, ww, pitch, ncb, n_cfg, bpc, resident;   // n_cfg: output phases
  int load;                  // 3 TMA over (w c), 2 TMA, 1 cp.async of `unit` bytes, 0 plain
  int srow;                  // stage elements a window row (3: the flat box's row; else ww * cc)
  int ys_direct;             // the staged tile fits no shared memory: stored from registers
  int ldsm;                  // cc a multiple of 16: A and B fragments by ldmatrix
  int nst;                   // stages of the ring, 2 to 4
  int unit, round_bf16;
  unsigned box_bytes, xs_stride, ws_bytes, ws_stride, xq_off, tab_off, ys_off, smem;
  int ypitch;                // staged output elements a pixel
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(v);
  else
    return (float)v;
}

template <typename T>
__device__ __forceinline__ T zero() {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __float2bfloat16_rn(0.f);
  else
    return T(0);
}

// the code of one input value: x_site / s_x rounded half to even, clamped
template <typename XT>
__device__ __forceinline__ int quantize(XT v, float s, bool round_bf16) {
  if constexpr (std::is_same<XT, int8_t>::value) {
    return v;
  } else {
    float f = to_float(v);
    if (round_bf16) f = __bfloat162float(__float2bfloat16_rn(f));
    // clamped, then rounded half to even: the same as rounded, then clamped
    return __float2int_rn(fminf(fmaxf(__fdiv_rn(f, s), -127.f), 127.f));
  }
}

// four consecutive values from an address aligned to four of them
template <typename T>
__device__ __forceinline__ void load4(T (&q)[4], const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    q[0] = v.x, q[1] = v.y, q[2] = v.z, q[3] = v.w;
  } else if constexpr (sizeof(T) == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const T* h = reinterpret_cast<const T*>(&v);
    q[0] = h[0], q[1] = h[1], q[2] = h[2], q[3] = h[3];
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    const T* h = reinterpret_cast<const T*>(&v);
    q[0] = h[0], q[1] = h[1], q[2] = h[2], q[3] = h[3];
  }
}

// four 8x16-byte matrices from shared memory, a row address a lane (lanes
// 8j..8j+7 the rows of matrix j); lane t receives in r[j] the 4 bytes at
// row t / 4, byte 4 (t % 4) of matrix j: an mma.sync s8 A or B fragment
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ uint32_t pack4(int v0, int v1, int v2, int v3) {
  return pack_s8((int8_t)v0, (int8_t)v1, (int8_t)v2, (int8_t)v3);
}

// one output value: scale, cast, then the bias b in the output type
__device__ __forceinline__ float finish(int acc, float s, bool has_bias, float b) {
  const float v = __fmul_rn(__int2float_rn(acc), s);
  return has_bias ? __fadd_rn(v, b) : v;
}
__device__ __forceinline__ __nv_bfloat16 finish(int acc, float s, bool has_bias,
                                                __nv_bfloat16 b) {
  const __nv_bfloat16 v = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), s));
  if (!has_bias) return v;
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(v), __bfloat162float(b)));
}
__device__ __forceinline__ int finish(int acc, float, bool, int) { return acc; }

// two neighbouring values in one store (the address aligned to two)
template <typename T>
__device__ __forceinline__ void store2(T* p, T a, T b) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                              *reinterpret_cast<const uint32_t*>(&b));
  } else {
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(&a);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(&b);
    *reinterpret_cast<uint32_t*>(p) = lo | (hi << 16);
  }
}

// ---------------------------------------------------------------------------
// the ring: TMA, cp.async or plain loads of one item's window (and chunk
// weight slice) into a stage
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, bool valid) {
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the first element of a flat box: the window's first (w, c) element taken
// down to 16 bytes (TMA starts a row on a 16-byte boundary)
template <typename XT>
__device__ __forceinline__ int flat_start(int first) {
  constexpr int q = 16 / (int)sizeof(XT);
  return first >= 0 ? first / q * q : -((-first + q - 1) / q) * q;
}

// where an item lies: its tile's batch index and window origin, its column
// block and channel chunk; the window's chunk arrives with the tile's first
// column block only
struct Item {
  int b, qy0, qx0, cb, chunk;
};

template <typename XT>
__device__ __forceinline__ void issue(const Geo& g, const CUtensorMap* tmap, const XT* x,
                                      const int8_t* wcls, unsigned char* xs, int8_t* ws,
                                      uint32_t bar, const Item& it, int off_y, int off_x) {
  constexpr int e = (int)sizeof(XT);
  const int iy0 = it.qy0 * g.stride + off_y, ix0 = it.qx0 * g.stride + off_x;
  const int c0 = it.chunk * g.cc;
  if (it.cb != 0) {
    // the window is already quantized: no copy
  } else if (g.load >= 2) {
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(g.box_bytes)
                   : "memory");
      if (g.load == 2)
        asm volatile(
            "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(xs)),
            "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(ix0), "r"(iy0), "r"(it.b),
            "r"(bar)
            : "memory");
      else   // rows of (w, c) flattened: a pixel's few channels under 16 bytes
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(xs)),
            "l"(reinterpret_cast<uint64_t>(tmap)), "r"(flat_start<XT>(ix0 * g.cin)), "r"(iy0),
            "r"(it.b), "r"(bar)
            : "memory");
    }
  } else {
    const int per = g.load == 1 ? g.unit / e : 1;        // channels a copy
    const int upx = (g.cc + per - 1) / per;              // copies a pixel
    const int n = g.wh * g.ww * upx;
    const XT* xb = x + (long long)it.b * g.sb;
#pragma unroll 1
    for (int u = threadIdx.x; u < n; u += kThreads) {
      const int pix = u / upx, part = u - pix * upx;
      const int r = pix / g.ww, c = pix - r * g.ww;
      const int iy = iy0 + r, ix = ix0 + c, ch = c0 + part * per;
      if (ch >= g.cin) continue;     // past Cin: the quantize pass writes 0
      const bool ok = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      const XT* src = ok ? xb + iy * g.sh + ix * g.sw + ch : x;
      XT* dst = reinterpret_cast<XT*>(xs) + pix * g.cc + part * per;
      if (g.load == 1)
        cp_async(dst, src, g.unit, ok);
      else
        *dst = ok ? *src : zero<XT>();
    }
  }
  if (!g.resident) {   // this column block's chunk of the weight: nb rows of kcp bytes
    const int per_row = g.kcp / 16;
    const long long k_all = (long long)g.n_chunks * g.kcp;
    const int8_t* src0 = wcls + (long long)it.cb * g.nb * k_all + (long long)it.chunk * g.kcp;
    int n = threadIdx.x / per_row, part = threadIdx.x - n * per_row;
    const int sn = kThreads / per_row, sp = kThreads - sn * per_row;
#pragma unroll 1
    for (; n < g.nb; n += sn, part += sp) {
      if (part >= per_row) {
        part -= per_row;
        if (++n >= g.nb) break;
      }
      cp_async(ws + n * g.ws_stride + part * 16, src0 + n * k_all + part * 16, 16, true);
    }
  }
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// dense
// ---------------------------------------------------------------------------

// NTW: n8 tiles a warp, at least ceil(nb / 16); fewer keep the
// accumulators, and so the registers, small enough for several blocks an SM
template <int NTW>
constexpr int min_blocks() {
  return NTW == 1 ? 4 : NTW == 2 ? 3 : NTW == 4 ? 2 : 1;
}

template <typename XT, typename OT, int NTW>
__global__ void __launch_bounds__(kThreads, min_blocks<NTW>())
    conv_s8_dense(const __grid_constant__ CUtensorMap tmap, const XT* __restrict__ x,
                  const float* __restrict__ s_x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, const OT* __restrict__ bias,
                  OT* __restrict__ y, const Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int oe = (int)sizeof(OT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;       // 32 pixels, nb / 2 channels

  // this block's output phase (py, px)
  const int ph = blockIdx.x % g.n_cfg, jb = blockIdx.x / g.n_cfg;
  const int d = g.dil, py = ph / d, px = ph - py * d;
  int ry = 0, rx = 0, khc = g.kh, kwc = g.kw, off_y = -g.pad_t, off_x = -g.pad_l;
  int hq = g.ho, wq = g.wo;
  if (d > 1) {   // the kernel's residue class whose taps land on real pixels
    ry = ((g.pad_t - py) % d + d) % d;
    rx = ((g.pad_l - px) % d + d) % d;
    khc = ry < g.kh ? (g.kh - ry + d - 1) / d : 0;
    kwc = rx < g.kw ? (g.kw - rx + d - 1) / d : 0;
    off_y = (py + ry - g.pad_t) / d;     // exact: a multiple of d
    off_x = (px + rx - g.pad_l) / d;
    hq = py < g.ho ? (g.ho - py + d - 1) / d : 0;
    wq = px < g.wo ? (g.wo - px + d - 1) / d : 0;
  }
  const int tiles_y = (hq + kTH - 1) / kTH, tiles_x = (wq + kTW - 1) / kTW;
  const int n_tiles = g.batch * tiles_y * tiles_x;
  const int my_tiles = n_tiles > jb ? (n_tiles - jb + g.bpc - 1) / g.bpc : 0;
  const int per_tile = g.ncb * g.n_chunks;
  const int n_items = my_tiles * per_tile;
  if (n_items == 0) return;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* xs0 = smem + 128;
  int8_t* ws0 = reinterpret_cast<int8_t*>(xs0 + g.nst * g.xs_stride);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + g.xq_off);
  int* tab = reinterpret_cast<int*>(smem + g.tab_off);
  const long long k_all = (long long)g.n_chunks * g.kcp;
  const int8_t* wcls = w + (long long)(ry * d + rx) * g.co_pad * k_all;
  const float sx = s_x != nullptr ? *s_x : 1.f;

  // the byte offset in the int8 window of each k quad of a chunk; quads
  // past this class's taps meet zero weights and read offset 0
  const int taps = khc * kwc;
#pragma unroll 1
  for (int q = tid; q < g.kcp / 4; q += kThreads) {
    const int k = 4 * q, t = k / g.cc, ci = k - t * g.cc;
    int off = 0;
    if (t < taps) {
      const int i = t / kwc, j = t - i * kwc;
      off = (i * g.ww + j) * g.pitch + ci;
    }
    tab[q] = off;
  }
  if (tid == 0) {
    for (int s = 0; s < g.nst; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (g.resident) {   // the class's whole weight, every column block
    const int per_row = g.kcp / 16;
#pragma unroll 1
    for (int u = tid; u < g.co_pad * per_row; u += kThreads) {
      const int n = u / per_row, part = u - n * per_row;
      cp_async(ws0 + n * g.ws_stride + part * 16, wcls + (long long)n * g.kcp + part * 16, 16,
               true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  auto item = [&](int i) {
    const int tile = i / per_tile, r = i - tile * per_tile;
    const int t = jb + tile * g.bpc;
    Item it;
    it.cb = r / g.n_chunks;
    it.chunk = r - it.cb * g.n_chunks;
    const int per_b = tiles_y * tiles_x;
    it.b = t / per_b;
    const int rest = t - it.b * per_b;
    const int ty = rest / tiles_x;
    it.qy0 = ty * kTH;
    it.qx0 = (rest - ty * tiles_x) * kTW;
    return it;
  };
  auto stage_ws = [&](int s) { return g.resident ? ws0 : ws0 + s * g.ws_bytes; };

  // pixel bases of this thread's four A rows: pixel (2 wm + mt, gq + 8 h)
  int pb[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      pb[mt][hh] = ((2 * wm + mt) * g.stride * g.ww + (gq + 8 * hh) * g.stride) * g.pitch;
  // the ldmatrix row of this lane in each m16 tile
  int pa[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    pa[mt] = ((2 * wm + mt) * g.stride * g.ww + ((lane & 7) + 8 * ((lane >> 3) & 1)) * g.stride) *
             g.pitch;
  const int nbh = g.nb / 2;
  const int ks_n = (taps * g.cc + 31) / 32;
  const bool round_bf16 = g.round_bf16 != 0;
  // the quantize pass: four channels a unit, kThreads units a sweep
  const int qpp = (g.cc + 3) / 4, step_pix = kThreads / qpp, step_qd = kThreads - step_pix * qpp;
  const bool vec_q = g.cc % 4 == 0 && g.load != 3;

  int acc[2][NTW][4];
  uint32_t parity = 0;     // bit s: the phase of stage s's next window
  // the ring: item j in stage j % nst, nst - 1 items ahead of the one in use
  auto ahead = [&](int j) {
    if (j < n_items) {
      const int sj = j % g.nst;
      issue<XT>(g, &tmap, x, wcls, xs0 + sj * g.xs_stride, stage_ws(sj), smem_u32(bars + sj),
                item(j), off_y, off_x);
    } else {
      cp_async_commit();
    }
  };
  // one call site of `ahead`: the first nst - 1 turns only fill the ring
#pragma unroll 1
  for (int i = 1 - g.nst; i < n_items; ++i) {
    ahead(i + g.nst - 1);
    if (i < 0) continue;
    const int s = i % g.nst;
    const Item it = item(i);
    if (g.nst == 2)
      cp_async_wait<1>();
    else if (g.nst == 3)
      cp_async_wait<2>();
    else
      cp_async_wait<3>();
    if (g.load >= 2 && it.cb == 0) {
      mbar_wait(smem_u32(bars + s), (parity >> s) & 1u);
      parity ^= 1u << s;
    }
    __syncthreads();

    unsigned char* xs = xs0 + s * g.xs_stride;
    if (it.cb == 0) {
      // quantize the stage into the chunk's channels of the int8 window,
      // four channels a word
      const XT* src = reinterpret_cast<const XT*>(xs);
      int8_t* xqc = xq + it.chunk * g.cc;
      const int n_pix = g.wh * g.ww;
      const int lim = min(g.cc, g.cin - it.chunk * g.cc);    // real channels
      // a flat box's rows start up to 15 bytes before the window
      const int fx = (it.qx0 * g.stride + off_x) * g.cin;
      const int shift = g.load == 3 ? fx - flat_start<XT>(fx) : 0;
      int pix = tid / qpp, qd = tid - pix * qpp;
#pragma unroll 1
      for (; pix < n_pix; pix += step_pix, qd += step_qd) {
        if (qd >= qpp) {
          qd -= qpp;
          ++pix;
          if (pix >= n_pix) break;
        }
        const XT* p = src + 4 * qd + (g.load == 3 ? (pix / g.ww) * g.srow + (pix % g.ww) * g.cin +
                                                        shift
                                                  : pix * g.cc);
        XT q[4];
        if (vec_q && 4 * qd + 4 <= lim) {
          load4(q, p);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) q[k] = 4 * qd + k < lim ? p[k] : zero<XT>();
        }
        int v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = quantize<XT>(q[k], sx, round_bf16);
        *reinterpret_cast<uint32_t*>(xqc + pix * g.pitch + 4 * qd) =
            pack4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
    }

    const int cols = min(g.nb, g.co - it.cb * g.nb);     // real columns here
    const int ntw = max(0, min(min(nbh / 8, NTW), (cols - wn * nbh + 7) / 8));
    if (it.chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0;
    }
    const int row0 = (g.resident ? it.cb * g.nb : 0) + wn * nbh;
    const int8_t* xqc = xq + it.chunk * g.cc;
    if (ntw > 0 && g.ldsm) {
      // 16 k of a pixel lie in one tap, contiguous: ldmatrix rows. A: lane
      // i reads pixel (i % 8) + 8 ((i / 8) % 2) of the m16 tile at k half
      // i / 16; B: lane i reads row (i % 8) + 8 (i / 16) of an n8 tile pair
      // at k half (i / 8) % 2
      const int8_t* wsl = stage_ws(s) + (row0 + (lane >> 4) * 8 + (lane & 7)) * g.ws_stride +
                          ((lane >> 3) & 1) * 16;
      const int half = 4 * (lane >> 4);
      for (int ks = 0; ks < ks_n; ++ks) {
        const int8_t* ak = xqc + tab[ks * 8 + half];
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldsm_x4(a[mt], ak + pa[mt]);
#pragma unroll
        for (int np = 0; np < (NTW + 1) / 2; ++np) {
          if (2 * np < ntw) {
            uint32_t b[4];
            ldsm_x4(b, wsl + np * 16 * g.ws_stride + ks * 32);
            mma_s8(acc[0][2 * np], a[0], b[0], b[1]);
            mma_s8(acc[1][2 * np], a[1], b[0], b[1]);
            if (2 * np + 1 < NTW && 2 * np + 1 < ntw) {
              mma_s8(acc[0][2 * np + 1], a[0], b[2], b[3]);
              mma_s8(acc[1][2 * np + 1], a[1], b[2], b[3]);
            }
          }
        }
      }
    } else if (ntw > 0) {
      const int8_t* wsb = stage_ws(s) + (row0 + gq) * g.ws_stride + 4 * tq;
      for (int ks = 0; ks < ks_n; ++ks) {
        const int o0 = tab[ks * 8 + tq], o1 = tab[ks * 8 + 4 + tq];
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[mt][0] = *reinterpret_cast<const uint32_t*>(xqc + pb[mt][0] + o0);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(xqc + pb[mt][1] + o0);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(xqc + pb[mt][0] + o1);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(xqc + pb[mt][1] + o1);
        }
        const int8_t* br = wsb + ks * 32;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          if (nt < ntw) {
            const int8_t* bn = br + nt * 8 * g.ws_stride;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bn);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bn + 16);
            mma_s8(acc[0][nt], a[0], b0, b1);
            mma_s8(acc[1][nt], a[1], b0, b1);
          }
        }
      }
    }

    if (it.chunk == g.n_chunks - 1 && g.ys_direct) {
      // scale, cast and bias, stored from the registers: a lane writes two
      // neighbouring channels at once where Co is even, a quad of lanes 8
      // channels of a pixel
      const int c0 = it.cb * g.nb;
      const bool pair = g.co % 2 == 0;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int n = wn * nbh + nt * 8 + 2 * tq;
        if (nt < ntw && n < cols) {
          const bool two = n + 1 < cols;
          const float sc0 = scale[c0 + n], sc1 = two ? scale[c0 + n + 1] : 0.f;
          const OT bv0 = bias != nullptr ? bias[c0 + n] : zero<OT>();
          const OT bv1 = bias != nullptr && two ? bias[c0 + n + 1] : zero<OT>();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int qy = it.qy0 + 2 * wm + mt, qx = it.qx0 + gq + 8 * hh;
              if (qy >= hq || qx >= wq) continue;
              OT* dst = y + (((long long)it.b * g.ho + qy * d + py) * g.wo + qx * d + px) * g.co +
                        c0 + n;
              const OT v0 = finish(acc[mt][nt][2 * hh], sc0, bias != nullptr, bv0);
              if (two && pair) {
                const OT v1 = finish(acc[mt][nt][2 * hh + 1], sc1, bias != nullptr, bv1);
                store2(dst, v0, v1);
              } else {
                dst[0] = v0;
                if (two) dst[1] = finish(acc[mt][nt][2 * hh + 1], sc1, bias != nullptr, bv1);
              }
            }
        }
      }
    } else if (it.chunk == g.n_chunks - 1) {
      // scale, cast and bias into the tile, staged in the spent stage (or a
      // region of its own); then whole pixels to y
      OT* ys = g.ys_off != 0 ? reinterpret_cast<OT*>(smem + g.ys_off)
                             : reinterpret_cast<OT*>(xs);
      const int c0 = it.cb * g.nb;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        if (nt < ntw) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int n = wn * nbh + nt * 8 + 2 * tq + k;
            if (n < cols) {
              const float sc = scale[c0 + n];
              const OT bv = bias != nullptr ? bias[c0 + n] : zero<OT>();
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
                  ys[((2 * wm + mt) * kTW + gq + 8 * hh) * g.ypitch + n] =
                      finish(acc[mt][nt][2 * hh + k], sc, bias != nullptr, bv);
            }
          }
        }
      }
      __syncthreads();
      const bool vec = (cols * oe) % 16 == 0 && (g.co * oe) % 16 == 0 && (c0 * oe) % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(y) & 15) == 0;
      const int upp = vec ? cols * oe / 16 : cols;
      const int sp = kThreads / upp, sq = kThreads - sp * upp;
      int pix = tid / upp, part = tid - pix * upp;
#pragma unroll 1
      for (; pix < kBM; pix += sp, part += sq) {
        if (part >= upp) {
          part -= upp;
          if (++pix >= kBM) break;
        }
        const int r = pix / kTW, c = pix - r * kTW;
        const int qy = it.qy0 + r, qx = it.qx0 + c;
        if (qy >= hq || qx >= wq) continue;
        const int oy = qy * d + py, ox = qx * d + px;
        OT* dst = y + (((long long)it.b * g.ho + oy) * g.wo + ox) * g.co + c0;
        const OT* srcp = ys + pix * g.ypitch;
        if (vec)
          reinterpret_cast<int4*>(dst)[part] = reinterpret_cast<const int4*>(srcp)[part];
        else
          dst[part] = srcp[part];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// depthwise
// ---------------------------------------------------------------------------

// the input row or column of a tap, or -1 where it reads the padding or a
// zero of the dilation
__device__ __forceinline__ int source(int p, int dil, int n) {
  if (p < 0) return -1;
  if (dil > 1) {
    if (p % dil) return -1;
    p /= dil;
  }
  return p < n ? p : -1;
}

template <typename XT, typename OT>
__global__ void __launch_bounds__(kDwThreads)
    conv_s8_depthwise(const XT* __restrict__ x, const float* __restrict__ s_x,
                      const int8_t* __restrict__ w, const float* __restrict__ scale,
                      const OT* __restrict__ bias, OT* __restrict__ y, const Geo g) {
  const long long i = (long long)blockIdx.x * kDwThreads + threadIdx.x;
  if (i >= (long long)g.batch * g.ho * g.wo * g.co) return;
  const int c = (int)(i % g.co);
  const long long m = i / g.co;
  const int ox = (int)(m % g.wo);
  const long long r = m / g.wo;
  const int oy = (int)(r % g.ho), b = (int)(r / g.ho);
  const XT* xb = x + (long long)b * g.sb + c;
  const int8_t* wc = w + (long long)c * g.kh * g.kw;
  const float sx = s_x != nullptr ? *s_x : 1.f;
  const bool round_bf16 = g.round_bf16 != 0;
  int acc = 0;
#pragma unroll 1
  for (int ky = 0; ky < g.kh; ++ky) {
    const int iy = source(oy * g.stride - g.pad_t + ky, g.dil, g.h);
    if (iy < 0) continue;
#pragma unroll 1
    for (int kx = 0; kx < g.kw; ++kx) {
      const int ix = source(ox * g.stride - g.pad_l + kx, g.dil, g.w);
      if (ix < 0) continue;
      acc += quantize<XT>(xb[iy * g.sh + ix * g.sw], sx, round_bf16) * (int)wc[ky * g.kw + kx];
    }
  }
  y[i] = finish(acc, scale[c], bias != nullptr, bias != nullptr ? bias[c] : zero<OT>());
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

unsigned round_up(unsigned v, unsigned m) { return (v + m - 1) / m * m; }

// the window, pitches and the shared memory of a dense launch
void derive(Geo& g, int xe, int oe) {
  const int d = g.dil;
  g.khc = (g.kh + d - 1) / d;
  g.kwc = (g.kw + d - 1) / d;
  g.wh = (kTH - 1) * g.stride + g.khc;
  g.ww = (kTW - 1) * g.stride + g.kwc;
  // the int8 window holds every chunk of a pixel's channels, at a pitch
  // that spreads the A loads' banks: for ldmatrix 16-byte rows an odd
  // number of 16 bytes apart, else words
  g.ldsm = g.cc % 16 == 0;
  if (g.ldsm) {
    const int c16 = g.n_chunks * g.cc;
    g.pitch = (c16 / 16) % 2 == 0 ? c16 + 16 : c16;
  } else {
    const int cc4 = (g.n_chunks * g.cc + 3) / 4 * 4;
    g.pitch = cc4 % 32 == 0 ? cc4 + 4 : cc4;
  }
  g.ncb = g.co_pad / g.nb;
  g.n_cfg = d * d;
  g.ypitch = g.nb + 16 / oe;
  g.box_bytes = (unsigned)(g.wh * g.srow * xe);
  const unsigned ys_bytes = (unsigned)(kBM * g.ypitch * oe);
  g.ws_stride = g.kcp + 16;                      // spreads the B loads' banks
  g.resident = g.n_chunks == 1 && g.co_pad * g.ws_stride <= (unsigned)kResident;
  // 8 rows more: an ldmatrix pair's second tile past the last column
  g.ws_bytes = round_up((unsigned)(((g.resident ? g.co_pad : g.nb) + 8) * g.ws_stride), 128);
  g.xs_stride = round_up(g.box_bytes, 128);
  // what is not the ring: the resident weight, the int8 window, the tap
  // table; the staged tile in the spent stage, else apart where shared
  // memory allows, else none (stored from the registers)
  const unsigned window = round_up((unsigned)(g.wh * g.ww * g.pitch), 128);
  const unsigned table = round_up((unsigned)g.kcp, 128);
  const unsigned per_stage = g.xs_stride + (g.resident ? 0 : g.ws_bytes);
  const unsigned fixed = 128 + (g.resident ? g.ws_bytes : 0) + window + table;
  const bool ys_own = ys_bytes > g.xs_stride;
  g.ys_direct = ys_own && fixed + 2 * per_stage + round_up(ys_bytes, 128) > (unsigned)kMaxSmem;
  const unsigned ys_room = ys_own && !g.ys_direct ? round_up(ys_bytes, 128) : 0;
  // two stages, or up to four while they stay small
  g.nst = 2;
  while (g.nst < 4 && (g.nst + 1) * per_stage <= (unsigned)kRing &&
         fixed + (g.nst + 1) * per_stage + ys_room <= (unsigned)kMaxSmem)
    ++g.nst;
  unsigned off = 128 + g.nst * g.xs_stride + (g.resident ? 1 : g.nst) * g.ws_bytes;
  g.xq_off = off;
  off += window;
  g.tab_off = off;
  off += table;
  g.ys_off = ys_room != 0 ? off : 0;
  off += ys_room;
  g.smem = off;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// the 4-D box over x [batch, h, w, cin] (innermost first: cin, w, h, batch)
bool make_tmap(CUtensorMap* map, const void* x, CUtensorMapDataType type, int xe, const Geo& g) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)g.cin, (cuuint64_t)g.w, (cuuint64_t)g.h,
                              (cuuint64_t)g.batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(g.sw * xe), (cuuint64_t)(g.sh * xe),
                                 (cuuint64_t)(g.sb * xe)};
  const cuuint32_t box[4] = {(cuuint32_t)g.cc, (cuuint32_t)g.ww, (cuuint32_t)g.wh, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return fn(map, type, 4, const_cast<void*>(x), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the 3-D box over x viewed as [batch, h, w * cin] (a pixel's channels
// contiguous and next to its neighbour's): srow elements of (w, c) by wh
// rows, each row starting on a 16-byte boundary (`flat_start`)
bool make_tmap_flat(CUtensorMap* map, const void* x, CUtensorMapDataType type, int xe,
                    const Geo& g) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)g.w * g.cin, (cuuint64_t)g.h, (cuuint64_t)g.batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(g.sh * xe), (cuuint64_t)(g.sb * xe)};
  const cuuint32_t box[3] = {(cuuint32_t)g.srow, (cuuint32_t)g.wh, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  return fn(map, type, 3, const_cast<void*>(x), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// resident blocks an SM of a kernel at a shared memory size, and the SMs,
// asked once per device, kernel and size
template <typename K>
int blocks_per_sm(K* kernel, size_t smem, int* sms) {
  static std::mutex lock;
  static std::map<std::pair<int, std::pair<const void*, size_t>>, std::pair<int, int>> seen;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key = std::make_pair(dev, std::make_pair(reinterpret_cast<const void*>(kernel), smem));
  std::lock_guard<std::mutex> guard(lock);
  auto it = seen.find(key);
  if (it == seen.end()) {
    int occ = 0, n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    it = seen.emplace(key, std::make_pair(occ, n)).first;
  }
  *sms = it->second.second;
  return it->second.first;
}

template <typename XT>
CUtensorMapDataType tmap_type() {
  if constexpr (std::is_same<XT, float>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if constexpr (std::is_same<XT, __nv_bfloat16>::value) return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// With `plan` set, fill it (load, unit, stages, shared bytes, blocks an
// SM, grid, ldmatrix, epilogue: 0 staged in the stage, 1 apart, 2 from the
// registers, resident weight) and launch nothing.
template <typename XT, typename OT, int NTW>
cudaError_t launch_dense(const void* x, const float* s_x, const int8_t* w, const float* scale,
                         const void* bias, void* y, Geo g, cudaStream_t stream, int* plan) {
  constexpr int xe = (int)sizeof(XT), oe = (int)sizeof(OT);
  // how the window arrives: TMA where every stride and the box's inner
  // extent are multiples of 16 bytes; else, for one chunk of a few channels
  // packed pixel to pixel, TMA over rows of (w, c); else cp.async of the
  // widest unit that divides the pixels, the strides and the chunk; else
  // plain loads
  const int ww = (kTW - 1) * g.stride + (g.kw + g.dil - 1) / g.dil;
  const int wh = (kTH - 1) * g.stride + (g.kh + g.dil - 1) / g.dil;
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const long long bytes[5] = {(long long)g.cin * xe, (long long)g.cc * xe, g.sw * xe, g.sh * xe,
                              g.sb * xe};
  auto divides = [&](int u) {
    if (base % u) return false;
    for (long long v : bytes)
      if (v % u) return false;
    return true;
  };
  // the flat box's row: the window's (w, c) elements from a 16-byte
  // boundary up to 15 bytes before them, a multiple of 16 bytes
  const int q16 = 16 / xe, flat_row = (ww * g.cin + q16 - 1 + q16 - 1) / q16 * q16;
  const bool flat_ok = g.n_chunks == 1 && g.sw == g.cin && base % 16 == 0 &&
                       (g.sh * xe) % 16 == 0 && (g.sb * xe) % 16 == 0 &&
                       flat_row <= 256 && wh <= 256;
  CUtensorMap map = {};
  g.load = 0;
  g.unit = 0;
  bool tma = false;
  if (divides(16) && g.cc <= 256 && ww <= 256 && wh <= 256) {
    g.load = 2;
    g.srow = ww * g.cc;
    derive(g, xe, oe);
    tma = make_tmap(&map, x, tmap_type<XT>(), xe, g);
  } else if (flat_ok) {
    g.load = 3;
    g.srow = flat_row;
    derive(g, xe, oe);
    tma = make_tmap_flat(&map, x, tmap_type<XT>(), xe, g);
  }
  if (!tma) {
    g.load = 0;
    for (int u : {16, 8, 4})
      if (divides(u)) {
        g.load = 1;
        g.unit = u;
        break;
      }
    g.srow = ww * g.cc;
    derive(g, xe, oe);
  }
  if (g.smem > (unsigned)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = conv_s8_dense<XT, OT, NTW>;
  cudaError_t err = dl4ds::reserve_smem(kernel, g.smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  const int occ = blocks_per_sm(kernel, g.smem, &sms);
  if (occ <= 0) return cudaErrorInvalidConfiguration;
  const int hq = (g.ho + g.dil - 1) / g.dil, wq = (g.wo + g.dil - 1) / g.dil;
  const int tiles = g.batch * ((hq + kTH - 1) / kTH) * ((wq + kTW - 1) / kTW);
  g.bpc = occ * sms / g.n_cfg;
  if (g.bpc < 1) g.bpc = 1;
  if (g.bpc > tiles) g.bpc = tiles;
  const long long grid = (long long)g.n_cfg * g.bpc;
  if (grid >= (1ll << 31)) return cudaErrorInvalidValue;
  if (plan != nullptr) {
    const int v[9] = {g.load, g.unit, g.nst, (int)g.smem, occ, (int)grid, g.ldsm,
                      g.ys_direct ? 2 : g.ys_off != 0 ? 1 : 0, g.resident};
    for (int k = 0; k < 9; ++k) plan[k] = v[k];
    return cudaSuccess;
  }
  kernel<<<(unsigned)grid, kThreads, g.smem, stream>>>(
      map, static_cast<const XT*>(x), s_x, w, scale, static_cast<const OT*>(bias),
      static_cast<OT*>(y), g);
  return cudaGetLastError();
}

template <typename XT, typename OT>
cudaError_t launch_depthwise(const void* x, const float* s_x, const int8_t* w, const float* scale,
                             const void* bias, void* y, const Geo& g, cudaStream_t stream,
                             int* plan) {
  const long long n = (long long)g.batch * g.ho * g.wo * g.co;
  const long long blocks = (n + kDwThreads - 1) / kDwThreads;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  if (plan != nullptr) {
    const int v[9] = {0, 0, 0, 0, 0, (int)blocks, 0, 0, 0};
    for (int k = 0; k < 9; ++k) plan[k] = v[k];
    return cudaSuccess;
  }
  conv_s8_depthwise<XT, OT><<<(unsigned)blocks, kDwThreads, 0, stream>>>(
      static_cast<const XT*>(x), s_x, w, scale, static_cast<const OT*>(bias), static_cast<OT*>(y),
      g);
  return cudaGetLastError();
}

template <typename XT, typename OT>
cudaError_t launch(int depthwise, const void* x, const float* s_x, const int8_t* w,
                   const float* scale, const void* bias, void* y, const Geo& g, cudaStream_t s,
                   int* plan) {
  if (depthwise) return launch_depthwise<XT, OT>(x, s_x, w, scale, bias, y, g, s, plan);
  const int ntw = g.nb / 16;     // n8 tiles a warp
  if (ntw <= 1) return launch_dense<XT, OT, 1>(x, s_x, w, scale, bias, y, g, s, plan);
  if (ntw <= 2) return launch_dense<XT, OT, 2>(x, s_x, w, scale, bias, y, g, s, plan);
  if (ntw <= 4) return launch_dense<XT, OT, 4>(x, s_x, w, scale, bias, y, g, s, plan);
  return launch_dense<XT, OT, 8>(x, s_x, w, scale, bias, y, g, s, plan);
}

template <typename XT>
cudaError_t launch_out(int out_type, int depthwise, const void* x, const float* s_x,
                       const int8_t* w, const float* scale, const void* bias, void* y,
                       const Geo& g, cudaStream_t s, int* plan) {
  if (out_type == 0) return launch<XT, float>(depthwise, x, s_x, w, scale, bias, y, g, s, plan);
  if (out_type == 1)
    return launch<XT, __nv_bfloat16>(depthwise, x, s_x, w, scale, bias, y, g, s, plan);
  return launch<XT, int>(depthwise, x, s_x, w, scale, bias, y, g, s, plan);
}

}  // namespace

// The number of kernels this library has launched since it was loaded.
extern "C" long long dl4ds_conv_int8_launched() { return g_launched; }

// One int8 site. x_type: 0 float32, 1 bfloat16, 2 int8 codes; out_type: 0
// float32, 1 bfloat16, 2 int32 (the raw sums; bias must be null). x [batch,
// h, w, cin] with element strides sb, sh, sw and channel stride 1; s_x one
// float32 on the device (null for int8 codes); w packed by `pack_weight`:
// depthwise (groups = cin = co) [co, kh * kw]; dense [dil * dil * co_pad,
// n_chunks * kcp], a channel chunk cc, nb columns a block (a multiple of 16,
// at most 128, dividing co_pad), kcp a multiple of 32 (`_layout` in
// ops/conv_int8.py); scale [co] float32; bias [co] in the output type or
// null; y [batch, ho, wo, co] contiguous. round_bf16: a float32 x entering a
// bfloat16 site. Returns the cudaError_t of the launch (0 on success);
// launches on `stream`, does not synchronise, allocates nothing.
namespace {

int run(int x_type, int out_type, int depthwise, int round_bf16, const void* x, const float* s_x,
        const void* w, const float* scale, const void* bias, void* y, int batch, int h, int w_in,
        int cin, long long sb, long long sh, long long sw, int ho, int wo, int co, int kh, int kw,
        int stride, int dil, int pad_t, int pad_l, int cc, int n_chunks, int kcp, int nb,
        int co_pad, void* stream, int* plan) {
  Geo g = {};
  g.batch = batch;
  g.h = h;
  g.w = w_in;
  g.cin = cin;
  g.sb = sb;
  g.sh = sh;
  g.sw = sw;
  g.ho = ho;
  g.wo = wo;
  g.co = co;
  g.kh = kh;
  g.kw = kw;
  g.stride = stride;
  g.dil = dil;
  g.pad_t = pad_t;
  g.pad_l = pad_l;
  g.cc = cc;
  g.n_chunks = n_chunks;
  g.kcp = kcp;
  g.nb = nb;
  g.co_pad = co_pad;
  g.round_bf16 = round_bf16;
  const bool shape_ok = batch > 0 && h > 0 && w_in > 0 && cin > 0 && ho > 0 && wo > 0 &&
                        co > 0 && kh > 0 && kw > 0 && stride > 0 && dil > 0 &&
                        x_type >= 0 && x_type <= 2 && out_type >= 0 && out_type <= 2 &&
                        (x_type == 2) == (s_x == nullptr) && !(out_type == 2 && bias);
  const bool dense_ok = !depthwise && (dil == 1 || stride == 1) && cc > 0 && cc <= 256 &&
                        n_chunks == (cin + cc - 1) / cc && kcp > 0 && kcp % 32 == 0 &&
                        nb > 0 && nb <= 128 && nb % 16 == 0 && co_pad >= co &&
                        co_pad % nb == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bool dw_ok = depthwise && cin == co;
  if (!shape_ok || !(dense_ok || dw_ok)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wi = static_cast<const int8_t*>(w);
  cudaError_t err;
  if (x_type == 0)
    err = launch_out<float>(out_type, depthwise, x, s_x, wi, scale, bias, y, g, s, plan);
  else if (x_type == 1)
    err = launch_out<__nv_bfloat16>(out_type, depthwise, x, s_x, wi, scale, bias, y, g, s, plan);
  else
    err = launch_out<int8_t>(out_type, depthwise, x, s_x, wi, scale, bias, y, g, s, plan);
  if (err == cudaSuccess && plan == nullptr) ++g_launched;
  return (int)err;
}

}  // namespace

extern "C" int dl4ds_conv_int8(int x_type, int out_type, int depthwise, int round_bf16,
                               const void* x, const float* s_x, const void* w,
                               const float* scale, const void* bias, void* y, int batch, int h,
                               int w_in, int cin, long long sb, long long sh, long long sw, int ho,
                               int wo, int co, int kh, int kw, int stride, int dil, int pad_t,
                               int pad_l, int cc, int n_chunks, int kcp, int nb, int co_pad,
                               void* stream) {
  return run(x_type, out_type, depthwise, round_bf16, x, s_x, w, scale, bias, y, batch, h, w_in,
             cin, sb, sh, sw, ho, wo, co, kh, kw, stride, dil, pad_t, pad_l, cc, n_chunks, kcp, nb,
             co_pad, stream, nullptr);
}

// The launch dl4ds_conv_int8 would make with these arguments, made not:
// nine ints into `plan` (`launch_dense`). Returns its cudaError_t.
extern "C" int dl4ds_conv_int8_plan(int x_type, int out_type, int depthwise, int round_bf16,
                                    const void* x, const float* s_x, const void* w,
                                    const float* scale, const void* bias, void* y, int batch,
                                    int h, int w_in, int cin, long long sb, long long sh,
                                    long long sw, int ho, int wo, int co, int kh, int kw,
                                    int stride, int dil, int pad_t, int pad_l, int cc,
                                    int n_chunks, int kcp, int nb, int co_pad, void* stream,
                                    int* plan) {
  return run(x_type, out_type, depthwise, round_bf16, x, s_x, w, scale, bias, y, batch, h, w_in,
             cin, sb, sh, sw, ho, wo, co, kh, kw, stride, dil, pad_t, pad_l, cc, n_chunks, kcp, nb,
             co_pad, stream, plan);
}

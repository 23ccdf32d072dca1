// Fused squeeze-excite channel-attention gate (K1), forward and backward, for
// NVIDIA Hopper (sm_90a).
//
//   m = mean_HW(x)   h = relu(m @ w1 + b1)   g = sigmoid(h @ w2 + b2)   y = x * g
//
// x and y are NHWC, [B, HW, C] in memory, float32 or bfloat16; w1 [C, Cr],
// b1 [Cr], w2 [Cr, C], b2 [C] are float32. Every sum is taken in float32;
// g is computed in float32, rounded to x's type and then multiplied, as the
// TPU kernel does (dl4ds_tpu/ops/pallas_ops.py:39-50). The forward also
// writes m and g [B, C] in float32, which the backward takes instead of
// reading x a second time to form them.
//
// The mixed mode (type code 2: x bfloat16, y and dy float32, dx bfloat16)
// is the gate of a bfloat16 model, `channel_attention_reference`
// (pallas_ops.py:29-36) in bfloat16 and its VJP: m, w1, w2 and m @ w1 are
// rounded to bfloat16, the float32 biases promote the rest, y = x g in
// float32 (g not rounded); backward, dx = bf(bf(dy g) + bf(bf(dm) / HW))
// with dm = bf(dh_pre) @ bf(w1)^T, dw1 = bf(sum_b m_b (x) bf(dh_pre_b)) and
// dw2 = bf(sum_b relu(h_pre_b) (x) dg_pre_b), db1 and db2 unrounded (bf:
// rounded to bfloat16; the rows of the weight gradients gain bf(dh_pre)).
//
// The backward computes `_fused_ca_bwd` (dl4ds_tpu/ops/pallas_ops.py:88-112):
//   dg = sum_HW(dy * x)   dg_pre = dg g (1 - g)   h_pre = m @ w1 + b1
//   dh_pre = (dg_pre @ w2^T) [h_pre > 0]   dm = dh_pre @ w1^T
//   dx = dy g + dm / HW
//   dw1 = sum_b m_b (x) dh_pre_b, db1 = sum_b dh_pre_b,
//   dw2 = sum_b relu(h_pre_b) (x) dg_pre_b, db2 = sum_b dg_pre_b.
//
// Replaces: dl4ds_tpu/ops/pallas_ops.py `_forward_pallas` -> `_kernel` (one
// grid step per sample with the whole feature map held in VMEM) and the
// plain-XLA VJP `_fused_ca_bwd`, which XLA fuses into a few loops.
//
// Bound: device memory. The gate does ~2 flops per element against 4 (f32)
// or 2 (bf16) bytes read and as many written, far below the H100's ~20
// flop/byte float32 ridge; the backward reads x and dy and writes dx. The
// least traffic is one read of each input and one write of each output.
//
// Design: hold a sample on chip between its reduction and the pass that
// needs the reduction's result, as the TPU does in VMEM, with the launch
// plan of ops/fused_ops.py `_ca_plan` (a pure function of the shape and the
// card's limits) choosing one of two regimes.
//   block   one CTA holds its sample in shared memory. One launch, one read
//           of x (the backward: one of x and dy).
//   stream  the sample does not fit a CTA's shared memory; it is cut into
//           `parts` contiguous pixel ranges (chunks), a CTA each. Launch 1
//           sums each chunk and writes its partial; the last chunk of a
//           sample to arrive (an arrival counter after a __threadfence)
//           sums the partials in chunk order and forms the gate (the
//           backward: dm, dg_pre, dh_pre). Launch 2 applies it. x (dy) is
//           read twice here.
// (A third regime, a thread-block cluster holding a sample and exchanging
// its partial sums through distributed shared memory, saved at most 0.003
// ms a gate on the narrower batch-8 serving gates against streaming them,
// and was taken out.)
// A resident sample arrives by TMA bulk copies on an mbarrier. The backward
// holds dy's sample in shared memory, and x's too where both fit (else it
// streams x through registers for dg). Its weight gradients are summed over
// the batch in a fixed order from per-sample vectors staged in device
// memory: the last sample of each chunk of 16 to finish sums its chunk, and
// the last chunk the chunks (two more arrival counters). A warp forms each
// hidden unit of the small MLP, its lanes splitting the C-sum. No float
// atomics: every sum has a fixed order and the bits repeat from run to run.
// The arrival counters are zero between launches (the last arrival resets
// them); the caller allocates them once per device, and launches that share
// them must be ordered on one stream.
//
// Member mode (a deep ensemble's gates under torch.func.vmap, the batching
// rule that `vmap` of the Pallas call gets in JAX: a grid axis over the
// members with weight blocks indexed by member): the batch is M members of
// `per_member` samples each, sample b reads the weights of member b /
// per_member from [M, ...] stacks, and the backward's weight gradients come
// out [M, ...], each summed over its own member's samples only. The chunks
// of kChunk samples never straddle two members, and each member sums its
// chunks after its own arrival counter, in the same fixed order as a launch
// of that member alone: a member-mode call equals M one-member calls bit
// for bit (per_member = B is the one-member call).
//
// Band mode (spatial parallelism: each rank of a 'space' group holds a band
// of rows of every sample, and the gate's mean runs over the whole grid,
// global_hw pixels, not over the band). The JAX package replicates a
// Pallas call's operands under GSPMD (pallas_call has no partition rule),
// which here would gather every activation at every gate; the band mode
// computes the same function from the band, with two all-reduces of [B, C]
// vectors between its launches, which the wrapper (ops/fused_ops.py) makes:
//   forward   1. ca_band_sums (ca_stream_sums without its gate, under a name
//                of its own): the band's per-sample
//                channel sums [B, C] (the last chunk of a sample to arrive
//                sums the chunks' partials in order);
//             -- the wrapper all-reduces the sums over the band group --
//             2. ca_band_gate: m = sums / global_hw and the gate, a CTA a
//                sample; ca_band_apply (ca_stream_apply's body): y = x g.
//   backward  1. ca_band_sums: the band's partial dg = sum_band(dy x), the
//                MLP backward on it (every step is linear in dg, so the
//                partial dw1, db1, dw2, db2 and dm sum over the bands to
//                the whole grid's) and the weight gradients, with dm left
//                undivided;
//             -- the wrapper all-reduces dm --
//             2. ca_band_apply: dx = dy g + dm / global_hw (mixed:
//                bf(bf(dy g) + bf(bf(dm) / global_hw))).
// Always the stream regime's cut of a sample into chunks; one member.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

// x rounded to bfloat16 and back
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

constexpr int kThreads = 512;
// opt-in shared memory kept back from the dynamic allocation for the
// kernels' static shared variables
constexpr int kStaticSmemReserve = 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The channels of a thread's packs as its pack index j walks by kThreads:
// the first element's channel ch0 = (j * VEC) % c, advanced by an add and a
// subtract, and the channel of element k of the pack.
struct ChannelWalk {
  int ch0, step, c;
  __device__ ChannelWalk(int j, int vec, int c_)
      : ch0((j * vec) % c_), step((kThreads * vec) % c_), c(c_) {}
  __device__ __forceinline__ void next() {
    ch0 += step;
    if (ch0 >= c) ch0 -= c;
  }
  __device__ __forceinline__ int at(int k) const {
    int ch = ch0 + k;
    while (ch >= c) ch -= c;
    return ch;
  }
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The shape and the plan's cut of a sample (parts 1, ppp hw in the block
// regime). hw * c and ppp * c are multiples of vec (elements a 16-byte pack,
// or 1).
struct Geometry {
  int batch;
  int c, cr;
  long long hw;
  int parts;            // CTAs a sample
  long long ppp;        // pixels a part (the last part may hold fewer)
  long long region;     // bytes of the sample / staging region of shared memory
  long long counter_slot;  // index of the first member's arrival counter
  int mixed;            // the mixed mode's rounding points (type code 2)
  int per_member;       // samples a member (batch: one member)
  long long global_hw;  // band mode: the whole grid's pixels (0: not a band)
};

// The gate weights of one member: w1 [C, Cr], b1 [Cr], w2 [Cr, C], b2 [C]
// inside [M, ...] stacks.
struct Weights {
  const float *w1, *b1, *w2, *b2;
};

__device__ __forceinline__ Weights member_weights(const Geometry& geo, int b,
                                                  const float* w1, const float* b1,
                                                  const float* w2, const float* b2) {
  const long long mem = b / geo.per_member;
  const long long c = geo.c, cr = geo.cr;
  return {w1 + mem * c * cr, b1 + mem * cr, w2 + mem * cr * c,
          b2 == nullptr ? nullptr : b2 + mem * c};
}

// floats of a sample's weight-gradient row: dg_pre C | dh_pre Cr | hh Cr,
// and in the mixed mode bf(dh_pre) Cr
__host__ __device__ __forceinline__ int row_len(const Geometry& geo) {
  return geo.c + (2 + geo.mixed) * geo.cr;
}

__host__ __device__ inline int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Shared memory: [region][red: kThreads * VEC][6 C-vectors][2 Cr-vectors]
struct Smem {
  unsigned char* region;
  float* red;
  float *part, *tot, *m, *g, *v4, *v5;   // C each
  float *h0, *h1;                        // Cr each
};

__device__ __forceinline__ Smem carve(unsigned char* base, const Geometry& geo, int vec) {
  Smem s;
  s.region = base;
  s.red = reinterpret_cast<float*>(base + geo.region);
  float* p = s.red + kThreads * vec;
  s.part = p; p += geo.c;
  s.tot = p; p += geo.c;
  s.m = p; p += geo.c;
  s.g = p; p += geo.c;
  s.v4 = p; p += geo.c;
  s.v5 = p; p += geo.c;
  s.h0 = p; p += geo.cr;
  s.h1 = p;
  return s;
}

size_t smem_bytes(const Geometry& geo, int vec) {
  return (size_t)geo.region + sizeof(float) * ((size_t)kThreads * vec + 6 * geo.c + 2 * geo.cr);
}

// Channel sums of n elements (a multiple of VEC) into out[c]; pack(j, v)
// gives the VEC floats of elements j*VEC .. j*VEC+VEC-1, whose channels are
// (j*VEC + k) % c. Thread t < active sums the packs t, t + active, ...; the
// round of active*VEC elements is a multiple of c, so each of a thread's
// VEC accumulators stays in one channel, and out[ch] adds the accumulators
// of channel ch in a fixed tree. With per > kThreads (very wide C), a
// thread sums whole channels instead. Ends with __syncthreads().
template <int VEC, typename PackFn>
__device__ void channel_sums(long long n, int c, float* red, float* out, PackFn pack) {
  const int t = threadIdx.x;
  const int per = c / gcd_int(c, VEC);       // lcm(c, VEC) / VEC threads a period
  if (per <= kThreads) {
    const int active = (kThreads / per) * per;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    if (t < active) {
      for (long long j = t; j * VEC < n; j += active) {
        float v[VEC];
        pack(j, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[t * VEC + k] = acc[k];
    __syncthreads();
    // channel ch's accumulators are red[ch + i*c], i < len: a pairwise tree
    // in a fixed order, i with i + half
    for (int len = active * VEC / c; len > 1;) {
      const int half = (len + 1) / 2;
      for (int u = t; u < (len - half) * c; u += kThreads) red[u] += red[u + half * c];
      len = half;
      __syncthreads();
    }
    for (int ch = t; ch < c; ch += kThreads) out[ch] = red[ch];
  } else {
    for (int ch = t; ch < c; ch += kThreads) {
      float s = 0.f;
      for (long long e = ch; e < n; e += c) {
        float v[VEC];
        pack(e / VEC, v);
        s += v[e % VEC];
      }
      out[ch] = s;
    }
  }
  __syncthreads();
}

// Sum of v over a warp's lanes, in a fixed butterfly; every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int kWarps = kThreads / 32;

// m = tot / hw, h = relu(m @ w1 + b1), g = sigmoid(h @ w2 + b2). A warp
// forms each hidden unit (lanes split the C-sum), a thread each gate.
__device__ void form_gate(const Smem& s, const Geometry& geo, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          const float* __restrict__ b2) {
  const int c = geo.c, cr = geo.cr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool mx = geo.mixed;
  const float hw = (float)(geo.global_hw ? geo.global_hw : geo.hw);
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const float m = s.tot[ch] / hw;
    s.m[ch] = mx ? rb(m) : m;
  }
  __syncthreads();
  for (int r = warp; r < cr; r += kWarps) {
    float v = 0.f;
    for (int j = lane; j < c; j += 32) v += s.m[j] * (mx ? rb(w1[j * cr + r]) : w1[j * cr + r]);
    v = warp_sum(v);
    if (lane == 0) s.h0[r] = fmaxf((mx ? rb(v) : v) + b1[r], 0.f);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float v = 0.f;
    for (int r = 0; r < cr; ++r) v += s.h0[r] * (mx ? rb(w2[r * c + ch]) : w2[r * c + ch]);
    s.g[ch] = 1.f / (1.f + expf(-(v + b2[ch])));
  }
  __syncthreads();
}

// The MLP backward of one sample from tot (= dg), m and g in shared memory:
// v4 = dg_pre, h0 = h_pre, h1 = dh_pre, v5 = dm / hw (band mode: dm, the
// band's part, undivided). A warp forms each hidden unit's h_pre and dh, a
// thread each dm.
__device__ void gate_backward(const Smem& s, const Geometry& geo, const float* __restrict__ w1,
                              const float* __restrict__ b1, const float* __restrict__ w2) {
  const int c = geo.c, cr = geo.cr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool mx = geo.mixed;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const float g = s.g[ch];
    s.v4[ch] = s.tot[ch] * g * (1.f - g);
  }
  __syncthreads();
  for (int r = warp; r < cr; r += kWarps) {
    float hp = 0.f, dh = 0.f;
    for (int j = lane; j < c; j += 32) {
      hp += s.m[j] * (mx ? rb(w1[j * cr + r]) : w1[j * cr + r]);
      dh += s.v4[j] * (mx ? rb(w2[r * c + j]) : w2[r * c + j]);
    }
    hp = warp_sum(hp);
    hp = (mx ? rb(hp) : hp) + b1[r];
    dh = warp_sum(dh);
    if (lane == 0) {
      s.h0[r] = hp;
      s.h1[r] = hp > 0.f ? dh : 0.f;
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float v = 0.f;
    for (int r = 0; r < cr; ++r)
      v += mx ? rb(s.h1[r]) * rb(w1[ch * cr + r]) : s.h1[r] * w1[ch * cr + r];
    s.v5[ch] = geo.global_hw ? v : mx ? rb(rb(v) / (float)geo.hw) : v / (float)geo.hw;
  }
  __syncthreads();
}

// Per-sample vectors the weight gradients sum over: [B][dg_pre C | dh_pre Cr
// | hh Cr (| bf(dh_pre) Cr in the mixed mode)]
__device__ void store_sample(const Smem& s, const Geometry& geo, int b, float* __restrict__ rows) {
  const int c = geo.c, cr = geo.cr, len = row_len(geo);
  float* row = rows + (long long)b * len;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    float v;
    if (i < c) v = s.v4[i];
    else if (i < c + cr) v = s.h1[i - c];
    else if (i < c + 2 * cr) v = fmaxf(s.h0[i - c - cr], 0.f);
    else v = rb(s.h1[i - c - 2 * cr]);
    row[i] = v;
  }
}

// Block-wide "am I the last of `total` arrivals on *counter": every thread's
// device-memory writes are fenced before thread 0 counts. The last arrival
// resets the counter for the next launch and fences before it reads.
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

// The weight gradients dw1 [C, Cr], dw2 [Cr, C], db1 [Cr], db2 [C] as n_out
// = 2 C Cr + Cr + C outputs, each a sum over samples of row[ia] * row[ib]
// (ib < 0: of row[ia]), rows staged as m | dg_pre | dh_pre | hh (| bf(dh_pre)).
constexpr int kChunk = 16;      // samples a chunk of the weight gradients

__device__ __forceinline__ int n_weight_outputs(const Geometry& geo) {
  return 2 * geo.c * geo.cr + geo.cr + geo.c;
}

__device__ __forceinline__ void factors(const Geometry& geo, int o, int& ia, int& ib) {
  const int c = geo.c, cr = geo.cr, n_w = c * cr;
  if (o < n_w) {                        // dw1[j][r] = sum m[j] dh_pre[r]
    ia = o / cr;
    ib = 2 * c + (geo.mixed ? 2 * cr : 0) + o % cr;
  } else if (o < 2 * n_w) {             // dw2[r][j] = sum hh[r] dg_pre[j]
    ia = 2 * c + cr + (o - n_w) / c;
    ib = c + (o - n_w) % c;
  } else if (o < 2 * n_w + cr) {        // db1[r] = sum dh_pre[r]
    ia = 2 * c + o - 2 * n_w;
    ib = -1;
  } else {                              // db2[j] = sum dg_pre[j]
    ia = c + o - 2 * n_w - cr;
    ib = -1;
  }
}

// out[o] = the sum of output o's terms over the samples [first, first +
// count), in a fixed order, from rows (store_sample) and m [B, C], staged
// through the region in rounds of as many samples as it holds. Where the
// outputs leave threads over, `groups` threads share an output, each
// summing every groups-th sample of the round.
__device__ void chunk_sums(const Smem& s, const Geometry& geo, const float* __restrict__ m_all,
                           const float* rows, int first, int count, float* out) {
  const int c = geo.c, stride = c + row_len(geo), len = row_len(geo);
  float* stage = reinterpret_cast<float*>(s.region);
  const int nb = (int)(geo.region / (sizeof(float) * stride));
  const int n_out = n_weight_outputs(geo);
  const int groups = max(1, kThreads / n_out);
  for (int b0 = 0; b0 < count; b0 += nb) {
    const int cnt = min(nb, count - b0);
    for (int i = threadIdx.x; i < cnt * stride; i += kThreads) {
      const int bb = i / stride, k = i % stride;
      const long long b = first + b0 + bb;
      stage[i] = k < c ? __ldcg(m_all + b * c + k) : __ldcg(rows + b * len + (k - c));
    }
    __syncthreads();
    for (int u = threadIdx.x; u < n_out * groups; u += kThreads) {
      int ia, ib;
      factors(geo, u / groups, ia, ib);
      float a[4] = {0.f, 0.f, 0.f, 0.f};   // four accumulators, added in order
      for (int bb = u % groups, k = 0; bb < cnt; bb += groups, k = (k + 1) & 3) {
        const float* row = stage + bb * stride;
        a[k] += ib >= 0 ? row[ia] * row[ib] : row[ia];
      }
      const float acc = (a[0] + a[1]) + (a[2] + a[3]);
      if (groups == 1)        // one thread an output: add the round now
        out[u] = b0 ? out[u] + acc : acc;
      else
        s.red[u] = acc;
    }
    __syncthreads();
    if (groups > 1) {
      for (int o = threadIdx.x; o < n_out; o += kThreads) {
        float acc = b0 ? out[o] : 0.f;
        for (int gi = 0; gi < groups; ++gi) acc += s.red[o * groups + gi];
        out[o] = acc;
      }
      __syncthreads();
    }
  }
}

// After a sample's rows are stored: the last sample of each chunk of kChunk
// of its member to arrive sums its chunk into chunks [M * cpm, n_out] (cpm
// chunks a member); the member's last chunk to finish sums its chunks in
// order into its dw1, db1, dw2, db2. Counters: at counter_slot one a
// member, then one a chunk.
__device__ void weight_grads(const Smem& s, const Geometry& geo, int b,
                             const float* __restrict__ m_all, const float* rows,
                             float* chunks, unsigned* counters, float* __restrict__ dw1,
                             float* __restrict__ db1, float* __restrict__ dw2,
                             float* __restrict__ db2) {
  const int pm = geo.per_member, members = geo.batch / pm;
  const int mem = b / pm, local = b % pm;
  const int cpm = (pm + kChunk - 1) / kChunk;
  const int lchunk = local / kChunk;
  const int first = mem * pm + lchunk * kChunk;
  const int count = min(kChunk, pm - lchunk * kChunk);
  const int chunk = mem * cpm + lchunk;
  const int n_out = n_weight_outputs(geo), n_w = geo.c * geo.cr;
  if (!last_arrival(counters + geo.counter_slot + members + chunk, (unsigned)count)) return;
  chunk_sums(s, geo, m_all, rows, first, count, chunks + (long long)chunk * n_out);
  if (!last_arrival(counters + geo.counter_slot + mem, (unsigned)cpm)) return;
  const float* mine = chunks + (long long)mem * cpm * n_out;
  const long long w_off = (long long)mem * n_w;
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < cpm; ++k) acc += __ldcg(mine + (long long)k * n_out + o);
    if (o < n_w) dw1[w_off + o] = geo.mixed ? rb(acc) : acc;
    else if (o < 2 * n_w) dw2[w_off + o - n_w] = geo.mixed ? rb(acc) : acc;
    else if (o < 2 * n_w + geo.cr) db1[(long long)mem * geo.cr + o - 2 * n_w] = acc;
    else db2[(long long)mem * geo.c + o - 2 * n_w - geo.cr] = acc;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy one or two arrays of n elements (a multiple of VEC) into shared
// memory. With 16-byte packs (VEC > 1) thread 0 issues TMA bulk copies (16 KB
// each) that complete on one mbarrier, which every thread then waits on;
// with VEC 1, plain loads. srcs[1] may be null (one array).
constexpr uint32_t kBulkChunk = 16384;

template <typename T0, typename T1, int VEC>
__device__ void stage_arrays(T0* d0, const T0* s0, T1* d1, const T1* s1, long long n) {
  if constexpr (VEC == 1) {
    for (long long j = threadIdx.x; j < n; j += kThreads) d0[j] = s0[j];
    if (s1 != nullptr)
      for (long long j = threadIdx.x; j < n; j += kThreads) d1[j] = s1[j];
    __syncthreads();
  } else {
    void* const dsts[2] = {d0, d1};
    const void* const srcs[2] = {s0, s1};
    const uint32_t sizes[2] = {(uint32_t)(n * sizeof(T0)), (uint32_t)(n * sizeof(T1))};
    __shared__ __align__(8) uint64_t bar;
    const uint32_t b = smem_addr(&bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t total = sizes[0] + (srcs[1] != nullptr ? sizes[1] : 0u);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(total)
                   : "memory");
      for (int k = 0; k < 2; ++k) {
        if (srcs[k] == nullptr) continue;
        const char* src = reinterpret_cast<const char*>(srcs[k]);
        const uint32_t dst = smem_addr(dsts[k]);
        const uint32_t bytes = sizes[k];
        for (uint32_t o = 0; o < bytes; o += kBulkChunk) {
          const uint32_t size = bytes - o < kBulkChunk ? bytes - o : kBulkChunk;
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
              "[%0], [%1], %2, [%3];\n" ::"r"(dst + o),
              "l"(src + o), "r"(size), "r"(b)
              : "memory");
        }
      }
    }
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b), "r"(0u)
          : "memory");
    } while (!done);
    __syncthreads();
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_pack(const T* p, long long j, float (&v)[VEC]) {
  const Pack<T, VEC> q = reinterpret_cast<const Pack<T, VEC>*>(p)[j];
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_float(q.v[k]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// block regime: grid B, a CTA a sample, holding all of its x. O is y's
// type: T, or float32 in the mixed mode (y = x g, g not rounded).
template <typename T, typename O, int VEC>
__global__ void __launch_bounds__(kThreads)
ca_fwd_resident(const T* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, O* __restrict__ y, float* __restrict__ m_out,
                float* __restrict__ g_out, Geometry geo) {
  constexpr bool kMixed = sizeof(O) != sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, geo, VEC);
  const int b = blockIdx.x;
  const long long n = geo.hw * geo.c;
  const long long off = (long long)b * n;
  T* xs = reinterpret_cast<T*>(s.region);
  const Weights wt = member_weights(geo, b, w1, b1, w2, b2);

  stage_arrays<T, T, VEC>(xs, x + off, (T*)nullptr, (const T*)nullptr, n);
  channel_sums<VEC>(n, geo.c, s.red, s.tot,
                    [&](long long j, float (&v)[VEC]) { load_pack<T, VEC>(xs, j, v); });
  form_gate(s, geo, wt.w1, wt.b1, wt.w2, wt.b2);
  for (int ch = threadIdx.x; ch < geo.c; ch += kThreads) {
    m_out[(long long)b * geo.c + ch] = s.m[ch];
    g_out[(long long)b * geo.c + ch] = s.g[ch];
  }
  for (int ch = threadIdx.x; ch < geo.c; ch += kThreads)   // g rounded to x's type
    s.v4[ch] = kMixed ? s.g[ch] : to_float(from_float<T>(s.g[ch]));
  __syncthreads();
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(xs);
  Pack<O, VEC>* yv = reinterpret_cast<Pack<O, VEC>*>(y + off);
  ChannelWalk walk(threadIdx.x, VEC, geo.c);
  for (int j = threadIdx.x; j * VEC < n; j += kThreads, walk.next()) {
    const Pack<T, VEC> p = xv[j];
    Pack<O, VEC> q;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      q.v[k] = from_float<O>(to_float(p.v[k]) * s.v4[walk.at(k)]);
    yv[j] = q;
  }
}

// stream regime, launch 1: grid B * parts; each CTA sums its chunk of x
// (the backward: of dy * x); the last chunk of a sample to arrive forms the
// gate (the backward: the MLP backward, and the batch's last sample the
// weight gradients). Band mode's forward: the last chunk writes the
// sample's sums to m_io and forms no gate. The body of the kernels
// ca_stream_sums and ca_band_sums (the band mode's, under a name of its own
// in a device trace).
template <typename T, typename D, int VEC, bool BWD>
__device__ __forceinline__ void stream_sums(
    const T* __restrict__ x, const D* __restrict__ dy, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2, const float* __restrict__ b2,
    float* m_io, float* g_io, float* partial, float* dmh, float* rows, float* chunks,
    unsigned* counters, float* __restrict__ dw1, float* __restrict__ db1,
    float* __restrict__ dw2, float* __restrict__ db2, const Geometry& geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, geo, VEC);
  const int part = blockIdx.x % geo.parts;
  const int b = blockIdx.x / geo.parts;
  const long long p0 = part * geo.ppp;
  const long long p1 = min(p0 + geo.ppp, geo.hw);
  const long long n = (p1 - p0) * geo.c;
  const long long off = ((long long)b * geo.hw + p0) * geo.c;
  const int c = geo.c;

  if (BWD)
    channel_sums<VEC>(n, c, s.red, s.part, [&](long long j, float (&v)[VEC]) {
      float a[VEC];
      load_pack<T, VEC>(x + off, j, a);
      load_pack<D, VEC>(dy + off, j, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] *= a[k];
    });
  else
    channel_sums<VEC>(n, c, s.red, s.part,
                      [&](long long j, float (&v)[VEC]) { load_pack<T, VEC>(x + off, j, v); });
  float* mine = partial + ((long long)b * geo.parts + part) * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) mine[ch] = s.part[ch];
  if (!last_arrival(counters + b, (unsigned)geo.parts)) return;

  const float* ps = partial + (long long)b * geo.parts * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float v = 0.f;
    for (int k = 0; k < geo.parts; ++k) v += __ldcg(ps + (long long)k * c + ch);
    s.tot[ch] = v;
  }
  __syncthreads();
  const Weights wt = member_weights(geo, b, w1, b1, w2, b2);
  if constexpr (!BWD) {
    if (geo.global_hw) {
      for (int ch = threadIdx.x; ch < c; ch += kThreads) m_io[(long long)b * c + ch] = s.tot[ch];
      return;
    }
    form_gate(s, geo, wt.w1, wt.b1, wt.w2, wt.b2);
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      m_io[(long long)b * c + ch] = s.m[ch];
      g_io[(long long)b * c + ch] = s.g[ch];
    }
  } else {
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      s.m[ch] = m_io[(long long)b * c + ch];
      s.g[ch] = g_io[(long long)b * c + ch];
    }
    __syncthreads();
    gate_backward(s, geo, wt.w1, wt.b1, wt.w2);
    for (int ch = threadIdx.x; ch < c; ch += kThreads) dmh[(long long)b * c + ch] = s.v5[ch];
    store_sample(s, geo, b, rows);
    weight_grads(s, geo, b, m_io, rows, chunks, counters, dw1, db1, dw2, db2);
  }
}

#define DL4DS_SUMS_KERNEL(NAME)                                                              \
  template <typename T, typename D, int VEC, bool BWD>                                      \
  __global__ void __launch_bounds__(kThreads)                                                \
      NAME(const T* __restrict__ x, const D* __restrict__ dy, const float* __restrict__ w1,  \
           const float* __restrict__ b1, const float* __restrict__ w2,                       \
           const float* __restrict__ b2, float* m_io, float* g_io, float* partial, float* dmh, \
           float* rows, float* chunks, unsigned* counters, float* __restrict__ dw1,          \
           float* __restrict__ db1, float* __restrict__ dw2, float* __restrict__ db2,        \
           Geometry geo) {                                                                   \
    stream_sums<T, D, VEC, BWD>(x, dy, w1, b1, w2, b2, m_io, g_io, partial, dmh, rows,       \
                                chunks, counters, dw1, db1, dw2, db2, geo);                  \
  }
DL4DS_SUMS_KERNEL(ca_stream_sums)
DL4DS_SUMS_KERNEL(ca_band_sums)
#undef DL4DS_SUMS_KERNEL

// stream regime, launch 2: y = x * round(g) (the backward: dx = dy g + dm / hw)
// over every pack of the tensor; S is the source's type (x, or dy), D the
// output's (y, or dx). Mixed mode (S and D differ): y = x g in float32, dx =
// bf(bf(dy g) + dmh) with dmh already rounded. Band mode's backward: dmh
// holds the whole grid's dm, undivided, and dm / global_hw (mixed:
// bf(bf(dm) / global_hw)) is formed here. The body of ca_stream_apply and
// ca_band_apply.
template <typename S, typename D, int VEC, bool BWD>
__device__ __forceinline__ void stream_apply(const S* __restrict__ src,
                                             const float* __restrict__ g,
                                             const float* __restrict__ dmh, D* __restrict__ out,
                                             const Geometry& geo) {
  constexpr bool kMixed = sizeof(S) != sizeof(D);
  const long long hwc = geo.hw * geo.c;
  const long long n_vec = geo.batch * hwc / VEC;
  const Pack<S, VEC>* sv = reinterpret_cast<const Pack<S, VEC>*>(src);
  Pack<D, VEC>* ov = reinterpret_cast<Pack<D, VEC>*>(out);
  const bool narrow = n_vec * VEC <= 0x7fffffffLL;   // 32-bit index math
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < n_vec;
       j += (long long)gridDim.x * kThreads) {
    long long base;
    int ch0;
    if (narrow) {
      const unsigned e = (unsigned)(j * VEC);
      base = (long long)(e / (unsigned)hwc) * geo.c;
      ch0 = (int)(e % (unsigned)geo.c);
    } else {
      const long long e = j * VEC;
      base = (e / hwc) * geo.c;
      ch0 = (int)(e % geo.c);
    }
    const Pack<S, VEC> p = sv[j];
    Pack<D, VEC> q;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      int ch = ch0 + k;
      while (ch >= geo.c) ch -= geo.c;
      const float gv = g[base + ch], v = to_float(p.v[k]);
      if constexpr (BWD) {
        float d = dmh[base + ch];
        if (geo.global_hw) d = kMixed ? rb(rb(d) / (float)geo.global_hw) : d / (float)geo.global_hw;
        q.v[k] = kMixed ? from_float<D>(rb(v * gv) + d) : from_float<D>(v * gv + d);
      } else
        q.v[k] = kMixed ? from_float<D>(v * gv) : from_float<D>(v * to_float(from_float<S>(gv)));
    }
    ov[j] = q;
  }
}

#define DL4DS_APPLY_KERNEL(NAME)                                                             \
  template <typename S, typename D, int VEC, bool BWD>                                      \
  __global__ void __launch_bounds__(kThreads)                                                \
      NAME(const S* __restrict__ src, const float* __restrict__ g,                           \
           const float* __restrict__ dmh, D* __restrict__ out, Geometry geo) {               \
    stream_apply<S, D, VEC, BWD>(src, g, dmh, out, geo);                                     \
  }
DL4DS_APPLY_KERNEL(ca_stream_apply)
DL4DS_APPLY_KERNEL(ca_band_apply)
#undef DL4DS_APPLY_KERNEL

// band mode, forward launch 2a: grid B, a CTA a sample; m = sums / global_hw
// and the gate from the whole grid's sums (all-reduced by the wrapper).
__global__ void __launch_bounds__(kThreads)
ca_band_gate(const float* __restrict__ sums, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ b2, float* __restrict__ m_out,
             float* __restrict__ g_out, Geometry geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, geo, 1);
  const int b = blockIdx.x;
  const int c = geo.c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) s.tot[ch] = sums[(long long)b * c + ch];
  __syncthreads();
  form_gate(s, geo, w1, b1, w2, b2);
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    m_out[(long long)b * c + ch] = s.m[ch];
    g_out[(long long)b * c + ch] = s.g[ch];
  }
}

// ---------------------------------------------------------------------------
// backward, block regime
// ---------------------------------------------------------------------------

// D is dy's type: T, or float32 in the mixed mode (dx = bf(bf(dy g) + v5)).
template <typename T, typename D, int VEC>
__global__ void __launch_bounds__(kThreads)
ca_bwd_resident(const T* __restrict__ x, const D* __restrict__ dy,
                const float* __restrict__ m_in, const float* __restrict__ g_in,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, T* __restrict__ dx, float* rows, float* chunks,
                unsigned* counters, float* __restrict__ dw1, float* __restrict__ db1,
                float* __restrict__ dw2, float* __restrict__ db2, Geometry geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kMixed = sizeof(D) != sizeof(T);
  const Smem s = carve(smem, geo, VEC);
  const int b = blockIdx.x;
  const long long n = geo.hw * geo.c;
  const long long off = (long long)b * n;
  const int c = geo.c;
  D* dys = reinterpret_cast<D*>(s.region);
  const Weights wt = member_weights(geo, b, w1, b1, w2, nullptr);

  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    s.m[ch] = m_in[(long long)b * c + ch];
    s.g[ch] = g_in[(long long)b * c + ch];
  }
  // x's sample too where the region holds both, so that every load of the
  // reduction is in flight at once
  const long long cap = (n * (long long)sizeof(D) + 15) / 16 * 16;
  const bool hold_x = geo.region >= cap + (n * (long long)sizeof(T) + 15) / 16 * 16;
  T* xs = reinterpret_cast<T*>(s.region + cap);
  stage_arrays<D, T, VEC>(dys, dy + off, xs, hold_x ? x + off : nullptr, n);
  channel_sums<VEC>(n, c, s.red, s.tot, [&](long long j, float (&v)[VEC]) {
    float a[VEC];
    load_pack<T, VEC>(hold_x ? static_cast<const T*>(xs) : x + off, j, a);
    load_pack<D, VEC>(dys, j, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] *= a[k];
  });
  gate_backward(s, geo, wt.w1, wt.b1, wt.w2);
  const Pack<D, VEC>* dv = reinterpret_cast<const Pack<D, VEC>*>(dys);
  Pack<T, VEC>* xv = reinterpret_cast<Pack<T, VEC>*>(dx + off);
  ChannelWalk walk(threadIdx.x, VEC, c);
  for (int j = threadIdx.x; j * VEC < n; j += kThreads, walk.next()) {
    const Pack<D, VEC> p = dv[j];
    Pack<T, VEC> q;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = walk.at(k);
      const float v = to_float(p.v[k]) * s.g[ch];
      q.v[k] = from_float<T>((kMixed ? rb(v) : v) + s.v5[ch]);
    }
    xv[j] = q;
  }
  store_sample(s, geo, b, rows);
  weight_grads(s, geo, b, m_in, rows, chunks, counters, dw1, db1, dw2, db2);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// kernels this library has launched, for callers that check a plan's count
long long g_launched = 0;

template <typename K, typename... Args>
cudaError_t launch(K kernel, long long grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = dl4ds::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) ++g_launched;
  return err;
}

bool valid(const Geometry& geo, int vec, int regime, int elem) {
  if (geo.batch < 1 || geo.c < 1 || geo.cr < 1 || geo.hw < 1 || geo.parts < 1 || geo.ppp < 1)
    return false;
  if (geo.per_member < 1 || geo.batch % geo.per_member) return false;
  if ((geo.hw * geo.c) % vec || (geo.ppp * geo.c) % vec || geo.region % 16) return false;
  if ((long long)(geo.parts - 1) * geo.ppp >= geo.hw || (long long)geo.parts * geo.ppp < geo.hw)
    return false;
  if (regime == 0) return geo.parts == 1 && geo.region >= geo.hw * geo.c * elem;
  return regime == 1;
}

template <typename T, typename O, int VEC>
cudaError_t forward(int regime, const void* x, const float* w1, const float* b1,
                    const float* w2, const float* b2, void* y, float* m_out, float* g_out,
                    float* partial, unsigned* counters, const Geometry& geo, int apply_blocks,
                    cudaStream_t s) {
  const size_t smem = smem_bytes(geo, VEC);
  const T* xt = static_cast<const T*>(x);
  O* yt = static_cast<O*>(y);
  const long long grid = (long long)geo.batch * geo.parts;
  if (regime == 0)
    return launch(ca_fwd_resident<T, O, VEC>, grid, smem, s, xt, w1, b1, w2, b2, yt, m_out,
                  g_out, geo);
  cudaError_t err = launch(ca_stream_sums<T, T, VEC, false>, grid, smem, s, xt,
                           (const T*)nullptr, w1, b1, w2, b2, m_out, g_out, partial,
                           (float*)nullptr, (float*)nullptr, (float*)nullptr, counters,
                           (float*)nullptr, (float*)nullptr, (float*)nullptr,
                           (float*)nullptr, geo);
  if (err != cudaSuccess) return err;
  return launch(ca_stream_apply<T, O, VEC, false>, apply_blocks, 0, s, xt,
                (const float*)g_out, (const float*)nullptr, yt, geo);
}

template <typename T, typename D, int VEC>
cudaError_t backward(int regime, const void* x, const void* dy, const float* m, const float* g,
                     const float* w1, const float* b1, const float* w2, void* dx, float* partial,
                     float* dmh, float* rows, float* chunks, unsigned* counters, float* dw1,
                     float* db1,
                     float* dw2, float* db2, const Geometry& geo, int apply_blocks,
                     cudaStream_t s) {
  const size_t smem = smem_bytes(geo, VEC);
  const T* xt = static_cast<const T*>(x);
  const D* dyt = static_cast<const D*>(dy);
  T* dxt = static_cast<T*>(dx);
  const long long grid = (long long)geo.batch * geo.parts;
  if (regime == 0)
    return launch(ca_bwd_resident<T, D, VEC>, grid, smem, s, xt, dyt, m, g, w1, b1, w2, dxt,
                  rows, chunks, counters, dw1, db1, dw2, db2, geo);
  cudaError_t err = launch(ca_stream_sums<T, D, VEC, true>, grid, smem, s, xt, dyt, w1, b1,
                           w2, (const float*)nullptr, const_cast<float*>(m),
                           const_cast<float*>(g), partial, dmh, rows, chunks, counters, dw1,
                           db1, dw2, db2, geo);
  if (err != cudaSuccess) return err;
  return launch(ca_stream_apply<D, T, VEC, true>, apply_blocks, 0, s, dyt, g,
                (const float*)dmh, dxt, geo);
}

Geometry make_geometry(int batch, long long hw, int c, int cr, int parts, long long ppp,
                       long long region, long long counter_slot, int mixed, int per_member,
                       long long global_hw = 0) {
  Geometry geo;
  geo.batch = batch;
  geo.hw = hw;
  geo.c = c;
  geo.cr = cr;
  geo.parts = parts;
  geo.ppp = ppp;
  geo.region = region;
  geo.counter_slot = counter_slot;
  geo.mixed = mixed;
  geo.per_member = per_member;
  geo.global_hw = global_hw;
  return geo;
}

// band mode: the stage's launches of the forward (stage 0 the sums, 1 the
// gate and the apply) or of the backward (0 the partial gradients, 1 dx)
template <typename T, typename O, int VEC>
cudaError_t band_forward(int stage, const void* x, const float* w1, const float* b1,
                         const float* w2, const float* b2, void* y, float* sums, float* m_out,
                         float* g_out, float* partial, unsigned* counters, const Geometry& geo,
                         int apply_blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (stage == 0)
    return launch(ca_band_sums<T, T, VEC, false>, (long long)geo.batch * geo.parts,
                  smem_bytes(geo, VEC), s, xt, (const T*)nullptr, w1, b1, w2, b2, sums,
                  (float*)nullptr, partial, (float*)nullptr, (float*)nullptr, (float*)nullptr,
                  counters, (float*)nullptr, (float*)nullptr, (float*)nullptr, (float*)nullptr,
                  geo);
  Geometry gate = geo;
  gate.region = 0;
  cudaError_t err = launch(ca_band_gate, geo.batch, smem_bytes(gate, 1), s, (const float*)sums,
                           w1, b1, w2, b2, m_out, g_out, gate);
  if (err != cudaSuccess) return err;
  return launch(ca_band_apply<T, O, VEC, false>, apply_blocks, 0, s, xt, (const float*)g_out,
                (const float*)nullptr, static_cast<O*>(y), geo);
}

template <typename T, typename D, int VEC>
cudaError_t band_backward(int stage, const void* x, const void* dy, const float* m,
                          const float* g, const float* w1, const float* b1, const float* w2,
                          void* dx, float* partial, float* dm, float* rows, float* chunks,
                          unsigned* counters, float* dw1, float* db1, float* dw2, float* db2,
                          const Geometry& geo, int apply_blocks, cudaStream_t s) {
  const D* dyt = static_cast<const D*>(dy);
  if (stage == 0)
    return launch(ca_band_sums<T, D, VEC, true>, (long long)geo.batch * geo.parts,
                  smem_bytes(geo, VEC), s, static_cast<const T*>(x), dyt, w1, b1, w2,
                  (const float*)nullptr, const_cast<float*>(m), const_cast<float*>(g), partial,
                  dm, rows, chunks, counters, dw1, db1, dw2, db2, geo);
  return launch(ca_band_apply<D, T, VEC, true>, apply_blocks, 0, s, dyt, g, (const float*)dm,
                static_cast<T*>(dx), geo);
}

}  // namespace

// The number of kernels this library has launched since it was loaded.
extern "C" long long dl4ds_ca_launched() { return g_launched; }

// The card's limits for `_ca_plan`: SMs, and the dynamic shared memory a
// block may opt into (less kStaticSmemReserve).
extern "C" int dl4ds_ca_limits(int device, int* n_sm, int* smem_optin) {
  cudaError_t err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  *smem_optin -= kStaticSmemReserve;
  return 0;
}

// Forward. dtype: 0 = float32, 1 = bfloat16, 2 = the mixed mode (x
// bfloat16, y float32); regime 0 block, 1 stream; vec: elements of x a
// 16-byte pack or 1. per_member: samples a member (B: one member); the
// weights are [B / per_member, ...] stacks. m_out, g_out [B, C] float32;
// partial [B, parts, C] float32 scratch (stream only); counters: B zeroed
// unsigned ints (stream only). smem must equal the kernel's layout (checked).
// Returns the cudaError_t of the launches (0 on success); launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int dl4ds_channel_attention(int dtype, int regime, int vec, const void* x,
                                       const float* w1, const float* b1, const float* w2,
                                       const float* b2, void* y, float* m_out, float* g_out,
                                       float* partial, unsigned* counters, int batch,
                                       long long hw, int c, int cr, int parts, long long ppp,
                                       long long region, long long smem, int apply_blocks,
                                       int per_member, void* stream) {
  const Geometry geo =
      make_geometry(batch, hw, c, cr, parts, ppp, region, 0, dtype == 2, per_member);
  if (!valid(geo, vec, regime, dtype == 0 ? 4 : 2) || (long long)smem_bytes(geo, vec) != smem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (dtype == 0 && vec == 4)
    return (int)forward<float, float, 4>(regime, x, w1, b1, w2, b2, y, m_out, g_out, partial,
                                         counters, geo, apply_blocks, s);
  if (dtype == 0 && vec == 1)
    return (int)forward<float, float, 1>(regime, x, w1, b1, w2, b2, y, m_out, g_out, partial,
                                         counters, geo, apply_blocks, s);
  if (dtype == 1 && vec == 8)
    return (int)forward<bf16, bf16, 8>(regime, x, w1, b1, w2, b2, y, m_out, g_out, partial,
                                       counters, geo, apply_blocks, s);
  if (dtype == 1 && vec == 1)
    return (int)forward<bf16, bf16, 1>(regime, x, w1, b1, w2, b2, y, m_out, g_out, partial,
                                       counters, geo, apply_blocks, s);
  if (dtype == 2 && vec == 8)
    return (int)forward<bf16, float, 8>(regime, x, w1, b1, w2, b2, y, m_out, g_out, partial,
                                        counters, geo, apply_blocks, s);
  if (dtype == 2 && vec == 1)
    return (int)forward<bf16, float, 1>(regime, x, w1, b1, w2, b2, y, m_out, g_out, partial,
                                        counters, geo, apply_blocks, s);
  return (int)cudaErrorInvalidValue;
}

// Backward: dx like x; dw1 [M, C, Cr], db1 [M, Cr], dw2 [M, Cr, C], db2
// [M, C] float32 (M = B / per_member members, the weights' stacks);
// dtype as the forward's (2: dy float32, x and dx bfloat16);
// m, g [B, C] float32 from the forward; scratch: rows [B, C + 2 Cr] (C + 3
// Cr in the mixed mode), chunks
// [M * ceil(per_member / kChunk), 2 C Cr + Cr + C], and for the stream
// regime partial [B, parts, C] and dmh [B, C]; counters: zeroed unsigned
// ints, B of them for the stream regime's samples, then at counter_slot one
// for each member's count of chunks and after them one for each chunk.
extern "C" int dl4ds_channel_attention_bwd(
    int dtype, int regime, int vec, const void* x, const void* dy, const float* m,
    const float* g, const float* w1, const float* b1, const float* w2, void* dx, float* dw1,
    float* db1, float* dw2, float* db2, float* partial, float* dmh, float* rows, float* chunks,
    unsigned* counters, long long counter_slot, int batch, long long hw, int c, int cr,
    int parts, long long ppp, long long region, long long smem, int apply_blocks, int per_member,
    void* stream) {
  const Geometry geo = make_geometry(batch, hw, c, cr, parts, ppp, region, counter_slot,
                                     dtype == 2, per_member);
  if (!valid(geo, vec, regime, dtype == 1 ? 2 : 4) || (long long)smem_bytes(geo, vec) != smem ||
      counter_slot < batch || region < (long long)sizeof(float) * (c + row_len(geo)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (dtype == 0 && vec == 4)
    return (int)backward<float, float, 4>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh,
                                          rows, chunks, counters, dw1, db1, dw2, db2, geo,
                                          apply_blocks, s);
  if (dtype == 0 && vec == 1)
    return (int)backward<float, float, 1>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh,
                                          rows, chunks, counters, dw1, db1, dw2, db2, geo,
                                          apply_blocks, s);
  if (dtype == 1 && vec == 8)
    return (int)backward<bf16, bf16, 8>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh,
                                        rows, chunks, counters, dw1, db1, dw2, db2, geo,
                                        apply_blocks, s);
  if (dtype == 1 && vec == 1)
    return (int)backward<bf16, bf16, 1>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh,
                                        rows, chunks, counters, dw1, db1, dw2, db2, geo,
                                        apply_blocks, s);
  if (dtype == 2 && vec == 8)
    return (int)backward<bf16, float, 8>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh,
                                         rows, chunks, counters, dw1, db1, dw2, db2, geo,
                                         apply_blocks, s);
  if (dtype == 2 && vec == 1)
    return (int)backward<bf16, float, 1>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh,
                                         rows, chunks, counters, dw1, db1, dw2, db2, geo,
                                         apply_blocks, s);
  return (int)cudaErrorInvalidValue;
}

// Band mode, forward, one stage (see the header): stage 0 writes the band's
// per-sample channel sums [B, C] float32 to `sums` (partial [B, parts, C]
// scratch, counters B zeroed unsigned ints); stage 1 takes the whole grid's
// sums there (global_hw pixels) and writes m, g [B, C] float32 and y (like
// x, float32 in the mixed mode). The plan is the stream regime's (regime 1)
// for the band's hw. Returns the cudaError_t of the launches.
extern "C" int dl4ds_channel_attention_band(int dtype, int stage, int vec, const void* x,
                                            const float* w1, const float* b1, const float* w2,
                                            const float* b2, void* y, float* sums, float* m_out,
                                            float* g_out, float* partial, unsigned* counters,
                                            int batch, long long hw, long long global_hw, int c,
                                            int cr, int parts, long long ppp, long long region,
                                            long long smem, int apply_blocks, void* stream) {
  const Geometry geo =
      make_geometry(batch, hw, c, cr, parts, ppp, region, 0, dtype == 2, batch, global_hw);
  if (!valid(geo, vec, 1, dtype == 0 ? 4 : 2) || (long long)smem_bytes(geo, vec) != smem ||
      global_hw < hw || (stage != 0 && stage != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
#define DL4DS_BAND_FWD(T, O, V)                                                             \
  return (int)band_forward<T, O, V>(stage, x, w1, b1, w2, b2, y, sums, m_out, g_out, partial, \
                                    counters, geo, apply_blocks, s)
  if (dtype == 0 && vec == 4) DL4DS_BAND_FWD(float, float, 4);
  if (dtype == 0 && vec == 1) DL4DS_BAND_FWD(float, float, 1);
  if (dtype == 1 && vec == 8) DL4DS_BAND_FWD(bf16, bf16, 8);
  if (dtype == 1 && vec == 1) DL4DS_BAND_FWD(bf16, bf16, 1);
  if (dtype == 2 && vec == 8) DL4DS_BAND_FWD(bf16, float, 8);
  if (dtype == 2 && vec == 1) DL4DS_BAND_FWD(bf16, float, 1);
#undef DL4DS_BAND_FWD
  return (int)cudaErrorInvalidValue;
}

// Band mode, backward, one stage: stage 0 writes the band's partial dw1,
// db1, dw2, db2 and its partial dm [B, C] float32, undivided (scratch as
// the stream regime's backward: partial, rows, chunks; counters and
// counter_slot as dl4ds_channel_attention_bwd's); stage 1 takes the whole
// grid's dm there and writes dx = dy g + dm / global_hw. m, g [B, C] are the
// forward's (the whole grid's mean and gate).
extern "C" int dl4ds_channel_attention_band_bwd(
    int dtype, int stage, int vec, const void* x, const void* dy, const float* m,
    const float* g, const float* w1, const float* b1, const float* w2, void* dx, float* dw1,
    float* db1, float* dw2, float* db2, float* partial, float* dm, float* rows, float* chunks,
    unsigned* counters, long long counter_slot, int batch, long long hw, long long global_hw,
    int c, int cr, int parts, long long ppp, long long region, long long smem, int apply_blocks,
    void* stream) {
  const Geometry geo = make_geometry(batch, hw, c, cr, parts, ppp, region, counter_slot,
                                     dtype == 2, batch, global_hw);
  if (!valid(geo, vec, 1, dtype == 1 ? 2 : 4) || (long long)smem_bytes(geo, vec) != smem ||
      counter_slot < batch || region < (long long)sizeof(float) * (c + row_len(geo)) ||
      global_hw < hw || (stage != 0 && stage != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
#define DL4DS_BAND_BWD(T, D, V)                                                             \
  return (int)band_backward<T, D, V>(stage, x, dy, m, g, w1, b1, w2, dx, partial, dm, rows,  \
                                     chunks, counters, dw1, db1, dw2, db2, geo, apply_blocks, s)
  if (dtype == 0 && vec == 4) DL4DS_BAND_BWD(float, float, 4);
  if (dtype == 0 && vec == 1) DL4DS_BAND_BWD(float, float, 1);
  if (dtype == 1 && vec == 8) DL4DS_BAND_BWD(bf16, bf16, 8);
  if (dtype == 1 && vec == 1) DL4DS_BAND_BWD(bf16, bf16, 1);
  if (dtype == 2 && vec == 8) DL4DS_BAND_BWD(bf16, float, 8);
  if (dtype == 2 && vec == 1) DL4DS_BAND_BWD(bf16, float, 1);
#undef DL4DS_BAND_BWD
  return (int)cudaErrorInvalidValue;
}

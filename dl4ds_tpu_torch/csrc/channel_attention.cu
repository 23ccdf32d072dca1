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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  long long counter_slot;  // index of the batch-wide arrival counter
};

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
  for (int ch = threadIdx.x; ch < c; ch += kThreads) s.m[ch] = s.tot[ch] / (float)geo.hw;
  __syncthreads();
  for (int r = warp; r < cr; r += kWarps) {
    float v = 0.f;
    for (int j = lane; j < c; j += 32) v += s.m[j] * w1[j * cr + r];
    v = warp_sum(v);
    if (lane == 0) s.h0[r] = fmaxf(v + b1[r], 0.f);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float v = 0.f;
    for (int r = 0; r < cr; ++r) v += s.h0[r] * w2[r * c + ch];
    s.g[ch] = 1.f / (1.f + expf(-(v + b2[ch])));
  }
  __syncthreads();
}

// The MLP backward of one sample from tot (= dg), m and g in shared memory:
// v4 = dg_pre, h0 = h_pre, h1 = dh_pre, v5 = dm / hw. A warp forms each
// hidden unit's h_pre and dh, a thread each dm.
__device__ void gate_backward(const Smem& s, const Geometry& geo, const float* __restrict__ w1,
                              const float* __restrict__ b1, const float* __restrict__ w2) {
  const int c = geo.c, cr = geo.cr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const float g = s.g[ch];
    s.v4[ch] = s.tot[ch] * g * (1.f - g);
  }
  __syncthreads();
  for (int r = warp; r < cr; r += kWarps) {
    float hp = 0.f, dh = 0.f;
    for (int j = lane; j < c; j += 32) {
      hp += s.m[j] * w1[j * cr + r];
      dh += s.v4[j] * w2[r * c + j];
    }
    hp = warp_sum(hp) + b1[r];
    dh = warp_sum(dh);
    if (lane == 0) {
      s.h0[r] = hp;
      s.h1[r] = hp > 0.f ? dh : 0.f;
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float v = 0.f;
    for (int r = 0; r < cr; ++r) v += s.h1[r] * w1[ch * cr + r];
    s.v5[ch] = v / (float)geo.hw;
  }
  __syncthreads();
}

// Per-sample vectors the weight gradients sum over: [B][dg_pre C | dh_pre Cr | hh Cr]
__device__ void store_sample(const Smem& s, const Geometry& geo, int b, float* __restrict__ rows) {
  const int c = geo.c, cr = geo.cr;
  float* row = rows + (long long)b * (c + 2 * cr);
  for (int i = threadIdx.x; i < c + 2 * cr; i += kThreads) {
    float v;
    if (i < c) v = s.v4[i];
    else if (i < c + cr) v = s.h1[i - c];
    else v = fmaxf(s.h0[i - c - cr], 0.f);
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
// (ib < 0: of row[ia]), rows staged as m | dg_pre | dh_pre | hh.
constexpr int kChunk = 16;      // samples a chunk of the weight gradients

__device__ __forceinline__ int n_weight_outputs(const Geometry& geo) {
  return 2 * geo.c * geo.cr + geo.cr + geo.c;
}

__device__ __forceinline__ void factors(const Geometry& geo, int o, int& ia, int& ib) {
  const int c = geo.c, cr = geo.cr, n_w = c * cr;
  if (o < n_w) {                        // dw1[j][r] = sum m[j] dh_pre[r]
    ia = o / cr;
    ib = 2 * c + o % cr;
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
  const int c = geo.c, cr = geo.cr, stride = 2 * c + 2 * cr;
  float* stage = reinterpret_cast<float*>(s.region);
  const int nb = (int)(geo.region / (sizeof(float) * stride));
  const int n_out = n_weight_outputs(geo);
  const int groups = max(1, kThreads / n_out);
  for (int b0 = 0; b0 < count; b0 += nb) {
    const int cnt = min(nb, count - b0);
    for (int i = threadIdx.x; i < cnt * stride; i += kThreads) {
      const int bb = i / stride, k = i % stride;
      const long long b = first + b0 + bb;
      stage[i] = k < c ? __ldcg(m_all + b * c + k) : __ldcg(rows + b * (c + 2 * cr) + (k - c));
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
// to arrive sums its chunk into chunks [n_chunks, n_out]; the last chunk to
// finish sums the chunks in order into dw1, db1, dw2, db2.
__device__ void weight_grads(const Smem& s, const Geometry& geo, int b,
                             const float* __restrict__ m_all, const float* rows,
                             float* chunks, unsigned* counters, float* __restrict__ dw1,
                             float* __restrict__ db1, float* __restrict__ dw2,
                             float* __restrict__ db2) {
  const int chunk = b / kChunk, first = chunk * kChunk;
  const int count = min(kChunk, geo.batch - first);
  const int n_chunks = (geo.batch + kChunk - 1) / kChunk;
  const int n_out = n_weight_outputs(geo), n_w = geo.c * geo.cr;
  if (!last_arrival(counters + geo.counter_slot + 1 + chunk, (unsigned)count)) return;
  chunk_sums(s, geo, m_all, rows, first, count, chunks + (long long)chunk * n_out);
  if (!last_arrival(counters + geo.counter_slot, (unsigned)n_chunks)) return;
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < n_chunks; ++k) acc += __ldcg(chunks + (long long)k * n_out + o);
    if (o < n_w) dw1[o] = acc;
    else if (o < 2 * n_w) dw2[o - n_w] = acc;
    else if (o < 2 * n_w + geo.cr) db1[o - 2 * n_w] = acc;
    else db2[o - 2 * n_w - geo.cr] = acc;
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

template <typename T, int VEC>
__device__ void stage_arrays(T* const (&dsts)[2], const T* const (&srcs)[2], long long n) {
  if constexpr (VEC == 1) {
    for (int k = 0; k < 2; ++k)
      if (srcs[k] != nullptr)
        for (long long j = threadIdx.x; j < n; j += kThreads) dsts[k][j] = srcs[k][j];
    __syncthreads();
  } else {
    __shared__ __align__(8) uint64_t bar;
    const uint32_t b = smem_addr(&bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const uint32_t bytes = (uint32_t)(n * sizeof(T));
    if (threadIdx.x == 0) {
      const uint32_t total = srcs[1] != nullptr ? 2 * bytes : bytes;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(total)
                   : "memory");
      for (int k = 0; k < 2; ++k) {
        if (srcs[k] == nullptr) continue;
        const char* src = reinterpret_cast<const char*>(srcs[k]);
        const uint32_t dst = smem_addr(dsts[k]);
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

// block regime: grid B, a CTA a sample, holding all of its x.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ca_fwd_resident(const T* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, T* __restrict__ y, float* __restrict__ m_out,
                float* __restrict__ g_out, Geometry geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, geo, VEC);
  const int b = blockIdx.x;
  const long long n = geo.hw * geo.c;
  const long long off = (long long)b * n;
  T* xs = reinterpret_cast<T*>(s.region);

  stage_arrays<T, VEC>({xs, nullptr}, {x + off, nullptr}, n);
  channel_sums<VEC>(n, geo.c, s.red, s.tot,
                    [&](long long j, float (&v)[VEC]) { load_pack<T, VEC>(xs, j, v); });
  form_gate(s, geo, w1, b1, w2, b2);
  for (int ch = threadIdx.x; ch < geo.c; ch += kThreads) {
    m_out[(long long)b * geo.c + ch] = s.m[ch];
    g_out[(long long)b * geo.c + ch] = s.g[ch];
  }
  for (int ch = threadIdx.x; ch < geo.c; ch += kThreads)
    s.v4[ch] = to_float(from_float<T>(s.g[ch]));          // g rounded to x's type
  __syncthreads();
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(xs);
  Pack<T, VEC>* yv = reinterpret_cast<Pack<T, VEC>*>(y + off);
  ChannelWalk walk(threadIdx.x, VEC, geo.c);
  for (int j = threadIdx.x; j * VEC < n; j += kThreads, walk.next()) {
    Pack<T, VEC> p = xv[j];
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      p.v[k] = from_float<T>(to_float(p.v[k]) * s.v4[walk.at(k)]);
    yv[j] = p;
  }
}

// stream regime, launch 1: grid B * parts; each CTA sums its chunk of x
// (the backward: of dy * x); the last chunk of a sample to arrive forms the
// gate (the backward: the MLP backward, and the batch's last sample the
// weight gradients).
template <typename T, int VEC, bool BWD>
__global__ void __launch_bounds__(kThreads)
ca_stream_sums(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* m_io, float* g_io,
               float* partial, float* dmh, float* rows, float* chunks, unsigned* counters,
               float* __restrict__ dw1, float* __restrict__ db1, float* __restrict__ dw2,
               float* __restrict__ db2, Geometry geo) {
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
      load_pack<T, VEC>(dy + off, j, v);
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
  if constexpr (!BWD) {
    form_gate(s, geo, w1, b1, w2, b2);
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
    gate_backward(s, geo, w1, b1, w2);
    for (int ch = threadIdx.x; ch < c; ch += kThreads) dmh[(long long)b * c + ch] = s.v5[ch];
    store_sample(s, geo, b, rows);
    weight_grads(s, geo, b, m_io, rows, chunks, counters, dw1, db1, dw2, db2);
  }
}

// stream regime, launch 2: y = x * round(g) (the backward: dx = dy g + dm / hw)
// over every pack of the tensor.
template <typename T, int VEC, bool BWD>
__global__ void __launch_bounds__(kThreads)
ca_stream_apply(const T* __restrict__ src, const float* __restrict__ g,
                const float* __restrict__ dmh, T* __restrict__ out, Geometry geo) {
  const long long hwc = geo.hw * geo.c;
  const long long n_vec = geo.batch * hwc / VEC;
  const Pack<T, VEC>* sv = reinterpret_cast<const Pack<T, VEC>*>(src);
  Pack<T, VEC>* ov = reinterpret_cast<Pack<T, VEC>*>(out);
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
    Pack<T, VEC> p = sv[j];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      int ch = ch0 + k;
      while (ch >= geo.c) ch -= geo.c;
      const float gv = g[base + ch];
      p.v[k] = BWD ? from_float<T>(to_float(p.v[k]) * gv + dmh[base + ch])
                   : from_float<T>(to_float(p.v[k]) * to_float(from_float<T>(gv)));
    }
    ov[j] = p;
  }
}

// ---------------------------------------------------------------------------
// backward, block regime
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ca_bwd_resident(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ m_in, const float* __restrict__ g_in,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, T* __restrict__ dx, float* rows, float* chunks,
                unsigned* counters, float* __restrict__ dw1, float* __restrict__ db1,
                float* __restrict__ dw2, float* __restrict__ db2, Geometry geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, geo, VEC);
  const int b = blockIdx.x;
  const long long n = geo.hw * geo.c;
  const long long off = (long long)b * n;
  const int c = geo.c;
  T* dys = reinterpret_cast<T*>(s.region);

  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    s.m[ch] = m_in[(long long)b * c + ch];
    s.g[ch] = g_in[(long long)b * c + ch];
  }
  // x's sample too where the region holds both, so that every load of the
  // reduction is in flight at once
  const long long cap = (n * (long long)sizeof(T) + 15) / 16 * 16;
  const bool hold_x = geo.region >= 2 * cap;
  T* xs = reinterpret_cast<T*>(s.region + cap);
  stage_arrays<T, VEC>({dys, xs}, {dy + off, hold_x ? x + off : nullptr}, n);
  channel_sums<VEC>(n, c, s.red, s.tot, [&](long long j, float (&v)[VEC]) {
    float a[VEC];
    load_pack<T, VEC>(hold_x ? static_cast<const T*>(xs) : x + off, j, a);
    load_pack<T, VEC>(dys, j, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] *= a[k];
  });
  gate_backward(s, geo, w1, b1, w2);
  const Pack<T, VEC>* dv = reinterpret_cast<const Pack<T, VEC>*>(dys);
  Pack<T, VEC>* xv = reinterpret_cast<Pack<T, VEC>*>(dx + off);
  ChannelWalk walk(threadIdx.x, VEC, c);
  for (int j = threadIdx.x; j * VEC < n; j += kThreads, walk.next()) {
    Pack<T, VEC> p = dv[j];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = walk.at(k);
      p.v[k] = from_float<T>(to_float(p.v[k]) * s.g[ch] + s.v5[ch]);
    }
    xv[j] = p;
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
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
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
  if ((geo.hw * geo.c) % vec || (geo.ppp * geo.c) % vec || geo.region % 16) return false;
  if ((long long)(geo.parts - 1) * geo.ppp >= geo.hw || (long long)geo.parts * geo.ppp < geo.hw)
    return false;
  if (regime == 0) return geo.parts == 1 && geo.region >= geo.hw * geo.c * elem;
  return regime == 1;
}

template <typename T, int VEC>
cudaError_t forward(int regime, const void* x, const float* w1, const float* b1,
                    const float* w2, const float* b2, void* y, float* m_out, float* g_out,
                    float* partial, unsigned* counters, const Geometry& geo, int apply_blocks,
                    cudaStream_t s) {
  const size_t smem = smem_bytes(geo, VEC);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const long long grid = (long long)geo.batch * geo.parts;
  if (regime == 0)
    return launch(ca_fwd_resident<T, VEC>, grid, smem, s, xt, w1, b1, w2, b2, yt, m_out,
                  g_out, geo);
  cudaError_t err = launch(ca_stream_sums<T, VEC, false>, grid, smem, s, xt,
                           (const T*)nullptr, w1, b1, w2, b2, m_out, g_out, partial,
                           (float*)nullptr, (float*)nullptr, (float*)nullptr, counters,
                           (float*)nullptr, (float*)nullptr, (float*)nullptr,
                           (float*)nullptr, geo);
  if (err != cudaSuccess) return err;
  return launch(ca_stream_apply<T, VEC, false>, apply_blocks, 0, s, xt,
                (const float*)g_out, (const float*)nullptr, yt, geo);
}

template <typename T, int VEC>
cudaError_t backward(int regime, const void* x, const void* dy, const float* m, const float* g,
                     const float* w1, const float* b1, const float* w2, void* dx, float* partial,
                     float* dmh, float* rows, float* chunks, unsigned* counters, float* dw1,
                     float* db1,
                     float* dw2, float* db2, const Geometry& geo, int apply_blocks,
                     cudaStream_t s) {
  const size_t smem = smem_bytes(geo, VEC);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const long long grid = (long long)geo.batch * geo.parts;
  if (regime == 0)
    return launch(ca_bwd_resident<T, VEC>, grid, smem, s, xt, dyt, m, g, w1, b1, w2, dxt, rows,
                  chunks, counters, dw1, db1, dw2, db2, geo);
  cudaError_t err = launch(ca_stream_sums<T, VEC, true>, grid, smem, s, xt, dyt, w1, b1,
                           w2, (const float*)nullptr, const_cast<float*>(m),
                           const_cast<float*>(g), partial, dmh, rows, chunks, counters, dw1,
                           db1, dw2, db2, geo);
  if (err != cudaSuccess) return err;
  return launch(ca_stream_apply<T, VEC, true>, apply_blocks, 0, s, dyt, g,
                (const float*)dmh, dxt, geo);
}

Geometry make_geometry(int batch, long long hw, int c, int cr, int parts, long long ppp,
                       long long region, long long counter_slot) {
  Geometry geo;
  geo.batch = batch;
  geo.hw = hw;
  geo.c = c;
  geo.cr = cr;
  geo.parts = parts;
  geo.ppp = ppp;
  geo.region = region;
  geo.counter_slot = counter_slot;
  return geo;
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

// Forward. dtype: 0 = float32, 1 = bfloat16; regime 0 block, 1 stream;
// vec: elements a 16-byte pack or 1. m_out, g_out [B, C] float32;
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
                                       void* stream) {
  const Geometry geo = make_geometry(batch, hw, c, cr, parts, ppp, region, 0);
  if (!valid(geo, vec, regime, dtype == 0 ? 4 : 2) || (long long)smem_bytes(geo, vec) != smem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return (int)forward<float, 4>(regime, x, w1, b1, w2, b2, y, m_out, g_out, partial,
                                  counters, geo, apply_blocks, s);
  if (dtype == 0 && vec == 1)
    return (int)forward<float, 1>(regime, x, w1, b1, w2, b2, y, m_out, g_out, partial,
                                  counters, geo, apply_blocks, s);
  if (dtype == 1 && vec == 8)
    return (int)forward<__nv_bfloat16, 8>(regime, x, w1, b1, w2, b2, y, m_out, g_out,
                                          partial, counters, geo, apply_blocks, s);
  if (dtype == 1 && vec == 1)
    return (int)forward<__nv_bfloat16, 1>(regime, x, w1, b1, w2, b2, y, m_out, g_out,
                                          partial, counters, geo, apply_blocks, s);
  return (int)cudaErrorInvalidValue;
}

// Backward: dx like x; dw1 [C, Cr], db1 [Cr], dw2 [Cr, C], db2 [C] float32;
// m, g [B, C] float32 from the forward; scratch: rows [B, C + 2 Cr], chunks
// [ceil(B / kChunk), 2 C Cr + Cr + C], and for the stream regime partial [B,
// parts, C] and dmh [B, C]; counters: zeroed unsigned ints, B of them for
// the stream regime's samples, then at counter_slot the count of chunks and
// after it one for each chunk.
extern "C" int dl4ds_channel_attention_bwd(
    int dtype, int regime, int vec, const void* x, const void* dy, const float* m,
    const float* g, const float* w1, const float* b1, const float* w2, void* dx, float* dw1,
    float* db1, float* dw2, float* db2, float* partial, float* dmh, float* rows, float* chunks,
    unsigned* counters, long long counter_slot, int batch, long long hw, int c, int cr,
    int parts, long long ppp, long long region, long long smem, int apply_blocks,
    void* stream) {
  const Geometry geo = make_geometry(batch, hw, c, cr, parts, ppp, region, counter_slot);
  if (!valid(geo, vec, regime, dtype == 0 ? 4 : 2) || (long long)smem_bytes(geo, vec) != smem ||
      counter_slot < batch || region < (long long)sizeof(float) * (2 * c + 2 * cr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return (int)backward<float, 4>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh, rows,
                                   chunks, counters, dw1, db1, dw2, db2, geo, apply_blocks, s);
  if (dtype == 0 && vec == 1)
    return (int)backward<float, 1>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh, rows,
                                   chunks, counters, dw1, db1, dw2, db2, geo, apply_blocks, s);
  if (dtype == 1 && vec == 8)
    return (int)backward<__nv_bfloat16, 8>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh,
                                           rows, chunks, counters, dw1, db1, dw2, db2, geo,
                                           apply_blocks, s);
  if (dtype == 1 && vec == 1)
    return (int)backward<__nv_bfloat16, 1>(regime, x, dy, m, g, w1, b1, w2, dx, partial, dmh,
                                           rows, chunks, counters, dw1, db1, dw2, db2, geo,
                                           apply_blocks, s);
  return (int)cudaErrorInvalidValue;
}

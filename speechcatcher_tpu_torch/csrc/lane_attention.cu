// The decoder beam step's self-attention over its lane-mapped activation
// cache (kernel G), sm_90a.
//
// Replaces no TPU kernel: the JAX package's lane attention is XLA. In the
// port's beam step (models/decoder.py::_attend_cached_lane) each layer
// gathered the whole (N, Lmax, d) cache through the lane map into a float32
// copy, contracted it twice (scores, weighted sum) and masked the rows at
// t >= pos, about 19 ATen kernels a layer. This kernel is all of them, for
// hypothesis n = s*B + b with history length P = min(pos[n], Lmax):
//     row_t   = cache[s*B + lane[s, b, t], t]  (widened to float32), t < P
//     score_j = qk[n, j] . row_t / sqrt(dk),  and qk[n, j] . hn_self[n] / sqrt(dk)
//     attn_j  = softmax over those P + 1 scores (max, exp, sum, divide)
//     u[n, j] = sum_t attn_j,t * row_t  +  attn_j,self * hn_self[n]
// Rows at t >= P are never read. The composition gave them MASK_MIN scores,
// whose exp is exactly 0, and zero weights: only the order of the float32
// sums differs. Plain float32 FMAs, no TF32 and no tensor cores.
//
// Bound on the H100: bytes and latency. At the drain's width 32 (N = 96,
// h 8, d 512) and P = 32 a call reads 6.3 MB of rows and 1.6 MB of qk and
// writes 1.6 MB, 2.8 us at 3.35 TB/s, against 50 MFLOP (0.75 us at 67
// TFLOP/s). So one block a hypothesis, and as many loads in flight as a
// block can keep:
//   1. qk[n] (h x d floats, at most 16 KB) and each history row's offset
//      (the lane map read once) go to shared memory;
//   2. each warp takes two of the P + 1 rows at a time, each lane loading
//      16 bytes of each at once (8 of a bfloat16 cache); every float4 of qk
//      read from shared memory serves both rows' h partial dots, which a
//      transposed warp reduction sums (nine shuffles for eight heads); the
//      h x (P + 1) scores stay in shared memory;
//   3. a warp a head runs the exact softmax in place;
//   4. the weighted sum reads the rows again (from L1/L2: a block's rows
//      are at most Lmax x d), each thread one float4 column of every row
//      for up to four heads.
// The plan gives 16 warps a block while N does not fill the 132 SMs, else
// 8 (lane_attention.py::warps_per_block).
//
// The entry point takes the pointers, the caller's cached plan (a struct of
// the launch's integers, passed by address) and the stream, and returns 0,
// a cudaError_t, or kBadPlan when the plan or the pointers do not fit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// At namespace scope: a type of an unnamed namespace in the signature
// would give the extern "C" entry point internal linkage.
struct LaneAttentionArgs {  // mirrors lane_attention.py::_Args
  long long qk_ns, qk_hs;            // qk strides on hypotheses and heads
  long long cache_rs, cache_ps;      // cache strides on rows and positions
  long long hn_rs;                   // hn_self's row stride
  long long lane_ss, lane_bs;        // lane's strides on streams and beams
  int n, h, d, lmax, beam;
  int warps;                         // 8 or 16 a block
  int cache_bytes;                   // 4 or 2
  int smem_bytes;
  float sqrt_dk;
};

namespace {

constexpr int kBadPlan = -1;
constexpr int kMaxVec = 8;           // float4s of a row a lane: d <= 1024
constexpr int kMaxHeads = 32;
constexpr int kChunk = 8;            // heads a lane's scores pass holds
constexpr int kHeadsPerThread = 4;   // heads a weighted-sum thread holds
constexpr int kMaxShared = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Four consecutive elements of a row as floats: one 16-byte load of a
// float32 row, one 8-byte load of a bfloat16 row (widened exactly).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float w, float4 r, float4 acc) {
  return make_float4(fmaf(w, r.x, acc.x), fmaf(w, r.y, acc.y),
                     fmaf(w, r.z, acc.z), fmaf(w, r.w, acc.w));
}

// The warp sums of eight values a lane, transposed: lane l returns the sum
// over the warp of v[(l >> 2) & 7]. Nine shuffles where eight warp sums
// take forty: each step keeps half of its values and adds the partner's
// copy of that half.
__device__ __forceinline__ float reduce8(const float (&v)[kChunk], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w4[4], w2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w4[i] = (b4 ? v[i + 4] : v[i])
            + __shfl_xor_sync(kFull, b4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = (b3 ? w4[i + 2] : w4[i])
            + __shfl_xor_sync(kFull, b3 ? w4[i] : w4[i + 2], 8);
  float w = (b2 ? w2[1] : w2[0]) + __shfl_xor_sync(kFull, b2 ? w2[0] : w2[1],
                                                   4);
  w += __shfl_xor_sync(kFull, w, 2);
  return w + __shfl_xor_sync(kFull, w, 1);
}

// Row t of the scores pass (t < valid a history row, t == valid the self
// row) into r: the lane's float4 columns u = lane + 32 v, v < V.
template <int V, typename T>
__device__ __forceinline__ void load_row(float4 (&r)[V], int t, int valid,
                                         const T* cache,
                                         const long long* off_s,
                                         const float* self_row, int lane_id,
                                         int units) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int u = lane_id + 32 * v;
    r[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (u < units)
      r[v] = t < valid ? load4(cache + off_s[t] + 4 * u)
                       : load4(self_row + 4 * u);
  }
}

// V: float4 columns of a row a lane (d / 128, 1 for d <= 128). T: the
// cache's element type.
template <int V, typename T>
__global__ void __launch_bounds__(512) lane_attention_kernel(
    const float* __restrict__ qk, const T* __restrict__ cache,
    const float* __restrict__ hn_self, const int* __restrict__ lane,
    const long long* __restrict__ pos, float* __restrict__ out,
    LaneAttentionArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = a.h, d = a.d, units = d >> 2;
  const int stride = a.lmax + 1;                  // a head's scores
  float* qk_s = reinterpret_cast<float*>(smem);                // h x d
  long long* off_s = reinterpret_cast<long long*>(qk_s + h * d);  // Lmax
  float* score_s = reinterpret_cast<float*>(off_s + a.lmax);   // h x stride

  const int n = blockIdx.x;
  const int s = n / a.beam, b = n - s * a.beam;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int warp = tid >> 5, lane_id = tid & 31, warps = threads >> 5;
  const long long p = pos[n];
  const int valid = p <= 0 ? 0 : (p >= a.lmax ? a.lmax : static_cast<int>(p));
  const float* self_row = hn_self + n * a.hn_rs;

  // 1. Stage qk[n] and the history rows' offsets (a lane outside [0, B)
  // is clamped: the twin's gather raises there).
  const float* qn = qk + n * a.qk_ns;
  for (int i = tid; i < h * units; i += threads) {
    const int j = i / units;
    reinterpret_cast<float4*>(qk_s)[i] =
        reinterpret_cast<const float4*>(qn + j * a.qk_hs)[i - j * units];
  }
  const int* ln = lane + s * a.lane_ss + b * a.lane_bs;
  for (int t = tid; t < valid; t += threads) {
    const int l = min(max(ln[t], 0), a.beam - 1);
    off_s[t] = (static_cast<long long>(s) * a.beam + l) * a.cache_rs
               + t * a.cache_ps;
  }
  __syncthreads();

  // 2. Scores: a warp takes rows t0 and t0 + 1 together (row t < valid of
  // the history, t == valid the self row; a missing second row is zeros),
  // so each float4 of qk read from shared memory serves both.
  for (int t0 = 2 * warp; t0 <= valid; t0 += 2 * warps) {
    const int t1 = t0 + 1;
    float4 r0[V], r1[V];
    load_row(r0, t0, valid, cache, off_s, self_row, lane_id, units);
    load_row(r1, t1 <= valid ? t1 : valid, valid, cache, off_s, self_row,
             lane_id, t1 <= valid ? units : 0);
    for (int j0 = 0; j0 < h; j0 += kChunk) {
      float acc0[kChunk], acc1[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) acc0[k] = acc1[k] = 0.0f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int u = lane_id + 32 * v;
        if (u >= units) continue;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (j0 + k >= h) continue;
          const float4 q =
              reinterpret_cast<const float4*>(qk_s + (j0 + k) * d)[u];
          acc0[k] = dot4(q, r0[v], acc0[k]);
          acc1[k] = dot4(q, r1[v], acc1[k]);
        }
      }
      const int j = j0 + ((lane_id >> 2) & 7);
      const float sum0 = reduce8(acc0, lane_id);
      const float sum1 = reduce8(acc1, lane_id);
      if ((lane_id & 3) == 0 && j < h) {
        score_s[j * stride + t0] = __fdiv_rn(sum0, a.sqrt_dk);
        if (t1 <= valid) score_s[j * stride + t1] = __fdiv_rn(sum1, a.sqrt_dk);
      }
    }
  }
  __syncthreads();

  // 3. The softmax of each head over its valid + 1 scores, in place.
  for (int j = warp; j < h; j += warps) {
    float* sc = score_s + j * stride;
    float mx = __int_as_float(0xff800000);          // -inf
    for (int t = lane_id; t <= valid; t += 32) mx = fmaxf(mx, sc[t]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int t = lane_id; t <= valid; t += 32) {
      const float e = expf(__fsub_rn(sc[t], mx));
      sc[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane_id; t <= valid; t += 32) sc[t] = __fdiv_rn(sc[t], sum);
  }
  __syncthreads();

  // 4. The weighted sum: thread (g, c) takes float4 column c of every row
  // for heads g, g + groups, ..., kHeadsPerThread at a time, then adds the
  // self row's share: u = sum_t attn_t row_t + attn_self hn_self.
  const int groups = threads / units;
  const int g = tid / units, c = tid - g * units;
  if (g >= groups) return;
  const float4 self4 = load4(self_row + 4 * c);
  for (int j0 = g; j0 < h; j0 += kHeadsPerThread * groups) {
    float4 acc[kHeadsPerThread];
#pragma unroll
    for (int k = 0; k < kHeadsPerThread; ++k)
      acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int t = 0; t < valid; ++t) {
      const float4 r = load4(cache + off_s[t] + 4 * c);
#pragma unroll
      for (int k = 0; k < kHeadsPerThread; ++k) {
        const int j = j0 + k * groups;
        if (j < h) acc[k] = axpy4(score_s[j * stride + t], r, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kHeadsPerThread; ++k) {
      const int j = j0 + k * groups;
      if (j >= h) continue;
      const float w = score_s[j * stride + valid];
      const float4 o = acc[k];
      reinterpret_cast<float4*>(out + (static_cast<long long>(n) * h + j)
                                * d)[c] =
          make_float4(__fadd_rn(o.x, __fmul_rn(w, self4.x)),
                      __fadd_rn(o.y, __fmul_rn(w, self4.y)),
                      __fadd_rn(o.z, __fmul_rn(w, self4.z)),
                      __fadd_rn(o.w, __fmul_rn(w, self4.w)));
    }
  }
}

template <int V, typename T>
int launch(const float* qk, const T* cache, const float* hn_self,
           const int* lane, const long long* pos, float* out,
           const LaneAttentionArgs& a, cudaStream_t stream) {
  lane_attention_kernel<V, T><<<dim3(static_cast<unsigned>(a.n)),
                                dim3(32 * a.warps),
                                static_cast<size_t>(a.smem_bytes), stream>>>(
      qk, cache, hn_self, lane, pos, out, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(const float* qk, const T* cache, const float* hn_self,
               const int* lane, const long long* pos, float* out,
               const LaneAttentionArgs& a, cudaStream_t stream) {
  switch ((a.d / 4 + 31) / 32) {
    case 1: return launch<1>(qk, cache, hn_self, lane, pos, out, a, stream);
    case 2: return launch<2>(qk, cache, hn_self, lane, pos, out, a, stream);
    case 3: return launch<3>(qk, cache, hn_self, lane, pos, out, a, stream);
    case 4: return launch<4>(qk, cache, hn_self, lane, pos, out, a, stream);
    case 5: return launch<5>(qk, cache, hn_self, lane, pos, out, a, stream);
    case 6: return launch<6>(qk, cache, hn_self, lane, pos, out, a, stream);
    case 7: return launch<7>(qk, cache, hn_self, lane, pos, out, a, stream);
    case 8: return launch<8>(qk, cache, hn_self, lane, pos, out, a, stream);
    default: return kBadPlan;
  }
}

bool aligned(const void* p, int unit) {
  return reinterpret_cast<unsigned long long>(p) % unit == 0;
}

}  // namespace

extern "C" int sc_lane_attention(const float* qk, const void* cache,
                                 const float* hn_self, const int* lane,
                                 const long long* pos, float* out,
                                 const LaneAttentionArgs* a,
                                 void* stream_ptr) {
  if (a->n <= 0) return 0;
  const int units = a->d / 4;
  const int threads = 32 * a->warps;
  if (a->d <= 0 || a->d % 4 != 0 || units > 32 * kMaxVec || a->h <= 0
      || a->h > kMaxHeads || a->lmax <= 0 || a->beam <= 0
      || a->n % a->beam != 0 || (a->warps != 8 && a->warps != 16)
      || units > threads || a->sqrt_dk <= 0.0f)
    return kBadPlan;
  const long long need = 4LL * a->h * a->d + 8LL * a->lmax
                         + 4LL * a->h * (a->lmax + 1);
  if (a->smem_bytes != need || need > kMaxShared) return kBadPlan;
  // Every float4 the kernel loads starts on 16 bytes (8 in a bfloat16
  // cache): the pointers and the strides.
  const int unit = 4 * a->cache_bytes;
  if (!aligned(qk, 16) || a->qk_ns % 4 || a->qk_hs % 4
      || !aligned(hn_self, 16) || a->hn_rs % 4 || !aligned(out, 16)
      || !aligned(cache, unit) || a->cache_rs % 4 || a->cache_ps % 4
      || !aligned(lane, 4) || !aligned(pos, 8))
    return kBadPlan;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (a->cache_bytes) {
    case 4:
      return launch_vec(qk, static_cast<const float*>(cache), hn_self, lane,
                        pos, out, *a, stream);
    case 2:
      return launch_vec(qk, static_cast<const __nv_bfloat16*>(cache),
                        hn_self, lane, pos, out, *a, stream);
    default:
      return kBadPlan;
  }
}

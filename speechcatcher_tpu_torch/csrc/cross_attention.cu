// The decoder beam step's cross-attention over a block's projected K/V
// (kernel H), sm_90a.
//
// Replaces no TPU kernel: the JAX package's cross-attention is XLA. In the
// port's beam step (models/decoder.py::decoder_step) each layer
// contracted the queries of a stream's B hypotheses with all T rows of its
// head-major K and V ring, (S, h, T, dk), through two batched cuBLAS
// products, masked the rows at or past the stream's encoder length and
// re-laid out the query and the output: ten ATen kernels a layer (the two
// products, the division, two fills, two selects, the softmax and two
// re-layouts), the products and the mask over all T = ECAP_PAD rows. This kernel is all of them, for
// stream s, head j and the stream's L = min(enc_len[s], T) visible rows:
//     q_b      = q[s*B + b, j*dk : (j+1)*dk], rounded to the K/V dtype
//     score_bt = q_b . K[s, j, t] / sqrt(dk),               t < L
//     w_bt     = softmax_t(score_b) (max, exp, sum, divide), rounded to
//                the V dtype
//     out[s*B + b, j*dk : (j+1)*dk] = sum_t w_bt V[s, j, t]
// Rows at t >= L are never read. The composition gave them MASK_MIN
// scores, whose exp is exactly 0, and zero weights: only the order of the
// float32 sums differs. L = 0 gives exact zeros, as the masked composition
// does. Plain float32 FMAs on the widened rows, no TF32, no tensor cores.
//
// Bound on the H100: bytes. At the drain's width 32 (S 32, h 8, dk 64,
// B 3) and L 175 a call reads 2 x 11.5 MB of K/V rows, 6.8 us at 3.35
// TB/s, against 34 MFLOP (0.5 us at 67 TFLOP/s); the composition read all
// 832 rows, 2 x 54.5 MB. So one block a (stream, head), whose B queries
// share every row it loads:
//   1. the B queries (B x dk floats) go to shared memory;
//   2. scores: G lanes take a row, VPL float4s (four columns, 16 bytes of
//      a float32 row, 8 of a bfloat16 one) a lane: dk, a power of two from
//      4 to 256, gives G = dk / 16 and VPL 4 from dk 16 up, G 1 and VPL
//      dk / 4 below; a warp takes 32/G rows at once and two such sets in
//      flight; each query's dot is summed over the G lanes by shuffles;
//      the B x L scores stay in shared memory (B x T floats planned; past
//      48 KB, as a 2048-frame ring at dk 128 and beam 5 needs, the launch
//      opts in to Hopper's 227 KB);
//   3. a warp a query runs the exact softmax in place;
//   4. the weighted sum reads the V rows in the same layout, four queries
//      at a time in registers, sums a warp's rows by shuffles and the
//      warps' partial sums in shared memory, in a fixed order.
// The grid is fixed by (S, h) and each block's trip count comes from
// enc_len on the device, so a call captures into a CUDA graph. The plan
// gives 8 warps a block while the (stream, head) blocks do not fill two
// blocks an SM, else 4 (cross_attention.py::warps_per_block).
//
// The entry point takes the pointers, the caller's cached plan (a struct of
// the launch's integers, passed by address) and the stream, and returns 0,
// a cudaError_t, or kBadPlan when the plan or the pointers do not fit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// At namespace scope: a type of an unnamed namespace in the signature
// would give the extern "C" entry point internal linkage.
struct CrossAttentionArgs {  // mirrors cross_attention.py::_Args
  long long q_ns;                    // q's row stride
  long long kv_ss, kv_hs, kv_ts;     // K/V strides on streams, heads, rows
  long long len_ss;                  // enc_len's stride
  int s, h, t, dk, beam;
  int group;                         // lanes a row: max(1, dk / 16)
  int warps;                         // 4 or 8 a block
  int kv_bytes;                      // 4 or 2
  int len_bytes;                     // 4 or 8
  int smem_bytes;
  float sqrt_dk;
};

namespace {

constexpr int kBadPlan = -1;
constexpr int kQueries = 4;          // queries a weighted-sum pass holds
constexpr int kSets = 2;             // row sets a warp loads at once
constexpr int kDefaultShared = 48 * 1024;  // without the opt-in
constexpr int kMaxShared = 232448;         // a block's opt-in limit, Hopper
constexpr int kMaxDevices = 64;
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

// A float rounded to the K/V element type and widened back: the identity
// for float32, round-to-nearest-even to bfloat16 otherwise.
__device__ __forceinline__ float as_kv(float x, const float*) { return x; }

__device__ __forceinline__ float as_kv(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

__device__ __forceinline__ float4 shfl_add4(float4 v, int off) {
  return make_float4(v.x + __shfl_xor_sync(kFull, v.x, off),
                     v.y + __shfl_xor_sync(kFull, v.y, off),
                     v.z + __shfl_xor_sync(kFull, v.z, off),
                     v.w + __shfl_xor_sync(kFull, v.w, off));
}

// Row t's float4 columns k + G v (v < VPL) of the lane's share, zeros
// where t >= len: lane k of a row's G lanes, so that each load instruction
// of a warp reads G consecutive float4s of each of its rows.
template <int VPL, typename T>
__device__ __forceinline__ void load_row(float4 (&r)[VPL], const T* rows,
                                         long long row_stride, int t,
                                         int len, int k, int group) {
#pragma unroll
  for (int v = 0; v < VPL; ++v)
    r[v] = t < len ? load4(rows + t * row_stride + 4 * (k + group * v))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// VPL: float4 columns of a row a lane (dk / (4 G)). T: the K/V element
// type. One block a (stream, head).
template <int VPL, typename T>
__global__ void __launch_bounds__(256) cross_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ mk,
    const T* __restrict__ mv, const void* __restrict__ enc_len,
    float* __restrict__ out, CrossAttentionArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int beam = a.beam, dk = a.dk, tcap = a.t, group = a.group;
  // The float4 views (q_s, red_s) first: dk is a multiple of 4, T is not.
  float* q_s = reinterpret_cast<float*>(smem);            // beam x dk
  float* red_s = q_s + beam * dk;                          // warps x 4 x dk
  float* score_s = red_s + a.warps * kQueries * dk;        // beam x tcap

  const int s = blockIdx.x / a.h, j = blockIdx.x - s * a.h;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = threads >> 5;
  const int per_warp = 32 / group;            // rows a warp takes at once
  const int r = lane / group, k = lane - r * group;
  const long long raw_len =
      a.len_bytes == 8
          ? static_cast<const long long*>(enc_len)[s * a.len_ss]
          : static_cast<long long>(
                static_cast<const int*>(enc_len)[s * a.len_ss]);
  const int len = raw_len <= 0 ? 0
                  : (raw_len >= tcap ? tcap : static_cast<int>(raw_len));
  const long long base = s * a.kv_ss + j * a.kv_hs;
  const T* krows = mk + base;
  const T* vrows = mv + base;

  // 1. The stream's B queries of head j, rounded to the K/V dtype.
  for (int i = tid; i < beam * dk; i += threads) {
    const int b = i / dk, c = i - b * dk;
    q_s[i] = as_kv(q[(static_cast<long long>(s) * beam + b) * a.q_ns
                     + j * dk + c], mk);
  }
  __syncthreads();

  // 2. Scores: a warp takes kSets sets of per_warp rows at once, every
  // lane of a row's G lanes its VPL float4s; each float4 of a row serves
  // all B queries.
  const int stride = kSets * warps * per_warp;
  for (int t0 = warp * kSets * per_warp; t0 < len; t0 += stride) {
    float4 rows[kSets][VPL];
#pragma unroll
    for (int u = 0; u < kSets; ++u)
      load_row(rows[u], krows, a.kv_ts, t0 + u * per_warp + r, len, k,
               group);
    for (int b = 0; b < beam; ++b) {
      const float4* qb = reinterpret_cast<const float4*>(q_s + b * dk);
#pragma unroll
      for (int u = 0; u < kSets; ++u) {
        float acc = 0.0f;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          acc = dot4(qb[k + group * v], rows[u][v], acc);
        for (int off = group >> 1; off > 0; off >>= 1)
          acc += __shfl_xor_sync(kFull, acc, off);
        const int t = t0 + u * per_warp + r;
        if (k == 0 && t < len)
          score_s[b * tcap + t] = __fdiv_rn(acc, a.sqrt_dk);
      }
    }
  }
  __syncthreads();

  // 3. The softmax of each query over its len scores, in place, the
  // weights rounded to the V dtype.
  for (int b = warp; b < beam; b += warps) {
    float* sc = score_s + b * tcap;
    float mx = __int_as_float(0xff800000);                 // -inf
    for (int t = lane; t < len; t += 32) mx = fmaxf(mx, sc[t]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int t = lane; t < len; t += 32) {
      const float e = expf(__fsub_rn(sc[t], mx));
      sc[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < len; t += 32)
      sc[t] = as_kv(__fdiv_rn(sc[t], sum), mv);
  }
  __syncthreads();

  // 4. The weighted sum, kQueries queries at a time: each lane sums its
  // rows' columns, a warp's rows are summed by shuffles, the warps'
  // partial sums in shared memory in warp order.
  for (int b0 = 0; b0 < beam; b0 += kQueries) {
    float4 acc[kQueries][VPL];
#pragma unroll
    for (int i = 0; i < kQueries; ++i)
#pragma unroll
      for (int v = 0; v < VPL; ++v) acc[i][v] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t0 = warp * kSets * per_warp; t0 < len; t0 += stride) {
      float4 rows[kSets][VPL];
#pragma unroll
      for (int u = 0; u < kSets; ++u)
        load_row(rows[u], vrows, a.kv_ts, t0 + u * per_warp + r, len, k,
                 group);
#pragma unroll
      for (int u = 0; u < kSets; ++u) {
        const int t = t0 + u * per_warp + r;
        if (t >= len) continue;
#pragma unroll
        for (int i = 0; i < kQueries; ++i) {
          if (b0 + i >= beam) continue;
          const float w = score_s[(b0 + i) * tcap + t];
#pragma unroll
          for (int v = 0; v < VPL; ++v)
            acc[i][v] = axpy4(w, rows[u][v], acc[i][v]);
        }
      }
    }
    for (int off = group; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < kQueries; ++i)
#pragma unroll
        for (int v = 0; v < VPL; ++v) acc[i][v] = shfl_add4(acc[i][v], off);
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < kQueries; ++i)
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          reinterpret_cast<float4*>(red_s + (warp * kQueries + i) * dk)
              [k + group * v] = acc[i][v];
    }
    __syncthreads();
    for (int e = tid; e < kQueries * dk; e += threads) {
      const int i = e / dk, c = e - i * dk;
      if (b0 + i >= beam) continue;
      float sum = 0.0f;
      for (int w = 0; w < warps; ++w) sum += red_s[(w * kQueries + i) * dk + c];
      out[(static_cast<long long>(s) * beam + b0 + i) * a.h * dk + j * dk
          + c] = sum;
    }
    __syncthreads();
  }
}

template <int VPL, typename T>
int launch(const float* q, const T* mk, const T* mv, const void* enc_len,
           float* out, const CrossAttentionArgs& a, cudaStream_t stream) {
  if (a.smem_bytes > kDefaultShared) {
    // Opt in to large dynamic shared memory once per device.
    static bool allowed[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices) return kBadPlan;
    if (!allowed[dev]) {
      err = cudaFuncSetAttribute(cross_attention_kernel<VPL, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed[dev] = true;
    }
  }
  cross_attention_kernel<VPL, T>
      <<<dim3(static_cast<unsigned>(a.s * a.h)), dim3(32 * a.warps),
         static_cast<size_t>(a.smem_bytes), stream>>>(q, mk, mv, enc_len,
                                                      out, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(const float* q, const T* mk, const T* mv, const void* enc_len,
               float* out, const CrossAttentionArgs& a, cudaStream_t stream) {
  switch (a.dk / (4 * a.group)) {
    case 1: return launch<1>(q, mk, mv, enc_len, out, a, stream);
    case 2: return launch<2>(q, mk, mv, enc_len, out, a, stream);
    case 4: return launch<4>(q, mk, mv, enc_len, out, a, stream);
    default: return kBadPlan;
  }
}

bool aligned(const void* p, int unit) {
  return reinterpret_cast<unsigned long long>(p) % unit == 0;
}

}  // namespace

extern "C" int sc_cross_attention(const float* q, const void* mk,
                                  const void* mv, const void* enc_len,
                                  float* out, const CrossAttentionArgs* a,
                                  void* stream_ptr) {
  if (a->s <= 0 || a->h <= 0) return 0;
  if (a->dk < 4 || a->dk > 256 || (a->dk & (a->dk - 1)) != 0
      || a->group != (a->dk < 16 ? 1 : a->dk / 16) || a->t <= 0
      || a->beam <= 0 || (a->warps != 4 && a->warps != 8)
      || (a->kv_bytes != 4 && a->kv_bytes != 2)
      || (a->len_bytes != 4 && a->len_bytes != 8) || a->sqrt_dk <= 0.0f)
    return kBadPlan;
  const long long need =
      4LL * (static_cast<long long>(a->beam) * (a->dk + a->t)
             + static_cast<long long>(a->warps) * kQueries * a->dk);
  if (a->smem_bytes != need || need > kMaxShared) return kBadPlan;
  // Every float4 the kernel loads starts on 16 bytes (8 of bfloat16 K/V):
  // the pointers and the strides.
  const int unit = 4 * a->kv_bytes;
  if (!aligned(q, 4) || !aligned(out, 4) || !aligned(mk, unit)
      || !aligned(mv, unit) || a->kv_ss % 4 || a->kv_hs % 4 || a->kv_ts % 4
      || !aligned(enc_len, a->len_bytes))
    return kBadPlan;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (a->kv_bytes == 4)
    return launch_vec(q, static_cast<const float*>(mk),
                      static_cast<const float*>(mv), enc_len, out, *a,
                      stream);
  return launch_vec(q, static_cast<const __nv_bfloat16*>(mk),
                    static_cast<const __nv_bfloat16*>(mv), enc_len, out, *a,
                    stream);
}

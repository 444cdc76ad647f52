// Residual add, bias add, LayerNorm and the decoder cache's row write in
// one pass over each row (kernel F), sm_90a.
//
// Replaces no TPU kernel: the JAX package's norms are XLA fusions. In the
// port's beam step (models/decoder.py::decoder_step) each of the 19 norms
// of a step was ten ATen kernels, its input two more (the preceding
// linear's bias add and the residual add), and norm1's cache append three
// more; this kernel is all of them:
//     h_new = h + (y + bias)                          (y, bias optional)
//     hn    = (h_new - mean) * rsqrt(var + eps) * weight + beta
//     var   = mean((h_new - mean)^2)
//     cache[row, pos[row]] = hn  where write[row] and 0 <= pos[row] < Lmax
// The sums are those of the PyTorch composition in the same order
// (h + (y + bias)); the elementwise arithmetic uses the _rn intrinsics, so
// nothing is contracted into an FMA and only the order of the two float32
// reductions differs from PyTorch's. A bfloat16 cache stores the RNE cast.
//
// Bound on the H100: latency. The beam step's rows are (96, 512) at width
// 32, (768, 512) at 256: 0.2-1.6 MB in and out, 0.1-0.5 us at 3.35 TB/s.
// So one warp per row, the row held in registers as float4s (d / 128 a
// lane, rounded up), both moments by warp shuffles: no shared memory, no
// __syncthreads, one read of each input and one write of each output.
// Several rows a block once there are rows enough to give each of the 132
// SMs more than one (the plan's rows_per_block).
//
// The entry point takes the pointers, the caller's cached plan (a struct of
// the launch's integers, passed by address) and the stream, and returns 0,
// a cudaError_t, or kBadPlan when the plan or the pointers do not fit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// At namespace scope: a type of an unnamed namespace in the signature
// would give the extern "C" entry point internal linkage.
struct AddLayerNormArgs {  // mirrors add_layer_norm.py::_Args
  long long h_rs, y_rs;              // row strides (elements) of h and y
  long long cache_rs, cache_ps;      // cache strides on rows and positions
  int n, d, lmax;
  int has_y, has_bias;
  int cache_bytes;                   // 0: no cache write; 4 or 2
  int rows_per_block;
  float eps;
};

namespace {

constexpr int kBadPlan = -1;
constexpr int kMaxVec = 8;           // float4s a lane: d <= 1024

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float norm1(float x, float mean, float rstd,
                                       float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), w), b);
}

__device__ __forceinline__ float4 norm4(float4 x, float mean, float rstd,
                                        float4 w, float4 b) {
  return make_float4(norm1(x.x, mean, rstd, w.x, b.x),
                     norm1(x.y, mean, rstd, w.y, b.y),
                     norm1(x.z, mean, rstd, w.z, b.z),
                     norm1(x.w, mean, rstd, w.w, b.w));
}

__device__ __forceinline__ float sq(float x, float mean) {
  const float c = __fsub_rn(x, mean);
  return __fmul_rn(c, c);
}

// kCache: 0 no cache write, 4 a float32 cache, 2 a bfloat16 cache.
template <int V, int kCache>
__global__ void add_layer_norm_kernel(
    const float* __restrict__ h, const float* __restrict__ y,
    const float* __restrict__ bias, const float* __restrict__ weight,
    const float* __restrict__ beta, float* __restrict__ h_out,
    float* __restrict__ hn, void* __restrict__ cache,
    const long long* __restrict__ pos, const bool* __restrict__ write,
    AddLayerNormArgs a) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * a.rows_per_block
                        + (threadIdx.x >> 5);
  if (row >= a.n) return;                           // the whole warp
  const int units = a.d >> 2;
  const float4* hr = reinterpret_cast<const float4*>(h + row * a.h_rs);
  const float4* yr = reinterpret_cast<const float4*>(y + row * a.y_rs);
  const float4* br = reinterpret_cast<const float4*>(bias);

  float4 x[V];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int u = lane + 32 * k;
    x[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (u < units) {
      float4 v = hr[u];
      if (a.has_y) {
        float4 t = yr[u];
        if (a.has_bias) t = add4(t, br[u]);
        v = add4(v, t);
      }
      x[k] = v;
      sum += (v.x + v.y) + (v.z + v.w);
    }
  }
  const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(a.d));
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (lane + 32 * k < units)
      ss += (sq(x[k].x, mean) + sq(x[k].y, mean))
            + (sq(x[k].z, mean) + sq(x[k].w, mean));
  }
  const float var = __fdiv_rn(warp_sum(ss), static_cast<float>(a.d));
  const float rstd = rsqrtf(__fadd_rn(var, a.eps));

  long long p = -1;
  if (kCache != 0 && write[row]) {
    const long long at = pos[row];
    if (at >= 0 && at < a.lmax) p = at;
  }
  const float4* wr = reinterpret_cast<const float4*>(weight);
  const float4* er = reinterpret_cast<const float4*>(beta);
  float4* ho = reinterpret_cast<float4*>(h_out + row * a.d);
  float4* no = reinterpret_cast<float4*>(hn + row * a.d);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int u = lane + 32 * k;
    if (u >= units) continue;
    if (a.has_y) ho[u] = x[k];
    const float4 o = norm4(x[k], mean, rstd, wr[u], er[u]);
    no[u] = o;
    if (kCache == 4 && p >= 0) {
      reinterpret_cast<float4*>(static_cast<float*>(cache) + row * a.cache_rs
                                + p * a.cache_ps)[u] = o;
    } else if (kCache == 2 && p >= 0) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(o.z, o.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const unsigned int*>(&lo);
      packed.y = *reinterpret_cast<const unsigned int*>(&hi);
      reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(cache)
                               + row * a.cache_rs + p * a.cache_ps)[u] =
          packed;
    }
  }
}

template <int V>
int launch_vec(const float* h, const float* y, const float* bias,
               const float* weight, const float* beta, float* h_out,
               float* hn, void* cache, const long long* pos,
               const bool* write, const AddLayerNormArgs& a,
               cudaStream_t stream) {
  const long long blocks =
      (static_cast<long long>(a.n) + a.rows_per_block - 1) / a.rows_per_block;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(32 * a.rows_per_block);
  switch (a.cache_bytes) {
    case 0:
      add_layer_norm_kernel<V, 0><<<grid, block, 0, stream>>>(
          h, y, bias, weight, beta, h_out, hn, cache, pos, write, a);
      break;
    case 4:
      add_layer_norm_kernel<V, 4><<<grid, block, 0, stream>>>(
          h, y, bias, weight, beta, h_out, hn, cache, pos, write, a);
      break;
    case 2:
      add_layer_norm_kernel<V, 2><<<grid, block, 0, stream>>>(
          h, y, bias, weight, beta, h_out, hn, cache, pos, write, a);
      break;
    default:
      return kBadPlan;
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int unit) {
  return reinterpret_cast<unsigned long long>(p) % unit == 0;
}

}  // namespace

extern "C" int sc_add_layer_norm(const float* h, const float* y,
                                 const float* bias, const float* weight,
                                 const float* beta, float* h_out, float* hn,
                                 void* cache, const long long* pos,
                                 const bool* write,
                                 const AddLayerNormArgs* a,
                                 void* stream_ptr) {
  if (a->n <= 0) return 0;
  if (a->d <= 0 || a->d % 4 != 0 || a->d > 32 * 4 * kMaxVec
      || a->rows_per_block < 1 || a->rows_per_block > 32
      || a->n / a->rows_per_block >= 0x7fffffffLL)
    return kBadPlan;
  // Every float4 the kernel touches starts on 16 bytes (8 in a bfloat16
  // cache): the pointers and the row strides.
  if (!aligned(h, 16) || a->h_rs % 4 || !aligned(weight, 16)
      || !aligned(beta, 16) || !aligned(hn, 16))
    return kBadPlan;
  if (a->has_y && (!aligned(y, 16) || a->y_rs % 4 || !aligned(h_out, 16)
                   || (a->has_bias && !aligned(bias, 16))))
    return kBadPlan;
  if (a->cache_bytes != 0
      && (!aligned(cache, 4 * a->cache_bytes) || a->cache_rs % 4
          || a->cache_ps % 4 || pos == nullptr || write == nullptr))
    return kBadPlan;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch ((a->d / 4 + 31) / 32) {
    case 1: return launch_vec<1>(h, y, bias, weight, beta, h_out, hn, cache,
                                 pos, write, *a, stream);
    case 2: return launch_vec<2>(h, y, bias, weight, beta, h_out, hn, cache,
                                 pos, write, *a, stream);
    case 3: return launch_vec<3>(h, y, bias, weight, beta, h_out, hn, cache,
                                 pos, write, *a, stream);
    case 4: return launch_vec<4>(h, y, bias, weight, beta, h_out, hn, cache,
                                 pos, write, *a, stream);
    case 5: return launch_vec<5>(h, y, bias, weight, beta, h_out, hn, cache,
                                 pos, write, *a, stream);
    case 6: return launch_vec<6>(h, y, bias, weight, beta, h_out, hn, cache,
                                 pos, write, *a, stream);
    case 7: return launch_vec<7>(h, y, bias, weight, beta, h_out, hn, cache,
                                 pos, write, *a, stream);
    case 8: return launch_vec<8>(h, y, bias, weight, beta, h_out, hn, cache,
                                 pos, write, *a, stream);
    default: return kBadPlan;
  }
}

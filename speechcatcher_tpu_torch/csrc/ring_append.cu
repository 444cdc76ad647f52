// In-place appends on the engine's rings, sm_90a: columns of the time-minor
// CTC log-prob ring (kernel C) and rows of the (L, S, T, D) frame rings
// (kernel D).
//
// Both read `new` as its producer leaves it: any strides (given in
// elements by the caller's launch plan), and float32 into a bfloat16 ring
// through __float2bfloat16_rn, the same round-to-nearest-even as
// `.to(torch.bfloat16)` and as the TPU kernels' `new.astype(ring.dtype)`.
// So no copy kernel runs in front of either.
//
// Each entry point takes the four pointers, the caller's cached plan (a
// struct of the launch's integers, passed by address) and the stream, and
// returns 0, a cudaError_t, or kBadPlan when the plan or the pointers do not
// fit the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBadPlan = -1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace

// ---------------------------------------------------------------------------
// Kernel C: ring_append_cols.
//
// Replaces speechcatcher_tpu/ops/pallas/ring_append.py::ring_append_cols
// (_append_cols_kernel, pallas_call at :227):
//     ring[s, :, start[s] + i] = new[s, :, i]   for i < min(n_new[s], TN)
// with start clipped to [0, T-1] and columns at or past T dropped.
//
// Bound on the H100: bytes, only the written ones: S x V x n_new elements
// read from `new` and written into the ring (16 x 1024 floats per block at
// the flagship, 64 KB each way), 0.04 us at 3.35 TB/s; at these sizes the
// call is launch- and latency-bound. The main path's `new` is the
// transposed view of time-major (S, TN, V) log-probs, so reading along v
// and writing along t cross: a block stages a (TI columns x TV rows) tile
// through shared memory, rows padded by one float (no bank conflicts in
// either direction). Each thread issues its four loads before it touches
// shared memory (one memory round trip), reading consecutive v of one frame
// (coalesced when new's v stride is 1; a time-minor `new` is read along t
// instead), then writes, for each v, TI consecutive ring columns (64 B runs
// at TI = 16 in float32). Only the written columns move.

// At namespace scope: a type of an unnamed namespace in the signature
// would give the extern "C" entry point internal linkage.
struct ColsArgs {           // mirrors ring_append.py::_ColsArgs
  long long new_ss, new_sv, new_st;  // new's strides (elements) on s, v, t
  int s_dim, v_dim, t_cap, tn;
  int in_bytes, out_bytes;           // element sizes of new and of the ring
  int t_fastest;                     // read new along t (its t stride is 1)
};

namespace {

constexpr int kColThreads = 256;
constexpr int kColPer = 4;                          // elements per thread
constexpr int kTile = kColThreads * kColPer;        // TI x TV
constexpr int kMaxTi = 32;

template <typename In, typename Out>
__global__ void __launch_bounds__(kColThreads)
ring_append_cols_kernel(Out* __restrict__ ring, const In* __restrict__ add,
                        const int* __restrict__ start,
                        const int* __restrict__ n_new, ColsArgs a,
                        int ti_log2) {
  __shared__ float tile[kTile + kMaxTi];            // TI rows of TV + 1
  const int ti = 1 << ti_log2;
  const int tv_log2 = 10 - ti_log2;                 // kTile = 1024
  const int tv = 1 << tv_log2;
  const int s = blockIdx.z;
  const int v0 = blockIdx.x * tv;
  const int i0 = blockIdx.y * ti;
  const int st = min(max(start[s], 0), a.t_cap - 1);
  const int cnt = min(min(n_new[s], a.tn), a.t_cap - st);
  if (i0 >= cnt) return;                            // the whole block
  const In* src = add + s * a.new_ss;

  float val[kColPer];
  int slot[kColPer];
#pragma unroll
  for (int k = 0; k < kColPer; ++k) {
    const int e = threadIdx.x + k * kColThreads;
    int i, v;
    if (a.t_fastest) {
      i = e & (ti - 1);
      v = e >> ti_log2;
    } else {
      v = e & (tv - 1);
      i = e >> tv_log2;
    }
    slot[k] = i * (tv + 1) + v;
    const int gi = i0 + i, gv = v0 + v;
    val[k] = (gi < cnt && gv < a.v_dim)
                 ? to_float(src[gv * a.new_sv + gi * a.new_st])
                 : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kColPer; ++k) tile[slot[k]] = val[k];
  __syncthreads();
  Out* dst = ring + static_cast<long long>(s) * a.v_dim * a.t_cap + st;
#pragma unroll
  for (int k = 0; k < kColPer; ++k) {
    const int e = threadIdx.x + k * kColThreads;
    const int i = e & (ti - 1);
    const int v = e >> ti_log2;
    const int gi = i0 + i, gv = v0 + v;
    if (gi < cnt && gv < a.v_dim)
      dst[static_cast<long long>(gv) * a.t_cap + gi] =
          from_float<Out>(tile[i * (tv + 1) + v]);
  }
}

template <typename In, typename Out>
int launch_cols(void* ring, const void* add, const int* start,
                const int* n_new, const ColsArgs& a, cudaStream_t stream) {
  // TI: the narrowest of 8, 16, 32 columns that holds TN (32 above).
  const int ti_log2 = a.tn <= 8 ? 3 : (a.tn <= 16 ? 4 : 5);
  const int tv = kTile >> ti_log2;
  const dim3 grid((a.v_dim + tv - 1) / tv, (a.tn + (1 << ti_log2) - 1) >> ti_log2,
                  a.s_dim);
  ring_append_cols_kernel<In, Out><<<grid, kColThreads, 0, stream>>>(
      static_cast<Out*>(ring), static_cast<const In*>(add), start, n_new, a,
      ti_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sc_ring_append_cols(void* ring, const void* add,
                                   const int* start, const int* n_new,
                                   const ColsArgs* a, void* stream_ptr) {
  if (a->s_dim <= 0 || a->v_dim <= 0 || a->tn <= 0 || a->t_cap <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (a->in_bytes == 4 && a->out_bytes == 4)
    return launch_cols<float, float>(ring, add, start, n_new, *a, stream);
  if (a->in_bytes == 2 && a->out_bytes == 2)
    return launch_cols<__nv_bfloat16, __nv_bfloat16>(ring, add, start, n_new,
                                                     *a, stream);
  if (a->in_bytes == 4 && a->out_bytes == 2)
    return launch_cols<float, __nv_bfloat16>(ring, add, start, n_new, *a,
                                             stream);
  return kBadPlan;
}

// ---------------------------------------------------------------------------
// Kernel D: ring_append_rows.
//
// Replaces speechcatcher_tpu/ops/pallas/ring_append.py::ring_append_rows
// (_append_rows_kernel, pallas_call at :147):
//     cache[l, s, start[s] + i, :] = new[l, s, i, :]  for i < min(n_new[s], TN)
// with start clipped to [0, T-1] and rows at or past T dropped.
//
// Bound on the H100: bytes, only the written rows: L x S x n x D elements
// read and written (0.66 MB each way at the engine's enc_out append, 8
// slots x 40 rows x 512 floats: 0.39 us). The TPU kernel moved whole 64-row
// windows through VMEM and shifted them with pltpu.roll; here one warp
// copies one written row (or one segment of 128 units of a longer row), so
// a 40-row append at 8 slots runs 320 warps over the 132 SMs, and each lane
// issues all of its (at most four) loads before its stores: one memory
// round trip per row. Equal dtypes move as raw bytes, in 16-byte units
// where the row pitch, new's strides and both base pointers allow it, else
// 4 or 2; float32 into bfloat16 reads 16 B of floats and writes 8 B of
// bf16 (4 B and 2 B where unaligned). The copy is global to global with no
// reuse, so TMA or shared-memory staging would add a hop and save nothing.

struct RowsArgs {           // mirrors ring_append.py::_RowsArgs
  long long new_sl, new_ss, new_st;  // new's strides (elements) on l, s, t
  int l_dim, s_dim, t_cap, tn, d;    // d: row length (elements)
  int in_bytes, out_bytes;           // element sizes of new and of the cache
};

namespace {

constexpr int kUnitsPerLane = 4;
constexpr int kSegUnits = 32 * kUnitsPerLane;       // units one warp copies

template <typename U>
struct RawCopy {                    // equal dtypes: raw units of U
  using In = U;
  using Out = U;
  __device__ __forceinline__ static Out cvt(In x) { return x; }
};

struct alignas(8) Bf16x4 {
  __nv_bfloat16 v[4];
};

struct CastF32x4 {                  // 4 floats in, 4 bf16 out
  using In = float4;
  using Out = Bf16x4;
  __device__ __forceinline__ static Out cvt(In x) {
    Out o;
    o.v[0] = __float2bfloat16_rn(x.x);
    o.v[1] = __float2bfloat16_rn(x.y);
    o.v[2] = __float2bfloat16_rn(x.z);
    o.v[3] = __float2bfloat16_rn(x.w);
    return o;
  }
};

struct CastF32 {                    // 1 float in, 1 bf16 out
  using In = float;
  using Out = __nv_bfloat16;
  __device__ __forceinline__ static Out cvt(In x) {
    return __float2bfloat16_rn(x);
  }
};

// units: In units per row; n_seg: warps per row.
template <typename Op>
__global__ void ring_append_rows_kernel(char* __restrict__ cache,
                                        const char* __restrict__ add,
                                        const int* __restrict__ start,
                                        const int* __restrict__ n_new,
                                        RowsArgs a, int units, int n_seg) {
  using In = typename Op::In;
  using Out = typename Op::Out;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = static_cast<int>(warp % n_seg);
  const long long row = warp / n_seg;               // (l * S + s) * TN + i
  const int i = static_cast<int>(row % a.tn);
  const long long ls = row / a.tn;
  if (ls >= static_cast<long long>(a.l_dim) * a.s_dim) return;
  const int s = static_cast<int>(ls % a.s_dim);
  const int l = static_cast<int>(ls / a.s_dim);
  const int st = min(max(start[s], 0), a.t_cap - 1);
  const int cnt = min(min(n_new[s], a.tn), a.t_cap - st);
  if (i >= cnt) return;
  const In* src = reinterpret_cast<const In*>(
      add + (l * a.new_sl + s * a.new_ss + i * a.new_st) * a.in_bytes);
  Out* dst = reinterpret_cast<Out*>(
      cache + ((ls * a.t_cap + st + i) * a.d) * a.out_bytes);
  const int u0 = seg * kSegUnits + lane;
  In v[kUnitsPerLane];
#pragma unroll
  for (int k = 0; k < kUnitsPerLane; ++k) {
    const int u = u0 + 32 * k;
    if (u < units) v[k] = src[u];
  }
#pragma unroll
  for (int k = 0; k < kUnitsPerLane; ++k) {
    const int u = u0 + 32 * k;
    if (u < units) dst[u] = Op::cvt(v[k]);
  }
}

template <typename Op>
int launch_rows(void* cache, const void* add, const int* start,
                const int* n_new, const RowsArgs& a, int units,
                cudaStream_t stream) {
  const int n_seg = (units + kSegUnits - 1) / kSegUnits;
  const long long warps =
      static_cast<long long>(a.l_dim) * a.s_dim * a.tn * n_seg;
  // Enough blocks to cover the 132 SMs where the rows allow it.
  const int wpb = warps >= 4 * 132 ? 4 : (warps >= 2 * 132 ? 2 : 1);
  const long long blocks = (warps + wpb - 1) / wpb;
  if (blocks > 0x7fffffffLL) return kBadPlan;
  ring_append_rows_kernel<Op><<<static_cast<unsigned>(blocks), 32 * wpb, 0,
                                stream>>>(
      static_cast<char*>(cache), static_cast<const char*>(add), start, n_new,
      a, units, n_seg);
  return static_cast<int>(cudaGetLastError());
}

// Every byte offset the kernel forms from p and the strides is a multiple
// of `unit`.
bool aligned(const void* p, long long a, long long b, long long c, int unit) {
  return reinterpret_cast<unsigned long long>(p) % unit == 0 && a % unit == 0
         && b % unit == 0 && c % unit == 0;
}

}  // namespace

extern "C" int sc_ring_append_rows(void* cache, const void* add,
                                   const int* start, const int* n_new,
                                   const RowsArgs* a, void* stream_ptr) {
  if (a->l_dim <= 0 || a->s_dim <= 0 || a->tn <= 0 || a->d <= 0) return 0;
  if (a->t_cap <= 0) return kBadPlan;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int ib = a->in_bytes, ob = a->out_bytes;
  const long long row_out = static_cast<long long>(a->d) * ob;
  const long long sl = a->new_sl * ib, ss = a->new_ss * ib, st = a->new_st * ib;
  if (ib == ob) {
    // The widest unit (16, 4 or 2 bytes, never below one element) that
    // every offset allows.
    const auto fits = [&](int unit) {
      return unit >= ib && aligned(add, sl, ss, st, unit)
             && aligned(cache, row_out, 0, 0, unit);
    };
    if (fits(16))
      return launch_rows<RawCopy<uint4>>(cache, add, start, n_new, *a,
                                         static_cast<int>(row_out / 16), stream);
    if (fits(4))
      return launch_rows<RawCopy<unsigned int>>(
          cache, add, start, n_new, *a, static_cast<int>(row_out / 4), stream);
    if (fits(2))
      return launch_rows<RawCopy<unsigned short>>(
          cache, add, start, n_new, *a, static_cast<int>(row_out / 2), stream);
    return kBadPlan;
  }
  if (ib == 4 && ob == 2) {
    if (a->d % 4 == 0 && aligned(add, sl, ss, st, 16)
        && aligned(cache, row_out, 0, 0, 8))
      return launch_rows<CastF32x4>(cache, add, start, n_new, *a, a->d / 4,
                                    stream);
    if (aligned(add, sl, ss, st, 4) && aligned(cache, row_out, 0, 0, 2))
      return launch_rows<CastF32>(cache, add, start, n_new, *a, a->d, stream);
  }
  return kBadPlan;
}

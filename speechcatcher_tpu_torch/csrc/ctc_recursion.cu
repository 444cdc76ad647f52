// CTC prefix forward recursion, sm_90a.
//
// Replaces speechcatcher_tpu/ops/pallas/ctc_recursion.py::
// ctc_forward_recursion (_kernel, pallas_call at :88). For each hypothesis
// and frame t in [start, end):
//     r_n[t] = lse(r_n[t-1], phi[t-1]) + x_n[t]
//     r_b[t] = lse(r_n[t-1], r_b[t-1]) + x_b[t]
// with lse(a, b) = max + log1p(exp(max(min - max, -30))). Outside the range
// r = LOGZERO, except r_n[0] = x_n[0] where the hypothesis has no token yet.
//
// Bound on the H100: the latency of the chain of dependent lse steps, not
// bytes (a hypothesis reads 3 x 768 floats and writes 2 x 768) and not
// arithmetic. The TPU kernel walks a (T, 128) plane frame by frame with the
// hypotheses on the lanes; here the card has 132 SMs and one stream has five
// hypotheses, so:
//   - a block takes one hypothesis. Its threads stage the three rows in
//     shared memory with coalesced loads along T (16 bytes a thread where
//     pointers and strides allow), so no step of the chain waits for device
//     memory, and write every frame outside [start, end) side by side;
//   - only [start, end) is recursed, and as a scan: both lines are affine
//     maps x -> lse(x + a, c) of the (lse, +) semiring (r_n: a = x_n[t],
//     c = x_n[t] + phi[t-1]; r_b, once r_n is known: a = x_b[t],
//     c = x_b[t] + r_n[t-1]), and two maps compose with one lse:
//     (a1, c1) then (a2, c2) = (a1 + a2, lse(c1 + a2, c2)). A thread
//     composes its few consecutive frames, a warp scans its 32 maps with
//     shuffles, one warp scans the warps' totals, and each thread runs the
//     recursion over its own frames from the carry the scan hands it: about
//     16 dependent lse for a line of 768 frames in place of 767. Frames
//     outside the range are left out by predicate (the -30 clamp makes the
//     identity map inexact).
// The sums associate in another order than a frame-by-frame loop, so the
// result equals the plain version within about ten ulps, not to the bit; a
// range that fits one thread's frames, and every fill, is bit-equal.
//
// Two entry points over this body. The reference form has the TPU kernel's
// signature, (T, N) operands of any strides. The main path's form reads the
// scorer's tensors as they lie: time-minor (S, B, T) rows, the blank row
// shared by a stream's hypotheses, phi unshifted, start and end derived from
// the per-stream olen and enc_len, and the frames from end on copied from
// r_src into the (S, B, 2, T) result.
//
// The log-prob rows x_n and x_b come in the ring's dtype, float32 or
// bfloat16 (both alike); phi, r_src and the result are float32. bfloat16 is
// widened where the rows are staged (eight values a 16-byte load), which is
// exact, so everything after staging is one float32 body and the result on
// bfloat16 rows equals, to the last bit, the result on the same rows widened
// to float32 beforehand.
//
// No fast-math: expf / log1pf must round as the reference's do.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// The launch's integers, planned in ops/kernels/ctc_recursion.py (_CtcArgs).
// Strides in elements over stream, beam and time; the reference form is
// s_dim = N streams of beam 1.
struct CtcArgs {
  long long xn_ss, xn_sb, xn_st;
  long long xb_ss, xb_sb, xb_st;
  long long phi_ss, phi_sb, phi_st;
  long long src_ss, src_sb, src_sk;  // r_src over stream, beam, plane
  int s_dim, beam, t_cap;
  int olen_bytes, enc_bytes;         // 4 or 8: int32 or int64 lengths
  int vec;                           // strides allow 16-byte loads
  int row_bytes;                     // 4 or 2: float32 or bfloat16 xn, xb
};

namespace {

constexpr int kBadPlan = -1;
constexpr float kLogZero = -1.0e10f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 5 rows of T floats and the scan's totals within the 48 KB of shared
// memory a block gets without opting in to more.
constexpr int kMaxT = 2448;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float lse2(float a, float b) {
  const float mx = fmaxf(a, b);
  const float mn = fminf(a, b);
  return mx + log1pf(expf(fmaxf(mn - mx, -30.f)));
}

// A bfloat16 row element as its 16 bits; widening is a shift, and exact.
using bf16_bits = uint16_t;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_bits v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Row i of 16 bytes -> shared floats: four float32 or eight bfloat16.
__device__ __forceinline__ void stage16(float* dst, const float* src, int i) {
  reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
}
__device__ __forceinline__ void stage16(float* dst, const bf16_bits* src,
                                        int i) {
  const uint4 v = reinterpret_cast<const uint4*>(src)[i];
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float4 lo, hi;
  lo.x = __uint_as_float(w[0] << 16);
  lo.y = __uint_as_float(w[0] & 0xffff0000u);
  lo.z = __uint_as_float(w[1] << 16);
  lo.w = __uint_as_float(w[1] & 0xffff0000u);
  hi.x = __uint_as_float(w[2] << 16);
  hi.y = __uint_as_float(w[2] & 0xffff0000u);
  hi.z = __uint_as_float(w[3] << 16);
  hi.w = __uint_as_float(w[3] & 0xffff0000u);
  reinterpret_cast<float4*>(dst)[2 * i] = lo;
  reinterpret_cast<float4*>(dst)[2 * i + 1] = hi;
}

// The map x -> lse(x + a, c), or (has = 0) no map at all.
struct Map {
  float a, c;
  int has;
};

// first, then second.
__device__ __forceinline__ Map then(Map first, Map second) {
  if (!first.has) return second;
  if (!second.has) return first;
  return {first.a + second.a, lse2(first.c + second.a, second.c), 1};
}

__device__ __forceinline__ float apply(Map m, float x) {
  return m.has ? lse2(x + m.a, m.c) : x;
}

__device__ __forceinline__ Map shfl_up(Map m, int delta) {
  return {__shfl_up_sync(kFull, m.a, delta), __shfl_up_sync(kFull, m.c, delta),
          __shfl_up_sync(kFull, m.has, delta)};
}

// The composition of the maps of all threads before this one, in thread
// order. `totals` holds kWarps maps of shared memory. Every thread calls.
__device__ Map exclusive_scan(Map m, Map* totals) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int delta = 1; delta < 32; delta <<= 1) {
    const Map up = shfl_up(m, delta);
    if (lane >= delta) m = then(up, m);
  }
  if (lane == 31) totals[warp] = m;
  Map before = shfl_up(m, 1);
  if (lane == 0) before.has = 0;
  __syncthreads();
  if (warp == 0) {
    Map w = lane < kWarps ? totals[lane] : Map{0.f, 0.f, 0};
#pragma unroll
    for (int delta = 1; delta < kWarps; delta <<= 1) {
      const Map up = shfl_up(w, delta);
      if (lane >= delta) w = then(up, w);
    }
    Map w_before = shfl_up(w, 1);
    if (lane == 0) w_before.has = 0;
    if (lane < kWarps) totals[lane] = w_before;
  }
  __syncthreads();
  const Map out = then(totals[warp], before);
  __syncthreads();  // the next scan writes totals again
  return out;
}

template <bool kStreams, typename Row>
__global__ void __launch_bounds__(kThreads) ctc_forward_recursion_kernel(
    const Row* __restrict__ xn, const Row* __restrict__ xb,
    const float* __restrict__ phi,
    const void* __restrict__ len_a,    // streams: olen; reference: start
    const void* __restrict__ len_b,    // streams: enc_len; reference: end
    const float* __restrict__ extra,   // streams: r_src; reference: olen0
    float* __restrict__ r, const CtcArgs p, const int vec) {
  extern __shared__ __align__(16) float rows[];
  __shared__ Map totals[kWarps];
  const int T = p.t_cap;
  float* sxn = rows;
  float* sxb = sxn + T;
  float* sph = sxb + T;
  float* srn = sph + T;
  float* srb = srn + T;
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int s = h / p.beam;
  const int b = h - s * p.beam;

  int st, en;
  bool init0;
  if (kStreams) {
    const long long olen = p.olen_bytes == 8
                               ? static_cast<const long long*>(len_a)[s]
                               : static_cast<const int*>(len_a)[s];
    const long long enc_len = p.enc_bytes == 8
                                  ? static_cast<const long long*>(len_b)[s]
                                  : static_cast<const int*>(len_b)[s];
    init0 = olen == 0;
    st = static_cast<int>(min(max(olen, 1LL), static_cast<long long>(T)));
    en = static_cast<int>(min(max(enc_len, 0LL), static_cast<long long>(T)));
  } else {
    st = max(static_cast<const int*>(len_a)[h], 0);
    en = min(static_cast<const int*>(len_b)[h], T);
    init0 = extra[h] > 0.5f;
  }

  // Stage the three rows, widening xn and xb to float32.
  const Row* xn_row = xn + s * p.xn_ss + b * p.xn_sb;
  const Row* xb_row = xb + s * p.xb_ss + b * p.xb_sb;
  const float* phi_row = phi + s * p.phi_ss + b * p.phi_sb;
  if (vec) {
    constexpr int kPerLoad = 16 / static_cast<int>(sizeof(Row));
    for (int i = tid; i < T / kPerLoad; i += kThreads) {
      stage16(sxn, xn_row, i);
      stage16(sxb, xb_row, i);
    }
    for (int i = tid; i < T / 4; i += kThreads) stage16(sph, phi_row, i);
  } else {
    for (int t = tid; t < T; t += kThreads) {
      sxn[t] = widen(xn_row[t * p.xn_st]);
      sxb[t] = widen(xb_row[t * p.xb_st]);
      sph[t] = phi_row[t * p.phi_st];
    }
  }
  __syncthreads();

  // phi[t-1]: the streams form shifts here, the reference form's operand
  // is shifted already.
  auto phi_before = [&](int t) {
    return kStreams ? (t == 0 ? kLogZero : sph[t - 1]) : sph[t];
  };
  // What a frame outside [start, end) holds, and so the carry a range
  // that starts after it enters with.
  auto fill_rn = [&](int t) { return (t == 0 && init0) ? sxn[0] : kLogZero; };

  // This thread's frames [c0, c1) and those of them in the range, [lo, hi).
  const int per_thread = (T + kThreads - 1) / kThreads;
  const int c0 = min(tid * per_thread, T);
  const int c1 = min(c0 + per_thread, T);
  const int lo = max(c0, st);
  const int hi = min(c1, en);

  // r_n.
  Map m = {0.f, 0.f, 0};
  for (int t = lo; t < hi; ++t) {
    const float a = sxn[t];
    m = then(m, Map{a, phi_before(t) + a, 1});
  }
  Map before = exclusive_scan(m, totals);
  float rn = apply(before, st == 0 ? kLogZero : fill_rn(st - 1));
  for (int t = c0; t < c1; ++t) {
    if (t >= lo && t < hi) {
      rn = lse2(rn, phi_before(t)) + sxn[t];
      srn[t] = rn;
    } else {
      srn[t] = fill_rn(t);
    }
  }
  __syncthreads();

  // r_b, from r_n[t-1].
  auto rn_before = [&](int t) { return t == 0 ? kLogZero : srn[t - 1]; };
  m = {0.f, 0.f, 0};
  for (int t = lo; t < hi; ++t) {
    const float a = sxb[t];
    m = then(m, Map{a, rn_before(t) + a, 1});
  }
  before = exclusive_scan(m, totals);
  float rb = apply(before, kLogZero);
  for (int t = c0; t < c1; ++t) {
    if (t >= lo && t < hi) {
      rb = lse2(rn_before(t), rb) + sxb[t];
      srb[t] = rb;
    } else {
      srb[t] = kLogZero;
    }
  }
  __syncthreads();

  if (kStreams) {
    // (S, B, 2, T); from end on, the source hypothesis' frames.
    float* out = r + static_cast<size_t>(h) * 2 * T;
    const float* src = extra + s * p.src_ss + b * p.src_sb;
    for (int t = tid; t < T; t += kThreads) {
      const bool tail = t >= en;
      out[t] = tail ? src[t] : srn[t];
      out[T + t] = tail ? src[p.src_sk + t] : srb[t];
    }
  } else {
    // (2, T, N).
    const size_t n = static_cast<size_t>(p.s_dim);
    for (int t = tid; t < T; t += kThreads) {
      r[t * n + h] = srn[t];
      r[(T + t) * n + h] = srb[t];
    }
  }
}

inline bool aligned_to(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// Returns 0, a cudaError_t, or kBadPlan when the plan or the pointers do
// not fit the kernel.
template <bool kStreams, typename Row>
int launch_rows(const void* xn, const void* xb, const float* phi,
                const void* len_a, const void* len_b, const float* extra,
                float* r, const CtcArgs& p, void* stream) {
  const long long n = static_cast<long long>(p.s_dim) * p.beam;
  if (p.s_dim < 0 || p.beam < 1 || p.t_cap < 1 || p.t_cap > kMaxT
      || n > 0x7fffffffLL)
    return kBadPlan;
  if (kStreams && ((p.olen_bytes != 4 && p.olen_bytes != 8)
                   || (p.enc_bytes != 4 && p.enc_bytes != 8)
                   || p.xn_st != 1 || p.xb_st != 1 || p.phi_st != 1))
    return kBadPlan;
  if (n == 0) return 0;
  const void* ptrs[] = {phi, len_a, len_b, extra, r};
  for (const void* ptr : ptrs)
    if (ptr == nullptr || !aligned_to(ptr, 4)) return kBadPlan;
  if (xn == nullptr || xb == nullptr || !aligned_to(xn, sizeof(Row))
      || !aligned_to(xb, sizeof(Row)))
    return kBadPlan;
  if (kStreams && (!aligned_to(len_a, p.olen_bytes)
                   || !aligned_to(len_b, p.enc_bytes)))
    return kBadPlan;
  const int per_load = 16 / static_cast<int>(sizeof(Row));
  const int vec = kStreams && p.vec && p.t_cap % per_load == 0
                  && aligned_to(xn, 16) && aligned_to(xb, 16)
                  && aligned_to(phi, 16);
  const auto kernel = ctc_forward_recursion_kernel<kStreams, Row>;
  const int smem = 5 * p.t_cap * static_cast<int>(sizeof(float));
  kernel<<<static_cast<unsigned>(n), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Row*>(xn), static_cast<const Row*>(xb), phi, len_a,
      len_b, extra, r, p, vec);
  return static_cast<int>(cudaGetLastError());
}

// xn and xb in the dtype the plan names.
template <bool kStreams>
int launch(const void* xn, const void* xb, const float* phi,
           const void* len_a, const void* len_b, const float* extra, float* r,
           const CtcArgs& p, void* stream) {
  if (p.row_bytes == 4)
    return launch_rows<kStreams, float>(xn, xb, phi, len_a, len_b, extra, r,
                                        p, stream);
  if (p.row_bytes == 2)
    return launch_rows<kStreams, bf16_bits>(xn, xb, phi, len_a, len_b, extra,
                                            r, p, stream);
  return kBadPlan;
}

}  // namespace

extern "C" int sc_ctc_forward_recursion(const void* xn, const void* xb,
                                        const float* phi_shift,
                                        const int* start, const int* end,
                                        const float* olen0, float* r,
                                        const CtcArgs* plan, void* stream) {
  return launch<false>(xn, xb, phi_shift, start, end, olen0, r, *plan,
                       stream);
}

extern "C" int sc_ctc_forward_recursion_streams(
    const void* xn, const void* xb, const float* phi, const void* olen,
    const void* enc_len, const float* r_src, float* r, const CtcArgs* plan,
    void* stream) {
  return launch<true>(xn, xb, phi, olen, enc_len, r_src, r, *plan, stream);
}

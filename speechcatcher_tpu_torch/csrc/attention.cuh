// Windowed attention for the streaming encoders, sm_90a: the one kernel
// behind block_attention (kernel A, block_attention.cu) and
// rel_block_attention (kernel E, rel_attention.cu).
//
//   A: out = softmax(mask(q k^T / sqrt(dk))) v
//   E: out = softmax(mask(((q + u) k^T + rel_shift((q + v) pos^T)) / sqrt(dk))) v
//
// in W-wide windows, one (n, h) pair at a time. Masked scores are filled
// with the float32 minimum before the softmax and masked probabilities are
// zeroed after it, so a fully masked row gives exactly 0.
//
// Bound on the H100: bytes (q, k, v read once, out written once: 43 KB a
// window at W = 42, dk = 64, 8 heads, 0.1 us at 3.35 TB/s; the 0.45 MFLOP a
// pair are far below the float32 rate). A session step has one or two
// windows, so what the kernel waits for is the latency of its longest chain
// of dependent instructions, and the design shortens that chain and spreads
// the work:
//
// - Grid (pair, tile of query rows): a block of `warps` warps, one warp per
//   query row (7 rows x 6 tiles at W = 42, so one window gives 48 blocks).
//   Where that gives more blocks than the card has SMs (three windows and
//   more, the engine's 8 to 16), a warp takes two rows, which halves the
//   blocks, the staging and the shared-memory reads of K and V per row (3
//   tiles of 14 rows at W = 42; measured equal or faster from there on, and
//   slower below).
//   E adds one warp, see below.
// - Operands are read where their producers left them: q, k, v are (N, H,
//   W, dk) views with any strides on n, h, w (the transposed view of an
//   (N, W, H*dk) projection) and inner stride 1; out is written as (N, W, H,
//   dk) contiguous, which the callers merge into (N, W, H*dk) as a view.
// - Each block stages the pair's K (and, in E, the head's pos) and V in
//   shared memory with 16-byte cp.async copies in two groups: the scores
//   start when K has landed, V is waited for before P.V. K and pos rows have
//   a stride of 4 * ((dk / 4) | 1) floats (68 at dk = 64), so the 8 lanes of
//   a quarter warp that read 16 bytes each of 8 consecutive rows hit 32
//   distinct banks. Where dk, a stride or a pointer rules 16-byte loads out,
//   the same kernel takes scalar copies and an odd row stride (dk | 1).
// - Lane j of a row's warp holds the scores of columns j, j + 32, ...: dk-long
//   dot products of its K rows with the broadcast q row, summed over d in
//   index order with single-rounding multiply-adds. Fill, maximum,
//   exponentials, sum and zeroing are warp shuffles over registers; no
//   (W, W) tile exists. P.V: lane c accumulates output columns c and c + 32
//   over j in index order, each probability broadcast by shuffle.
// - E's legacy rel_shift, for tq == tk == W,
//     bd[i, j] = raw[i, j - i + W - 1]   for j <= i
//     bd[i, i + 1] = 0
//     bd[i, j] = raw[i + 1, j - i - 2]   for j >= i + 2
//   needs raw rows i and i + 1 = (q + v) pos^T. Each row warp writes its raw
//   rows to a (rows + 1, W) buffer, one extra warp computes the row after
//   the tile's last (if it exists), and after one barrier every lane reads
//   its shifted values by that index arithmetic.
//
// float32 on the CUDA cores throughout: the session's contract is a decode
// equal to the JAX package's token for token, TF32 is off for the port, and
// one TF32 pass keeps three decimal digits. Tensor cores come with the bf16
// precision mode, where the operands are 16-bit.

#pragma once

#include <cuda_runtime.h>
#include <cfloat>

// At global scope: a type of an unnamed namespace in the signature would
// give the extern "C" entry points internal linkage.
struct AttnArgs {               // mirrors block_attention.py::_AttnArgs
  long long q_sn, q_sh, q_sw;   // strides (elements) of q on n, h, w
  long long k_sn, k_sh, k_sw;
  long long v_sn, v_sh, v_sw;
  long long pos_sh, pos_sw;     // E: strides of pos on h, w
  long long bu_sh, bv_sh;       // E: strides of bias_u, bias_v on h
  int n, h, w, dk;
  int warps;                    // row warps per block
  int rpw;                      // query rows per warp: 1 or 2
  int tiles;                    // blocks per pair: ceil(w / (warps * rpw))
  int vec;                      // dk and every stride allow 16-byte loads
  int smem_vec, smem_scalar;    // dynamic shared memory of either route
  float scale;                  // sqrt(dk): the scores are divided by it
};

namespace {

constexpr int kBadPlan = -1;
constexpr int kMaxW = 128;                 // 4 score columns per lane
constexpr int kSmemLimit = 232448;         // a block's shared memory, Hopper
constexpr int kMaxDevices = 64;

// Offsets (floats) of the block's shared arrays; block_attention.py's
// _smem_floats computes the same total.
struct AttnLayout {
  int ks;                       // row stride of k and pos
  int k, v, q, pos, qv, raw, floats;
};

// rows: the block's query rows, warps * rpw.
__host__ __device__ inline AttnLayout attn_layout(bool rel, bool vec, int w,
                                                  int dk, int rows) {
  AttnLayout l;
  l.ks = vec ? 4 * ((dk / 4) | 1) : (dk | 1);
  int off = 0;
  l.k = off;    off += w * l.ks;
  l.v = off;    off += w * dk;
  l.q = off;    off += rows * dk;           // q rows (A), q + u rows (E)
  l.pos = off;  off += rel ? w * l.ks : 0;
  l.qv = off;   off += rel ? (rows + 1) * dk : 0;   // q + v rows
  l.raw = off;  off += rel ? (rows + 1) * w : 0;    // unshifted (q+v) pos^T
  l.floats = off;
  return l;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy a (w, dk) matrix with row stride src_sw into shared rows of stride
// dst_s: asynchronous 16-byte copies (VEC) or plain 4-byte ones.
template <bool VEC>
__device__ __forceinline__ void stage(float* dst, int dst_s, const float* src,
                                      long long src_sw, int w, int dk) {
  if constexpr (VEC) {
    const int per_row = dk >> 2;
    for (int idx = threadIdx.x; idx < w * per_row; idx += blockDim.x) {
      const int r = idx / per_row;
      const int c = (idx - r * per_row) << 2;
      cp_async16(dst + r * dst_s + c, src + r * src_sw + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < w * dk; idx += blockDim.x) {
      const int r = idx / dk;
      const int c = idx - r * dk;
      dst[r * dst_s + c] = src[r * src_sw + c];
    }
  }
}

// kN consecutive floats of a row: 4 (one 16-byte load) or 1.
template <bool VEC>
struct Chunk {
  static constexpr int kN = VEC ? 4 : 1;
  float x[kN];
  __device__ __forceinline__ explicit Chunk(const float* p) {
    if constexpr (VEC) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      x[0] = *p;
    }
  }
  // acc + this . o, added in index order with single-rounding multiply-adds.
  __device__ __forceinline__ float dot(const Chunk& o, float acc) const {
#pragma unroll
    for (int t = 0; t < kN; ++t) acc = fmaf(x[t], o.x[t], acc);
    return acc;
  }
};

// One block's work. REL: kernel E (else A). VEC: 16-byte loads. CPL: score
// columns per lane, ceil(W / 32) rounded up to 1, 2 or 4. RPW: query rows
// per warp. smem: the block's dynamic shared memory, 16-byte aligned.
template <bool REL, bool VEC, int CPL, int RPW>
__device__ __forceinline__ void attention_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ pos,
    const float* __restrict__ bias_u, const float* __restrict__ bias_v,
    const float* __restrict__ mask, float* __restrict__ out,
    const AttnArgs& a, float* smem) {
  const int w = a.w, dk = a.dk, warps = a.warps;
  const AttnLayout l = attn_layout(REL, VEC, w, dk, warps * RPW);
  float* sk = smem + l.k;
  float* sv = smem + l.v;
  float* sq = smem + l.q;
  float* spos = smem + l.pos;
  float* sqv = smem + l.qv;
  float* sraw = smem + l.raw;
  constexpr unsigned kFull = 0xffffffffu;

  const int pair = blockIdx.x;
  const int n = pair / a.h;
  const int head = pair - n * a.h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This warp's query rows i0 .. i0 + RPW - 1, in slots slot0 .. of the
  // block's q and raw arrays. Warp `warps` is E's extra: one row, the one
  // after the tile's last, of which only the raw scores are used.
  const bool extra = REL && warp == warps;
  const int slot0 = warp * RPW;
  const int i0 = blockIdx.y * warps * RPW + slot0;
  bool has_row[RPW], row_out[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    has_row[r] = i0 + r < w && !(extra && r > 0);
    row_out[r] = has_row[r] && !extra;
  }

  // K (and pos) in the first group, V in the second.
  stage<VEC>(sk, l.ks, k + n * a.k_sn + head * a.k_sh, a.k_sw, w, dk);
  if (REL) stage<VEC>(spos, l.ks, pos + head * a.pos_sh, a.pos_sw, w, dk);
  cp_async_commit();
  stage<VEC>(sv, dk, v + n * a.v_sn + head * a.v_sh, a.v_sw, w, dk);
  cp_async_commit();

  // This warp's q rows (E: q + u and q + v), and this lane's mask values.
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (!has_row[r]) continue;
    const float* qp = q + n * a.q_sn + head * a.q_sh + (i0 + r) * a.q_sw;
    for (int c = lane; c < dk; c += 32) {
      const float x = qp[c];
      if (REL) {
        if (!extra)
          sq[(slot0 + r) * dk + c] = x + bias_u[head * a.bu_sh + c];
        sqv[(slot0 + r) * dk + c] = x + bias_v[head * a.bv_sh + c];
      } else {
        sq[(slot0 + r) * dk + c] = x;
      }
    }
  }
  bool keep[RPW][CPL];
  int jr[CPL];                                   // this lane's K rows
#pragma unroll
  for (int cc = 0; cc < CPL; ++cc) {
    const int j = cc * 32 + lane;
    jr[cc] = min(j, w - 1);
#pragma unroll
    for (int r = 0; r < RPW; ++r)
      keep[r][cc] = row_out[r] && j < w && mask[(i0 + r) * w + j] != 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();

  // Scores: ac = q . k_j (E: (q + u) . k_j), raw = (q + v) . pos_j. A row
  // this warp does not have reads the warp's first slot and is dropped; E's
  // extra warp has no q + u row and reads its q + v row in that place.
  float ac[RPW][CPL], raw[RPW][CPL];
  const float* qa[RPW];
  const float* qb[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int slot = (slot0 + (has_row[r] ? r : 0)) * dk;
    qa[r] = (extra ? sqv : sq) + slot;
    qb[r] = sqv + slot;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) ac[r][cc] = raw[r][cc] = 0.f;
  }
  if (has_row[0]) {
#pragma unroll 4
    for (int d = 0; d < dk; d += Chunk<VEC>::kN) {
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const Chunk<VEC> kc(sk + jr[cc] * l.ks + d);
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          ac[r][cc] = Chunk<VEC>(qa[r] + d).dot(kc, ac[r][cc]);
        if (REL) {
          const Chunk<VEC> pc(spos + jr[cc] * l.ks + d);
#pragma unroll
          for (int r = 0; r < RPW; ++r)
            raw[r][cc] = Chunk<VEC>(qb[r] + d).dot(pc, raw[r][cc]);
        }
      }
    }
  }
  if (REL) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int j = cc * 32 + lane;
        if (has_row[r] && j < w) sraw[(slot0 + r) * w + j] = raw[r][cc];
      }
    }
    __syncthreads();
  }

  // Shift (E), scale, fill, softmax, zeroing: all in this warp's registers.
  float p[RPW][CPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + r;
    float mx = -FLT_MAX;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int j = cc * 32 + lane;
      float s = ac[r][cc];
      if (REL && row_out[r] && j < w) {
        float bd = 0.f;
        if (j <= i) {
          bd = sraw[(slot0 + r) * w + (j - i + w - 1)];
        } else if (j >= i + 2) {
          bd = sraw[(slot0 + r + 1) * w + (j - i - 2)];
        }
        s += bd;
      }
      s = s / a.scale;
      p[r][cc] = keep[r][cc] ? s : -FLT_MAX;
      if (j < w) mx = fmaxf(mx, p[r][cc]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      p[r][cc] = cc * 32 + lane < w ? expf(p[r][cc] - mx) : 0.f;
      sum += p[r][cc];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
      p[r][cc] = keep[r][cc] ? p[r][cc] / sum : 0.f;
  }

  cp_async_wait<0>();
  __syncthreads();

  // out[n, i, head, :] = P[i, :] V, summed over j in index order: lane c
  // takes output columns c and c + 32 (of each 64).
  if (row_out[0]) {
    for (int c0 = 0; c0 < dk; c0 += 64) {
      const int ca = c0 + lane, cb = ca + 32;
      const float* va = sv + min(ca, dk - 1);
      const float* vb = sv + min(cb, dk - 1);
      float acc_a[RPW], acc_b[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) acc_a[r] = acc_b[r] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int jn = min(32, w - cc * 32);
#pragma unroll 8
        for (int jj = 0; jj < jn; ++jj) {
          const int j = cc * 32 + jj;
          const float xa = va[j * dk], xb = vb[j * dk];
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float pj = __shfl_sync(kFull, p[r][cc], jj);
            acc_a[r] = fmaf(pj, xa, acc_a[r]);
            acc_b[r] = fmaf(pj, xb, acc_b[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (!row_out[r]) continue;
        float* op = out + ((static_cast<long long>(n) * w + i0 + r) * a.h
                           + head) * dk;
        if (ca < dk) op[ca] = acc_a[r];
        if (cb < dk) op[cb] = acc_b[r];
      }
    }
  }
}

// K names the two __global__ templates of one of the kernels (so that each
// shows under its own name in a profile): K::kRel and K::kernel<VEC, CPL, RPW>().
template <typename K, bool VEC, int CPL, int RPW>
int launch_attention_as(const float* q, const float* k, const float* v,
                        const float* pos, const float* bias_u,
                        const float* bias_v, const float* mask, float* out,
                        const AttnArgs& a, int smem, cudaStream_t stream) {
  const auto kernel = K::template kernel<VEC, CPL, RPW>();
  if (smem > 48 * 1024) {
    // Opt in to large dynamic shared memory once per device.
    static bool allowed[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 0 || dev >= kMaxDevices) return kBadPlan;
    if (!allowed[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed[dev] = true;
    }
  }
  const dim3 grid(a.n * a.h, a.tiles);
  kernel<<<grid, 32 * (a.warps + (K::kRel ? 1 : 0)), smem, stream>>>(
      q, k, v, pos, bias_u, bias_v, mask, out, a);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned_to(const void* p, int unit) {
  return reinterpret_cast<unsigned long long>(p) % unit == 0;
}

// Check the plan against the kernel's limits and the pointers against the
// route, then launch. pos, bias_u, bias_v are null for kernel A.
template <typename K>
int launch_attention(const float* q, const float* k, const float* v,
                     const float* pos, const float* bias_u,
                     const float* bias_v, const float* mask, float* out,
                     const AttnArgs& a, cudaStream_t stream) {
  if (a.n < 0 || a.h <= 0 || a.w <= 0 || a.w > kMaxW || a.dk <= 0
      || a.warps <= 0 || a.warps > 31 || (a.rpw != 1 && a.rpw != 2)
      || a.tiles <= 0 || a.tiles > 65535
      || static_cast<long long>(a.tiles) * a.warps * a.rpw < a.w
      || static_cast<long long>(a.n) * a.h > 0x7fffffffLL)
    return kBadPlan;
  if (a.n == 0) return 0;
  constexpr bool REL = K::kRel;
  const void* ptrs[] = {q, k, v, mask, out, pos, bias_u, bias_v};
  for (int t = 0; t < (REL ? 8 : 5); ++t)
    if (ptrs[t] == nullptr || !aligned_to(ptrs[t], 4)) return kBadPlan;
  const bool vec = a.vec && a.dk % 4 == 0 && aligned_to(q, 16)
                   && aligned_to(k, 16) && aligned_to(v, 16)
                   && (!REL || aligned_to(pos, 16));
  const int smem = vec ? a.smem_vec : a.smem_scalar;
  if (smem != attn_layout(REL, vec, a.w, a.dk, a.warps * a.rpw).floats
                  * static_cast<int>(sizeof(float))
      || smem > kSmemLimit)
    return kBadPlan;
  const int cpl = (a.w + 31) / 32;
#define SC_ATTN_LAUNCH(VEC, CPL)                                            \
  return a.rpw == 2                                                         \
             ? launch_attention_as<K, VEC, CPL, 2>(                         \
                   q, k, v, pos, bias_u, bias_v, mask, out, a, smem, stream) \
             : launch_attention_as<K, VEC, CPL, 1>(                         \
                   q, k, v, pos, bias_u, bias_v, mask, out, a, smem, stream)
  if (vec) {
    if (cpl == 1) SC_ATTN_LAUNCH(true, 1);
    if (cpl == 2) SC_ATTN_LAUNCH(true, 2);
    SC_ATTN_LAUNCH(true, 4);
  }
  if (cpl == 1) SC_ATTN_LAUNCH(false, 1);
  if (cpl == 2) SC_ATTN_LAUNCH(false, 2);
  SC_ATTN_LAUNCH(false, 4);
#undef SC_ATTN_LAUNCH
}

}  // namespace

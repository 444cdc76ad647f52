// Masked relative-position block attention for the streaming conformer,
// sm_90a.
//
// Replaces speechcatcher_tpu/ops/pallas/rel_attention.py::rel_block_attention
// (_kernel, pallas_call at :151):
//   out = softmax(mask(((q + u) k^T + rel_shift((q + v) pos^T)) / sqrt(dk))) V
// in (block_size+2)-wide windows, with one (H, W, dk) position table and the
// (H, dk) Transformer-XL biases u, v shared by all windows. rel_shift is the
// legacy reshape trick; for tq == tk == W it reads
//   bd[i, j] = raw[i, j - i + W - 1]   for j <= i
//   bd[i, i + 1] = 0
//   bd[i, j] = raw[i + 1, j - i - 2]   for j >= i + 2
// so row i needs row i + 1 of raw: all of raw is computed before the shift.
// Masked scores are filled with the float32 minimum before the softmax and
// masked probabilities are zeroed after it, so a fully masked row gives 0.
//
// The TPU kernel applied the shift as two one-hot (W, W, W) matmuls and
// padded N to a multiple of 8 (Mosaic has no lane-crossing reshape); here
// the shift is index arithmetic and each block takes one (n, h) pair.
//
// Bound on the H100: bytes. One pair reads q, k, v (W x dk each), pos[h]
// (shared by all pairs of head h) and writes W x dk; the two W x W score
// tiles (42 x 42 at the flagship) never leave shared memory. The grid is
// N*H = 8..200 blocks at the main path's shapes, so a call is launch- and
// latency-bound: the design keeps the whole pair in one block, one launch
// per layer, and makes no attempt at tensor cores (a later PR's work).
//
// Layout: q, k, v, out contiguous float32 (N, H, W, dk); pos (H, W, dk);
// bias_u, bias_v (H, dk); mask float32 (W, W), nonzero = attend. q, k, v and
// pos are staged in shared memory with rows padded to dk + 1 floats so that
// threads walking rows hit distinct banks.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kThreads = 128;

__global__ void rel_block_attention_kernel(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ pos,
                                           const float* __restrict__ bias_u,
                                           const float* __restrict__ bias_v,
                                           const float* __restrict__ mask,
                                           float* __restrict__ out,
                                           int h, int w, int dk, float scale) {
  extern __shared__ float smem[];
  const int dkp = dk + 1;
  float* sq = smem;               // (W, dk+1)
  float* sk = sq + w * dkp;       // (W, dk+1)
  float* sv = sk + w * dkp;       // (W, dk+1)
  float* spos = sv + w * dkp;     // (W, dk+1) pos[head]
  float* su = spos + w * dkp;     // (dk) bias_u[head]
  float* sbv = su + dk;           // (dk) bias_v[head]
  float* sac = sbv + dk;          // (W, W) content scores, then probabilities
  float* sraw = sac + w * w;      // (W, W) unshifted position scores

  const int pair = blockIdx.x;
  const int head = pair % h;
  const size_t base = static_cast<size_t>(pair) * w * dk;
  const size_t pbase = static_cast<size_t>(head) * w * dk;
  const int tid = threadIdx.x;
  const int n_elem = w * dk;

  for (int idx = tid; idx < n_elem; idx += blockDim.x) {
    const int r = idx / dk;
    const int c = idx - r * dk;
    sq[r * dkp + c] = q[base + idx];
    sk[r * dkp + c] = k[base + idx];
    sv[r * dkp + c] = v[base + idx];
    spos[r * dkp + c] = pos[pbase + idx];
  }
  for (int c = tid; c < dk; c += blockDim.x) {
    su[c] = bias_u[head * dk + c];
    sbv[c] = bias_v[head * dk + c];
  }
  __syncthreads();

  // ac = (q + u) k^T and raw = (q + v) pos^T, each sum over d in order.
  for (int idx = tid; idx < w * w; idx += blockDim.x) {
    const int i = idx / w;
    const int j = idx - i * w;
    float ac = 0.f;
    float raw = 0.f;
    for (int d = 0; d < dk; ++d) {
      const float qd = sq[i * dkp + d];
      ac += (qd + su[d]) * sk[j * dkp + d];
      raw += (qd + sbv[d]) * spos[j * dkp + d];
    }
    sac[idx] = ac;
    sraw[idx] = raw;
  }
  __syncthreads();

  // Shifted position scores, scale and mask fill.
  for (int idx = tid; idx < w * w; idx += blockDim.x) {
    const int i = idx / w;
    const int j = idx - i * w;
    float bd;
    if (j <= i) {
      bd = sraw[i * w + (j - i + w - 1)];
    } else if (j == i + 1) {
      bd = 0.f;
    } else {
      bd = sraw[(i + 1) * w + (j - i - 2)];
    }
    const float s = (sac[idx] + bd) / scale;
    sac[idx] = mask[idx] != 0.f ? s : -FLT_MAX;
  }
  __syncthreads();

  // Row softmax, one warp per row, then zero the masked probabilities.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = warp; i < w; i += n_warps) {
    float* row = sac + i * w;
    float mx = -FLT_MAX;
    for (int j = lane; j < w; j += 32) mx = fmaxf(mx, row[j]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < w; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < w; j += 32)
      row[j] = mask[i * w + j] != 0.f ? row[j] / sum : 0.f;
  }
  __syncthreads();

  // out = P V.
  for (int idx = tid; idx < n_elem; idx += blockDim.x) {
    const int i = idx / dk;
    const int d = idx - i * dk;
    float acc = 0.f;
    for (int j = 0; j < w; ++j) acc += sac[i * w + j] * sv[j * dkp + d];
    out[base + idx] = acc;
  }
}

}  // namespace

extern "C" int sc_rel_block_attention_smem_bytes(int w, int dk) {
  return static_cast<int>((4 * w * (dk + 1) + 2 * dk + 2 * w * w)
                          * sizeof(float));
}

extern "C" int sc_rel_block_attention(const float* q, const float* k,
                                      const float* v, const float* pos,
                                      const float* bias_u,
                                      const float* bias_v, const float* mask,
                                      float* out, int n_pairs, int h, int w,
                                      int dk, float scale, void* stream) {
  const int smem = sc_rel_block_attention_smem_bytes(w, dk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rel_block_attention_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_pairs > 0) {
    rel_block_attention_kernel<<<n_pairs, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        q, k, v, pos, bias_u, bias_v, mask, out, h, w, dk, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

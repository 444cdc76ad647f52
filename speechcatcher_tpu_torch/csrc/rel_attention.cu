// Masked relative-position block attention for the streaming conformer
// (kernel E), sm_90a.
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
// Masked scores are filled with the float32 minimum before the softmax and
// masked probabilities are zeroed after it, so a fully masked row gives 0.
//
// The TPU kernel applied the shift as two one-hot (W, W, W) matmuls and
// padded N to a multiple of 8 (Mosaic has no lane-crossing reshape); here
// the shift is index arithmetic over the raw rows a tile of query rows
// needs: its own and the one after its last.
//
// Bound on the H100: bytes (q, k, v, pos[h] read once, out written once),
// but at one or two windows a step the kernel waits for its longest chain
// of dependent instructions. attention.cuh holds the design, shared with
// block_attention: a block per (pair, tile of query rows), a warp per score
// row plus one warp for the extra raw row, scores in registers, K, pos and
// V staged by cp.async, operands read through their producers' strides.
// float32 on the CUDA cores, sums in index order; tensor cores come with
// the bf16 precision mode.
//
// Layout: q, k, v float32 (N, H, W, dk), pos (H, W, dk), bias_u, bias_v
// (H, dk), all with strides from the plan and inner stride 1; mask float32
// (W, W) contiguous, nonzero = attend; out float32 (N, W, H, dk) contiguous.

#include "attention.cuh"

namespace {

template <bool VEC, int CPL, int RPW>
__global__ void rel_block_attention_kernel(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ pos,
                                           const float* __restrict__ bias_u,
                                           const float* __restrict__ bias_v,
                                           const float* __restrict__ mask,
                                           float* __restrict__ out,
                                           AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  attention_block<true, VEC, CPL, RPW>(q, k, v, pos, bias_u, bias_v, mask,
                                        out, a, smem);
}

struct RelBlockAttention {
  static constexpr bool kRel = true;
  template <bool VEC, int CPL, int RPW>
  static auto kernel() { return rel_block_attention_kernel<VEC, CPL, RPW>; }
};

}  // namespace

// Returns 0, a cudaError_t, or kBadPlan when the plan or the pointers do
// not fit the kernel.
extern "C" int sc_rel_block_attention(const float* q, const float* k,
                                      const float* v, const float* pos,
                                      const float* bias_u,
                                      const float* bias_v, const float* mask,
                                      float* out, const AttnArgs* a,
                                      void* stream) {
  return launch_attention<RelBlockAttention>(
      q, k, v, pos, bias_u, bias_v, mask, out, *a,
      static_cast<cudaStream_t>(stream));
}

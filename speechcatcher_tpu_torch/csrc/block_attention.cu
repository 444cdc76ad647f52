// Masked block attention for the streaming encoder (kernel A), sm_90a.
//
// Replaces speechcatcher_tpu/ops/pallas/block_attention.py::block_attention
// (_kernel, pallas_call at :108): out = softmax(mask(Q K^T / sqrt(dk))) V in
// (block_size+2)-wide windows, with the masked scores filled with the
// float32 minimum before the softmax and the masked probabilities zeroed
// after it, so a fully masked row gives exactly 0.
//
// Bound on the H100: bytes (q, k, v read once, out written once; the W x W
// scores never leave registers), but at one or two windows a step the
// kernel waits for its longest chain of dependent instructions, not for
// bytes or arithmetic. attention.cuh holds the design, which this kernel
// shares with rel_block_attention: a block per (pair, tile of query rows),
// a warp per score row with the scores in registers, K and V staged by
// cp.async, operands read through their producers' strides and the output
// written in the layout its consumer merges as a view. float32 on the CUDA
// cores, sums in index order; tensor cores come with the bf16 precision
// mode.
//
// Layout: q, k, v float32 (N, H, W, dk) with strides from the plan, inner
// stride 1; mask float32 (W, W) contiguous, nonzero = attend; out float32
// (N, W, H, dk) contiguous.

#include "attention.cuh"

namespace {

template <bool VEC, int CPL, int RPW>
__global__ void block_attention_kernel(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       const float* __restrict__ pos,
                                       const float* __restrict__ bias_u,
                                       const float* __restrict__ bias_v,
                                       const float* __restrict__ mask,
                                       float* __restrict__ out, AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  attention_block<false, VEC, CPL, RPW>(q, k, v, pos, bias_u, bias_v, mask,
                                        out, a, smem);
}

struct BlockAttention {
  static constexpr bool kRel = false;
  template <bool VEC, int CPL, int RPW>
  static auto kernel() { return block_attention_kernel<VEC, CPL, RPW>; }
};

}  // namespace

// Returns 0, a cudaError_t, or kBadPlan when the plan or the pointers do
// not fit the kernel.
extern "C" int sc_block_attention(const float* q, const float* k,
                                  const float* v, const float* mask,
                                  float* out, const AttnArgs* a,
                                  void* stream) {
  return launch_attention<BlockAttention>(
      q, k, v, nullptr, nullptr, nullptr, mask, out, *a,
      static_cast<cudaStream_t>(stream));
}

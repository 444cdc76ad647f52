// In-place column append on the time-minor CTC log-prob ring, sm_90a.
//
// Replaces speechcatcher_tpu/ops/pallas/ring_append.py::ring_append_cols
// (_append_cols_kernel, pallas_call at :227):
//     ring[s, :, start[s] + i] = new[s, :, i]   for i < min(n_new[s], TN)
// with start clipped to [0, T-1] and columns at or past T dropped.
//
// Bound on the H100: bytes, and only the written ones: S x V x n_new
// elements read from `new` and written into the ring (16 x 1024 floats per
// block at the flagship, 64 KB). The design touches nothing else of the
// (S, V, T) ring: one thread per written element (s, v, i), consecutive
// threads on consecutive columns. At one stream the call is launch-bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

template <typename T>
__global__ void ring_append_cols_kernel(T* __restrict__ ring,
                                        const T* __restrict__ add,
                                        const int* __restrict__ start,
                                        const int* __restrict__ n_new,
                                        int s_dim, int v_dim, int t_cap,
                                        int tn) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(s_dim) * v_dim * tn;
  if (idx >= total) return;
  const int i = static_cast<int>(idx % tn);
  const size_t row = idx / tn;               // s * V + v
  const int s = static_cast<int>(row / v_dim);
  const int cnt = min(n_new[s], tn);
  const int st = min(max(start[s], 0), t_cap - 1);
  const int col = st + i;
  if (i < cnt && col < t_cap) ring[row * t_cap + col] = add[idx];
}

template <typename T>
int launch(T* ring, const T* add, const int* start, const int* n_new,
           int s_dim, int v_dim, int t_cap, int tn, void* stream) {
  const size_t total = static_cast<size_t>(s_dim) * v_dim * tn;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    ring_append_cols_kernel<T><<<blocks, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        ring, add, start, n_new, s_dim, v_dim, t_cap, tn);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sc_ring_append_cols_f32(float* ring, const float* add,
                                       const int* start, const int* n_new,
                                       int s_dim, int v_dim, int t_cap, int tn,
                                       void* stream) {
  return launch<float>(ring, add, start, n_new, s_dim, v_dim, t_cap, tn,
                       stream);
}

extern "C" int sc_ring_append_cols_bf16(void* ring, const void* add,
                                        const int* start, const int* n_new,
                                        int s_dim, int v_dim, int t_cap,
                                        int tn, void* stream) {
  return launch<__nv_bfloat16>(static_cast<__nv_bfloat16*>(ring),
                               static_cast<const __nv_bfloat16*>(add), start,
                               n_new, s_dim, v_dim, t_cap, tn, stream);
}

// In-place row append on (L, S, T, D) rings, sm_90a.
//
// Replaces speechcatcher_tpu/ops/pallas/ring_append.py::ring_append_rows
// (_append_rows_kernel, pallas_call at :147):
//     cache[l, s, start[s] + i, :] = new[l, s, i, :]  for i < min(n_new[s], TN)
// with start clipped to [0, T-1] and rows at or past T dropped.
//
// Bound on the H100: bytes, only the written rows: 2 x L x S x n x D x
// itemsize (read from `new`, written into the ring). The TPU kernel moved
// whole 64-row windows through VMEM and shifted them with pltpu.roll; here
// one block per (row tile, s, l) copies exactly its rows, with no window and
// no condition on T. A row is raw bytes (float32 and bfloat16 alike), moved
// in 16-byte units when the row pitch and both base pointers allow it (the
// wrapper decides), else in 4- or 2-byte units. Consecutive threads take
// consecutive units of a row, so each warp's loads and stores coalesce.

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kRowThreads = 128;

template <typename U>
__global__ void ring_append_rows_kernel(U* __restrict__ cache,
                                        const U* __restrict__ add,
                                        const int* __restrict__ start,
                                        const int* __restrict__ n_new,
                                        int s_dim, int t_cap, int tn,
                                        int units_per_row) {
  const int s = blockIdx.y;
  const int l = blockIdx.z;
  const int st = min(max(start[s], 0), t_cap - 1);
  const int cnt = min(min(n_new[s], tn), t_cap - st);
  const int row0 = blockIdx.x * kRowsPerBlock;
  if (row0 >= cnt) return;
  const int rows = min(kRowsPerBlock, cnt - row0);
  const size_t ls = static_cast<size_t>(l) * s_dim + s;
  U* dst = cache + (ls * t_cap + st + row0) * units_per_row;
  const U* src = add + (ls * tn + row0) * units_per_row;
  // The written rows of one block are contiguous in both tensors.
  const int total = rows * units_per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) dst[i] = src[i];
}

template <typename U>
int launch_rows(void* cache, const void* add, const int* start,
                const int* n_new, int l_dim, int s_dim, int t_cap, int tn,
                int row_bytes, void* stream) {
  const dim3 grid((tn + kRowsPerBlock - 1) / kRowsPerBlock, s_dim, l_dim);
  ring_append_rows_kernel<U><<<grid, kRowThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<U*>(cache), static_cast<const U*>(add), start, n_new, s_dim,
      t_cap, tn, row_bytes / static_cast<int>(sizeof(U)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// unit_bytes: 16, 4 or 2; row_bytes (D x itemsize) and both base pointers
// must be multiples of it.
extern "C" int sc_ring_append_rows(void* cache, const void* add,
                                   const int* start, const int* n_new,
                                   int l_dim, int s_dim, int t_cap, int tn,
                                   int row_bytes, int unit_bytes,
                                   void* stream) {
  if (l_dim <= 0 || s_dim <= 0 || tn <= 0 || row_bytes <= 0) return 0;
  if (row_bytes % unit_bytes != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (unit_bytes) {
    case 16:
      return launch_rows<uint4>(cache, add, start, n_new, l_dim, s_dim, t_cap,
                                tn, row_bytes, stream);
    case 4:
      return launch_rows<unsigned int>(cache, add, start, n_new, l_dim, s_dim,
                                       t_cap, tn, row_bytes, stream);
    case 2:
      return launch_rows<unsigned short>(cache, add, start, n_new, l_dim,
                                         s_dim, t_cap, tn, row_bytes, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

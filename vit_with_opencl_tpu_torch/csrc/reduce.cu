// Column sums: x [rows, cols] (fp32 or bf16) -> out [cols] fp32.
//
// The token-axis sum (_csum, vit_with_opencl_tpu/ops/fused_block.py:699)
// of the fused layer's backward: the bias gradients (dfc2_b from dOut,
// dfc1_b from the fp32 dhid_pre, dout_b from dx2, dqkv_b from the fp32 dqkv)
// and the second pass over the LN backward's per-block partial rows. On the
// TPU each of these accumulated in VMEM along a sequential batch grid. Here
// it is two passes without atomics, so the result is the same from run to
// run: each block of pass 1 sums kRowsPerChunk rows of 256 columns (one
// column a thread, neighbouring threads on neighbouring columns, so every
// load is coalesced) into one row of an fp32 partial [chunks, cols]; pass 2
// sums the partial rows in order, one column a thread. Bound on the card:
// bytes (x read once; the partial is rows / 64 times smaller).
#include "common.cuh"

namespace vit {

constexpr int kColThreads = 256;
constexpr int kRowsPerChunk = 64;

template <typename T>
__global__ void __launch_bounds__(kColThreads)
column_sum_kernel(const T* __restrict__ x, float* __restrict__ out, int rows,
                  int cols, int rows_per_chunk) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= cols) return;
  const int first = blockIdx.y * rows_per_chunk;
  const int last = min(first + rows_per_chunk, rows);
  float s = 0.f;
  for (int r = first; r < last; ++r) s += to_float(x[static_cast<size_t>(r) * cols + c]);
  out[static_cast<size_t>(blockIdx.y) * cols + c] = s;
}

template <typename T>
cudaError_t launch_column_sum(const void* x, float* out, int rows, int cols,
                              int rows_per_chunk, cudaStream_t stream) {
  const dim3 grid((cols + kColThreads - 1) / kColThreads,
                  (rows + rows_per_chunk - 1) / rows_per_chunk);
  column_sum_kernel<T><<<grid, kColThreads, 0, stream>>>(
      static_cast<const T*>(x), out, rows, cols, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace vit

// partial: fp32 scratch of ceil(rows / 64) * cols.
VIT_EXPORT int vit_column_sum(const void* x, int x_dtype, float* out, float* partial,
                              int rows, int cols, void* stream) {
  using namespace vit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  const int chunks = (rows + kRowsPerChunk - 1) / kRowsPerChunk;
  cudaError_t err;
  if (x_dtype == kF32)
    err = launch_column_sum<float>(x, partial, rows, cols, kRowsPerChunk, s);
  else if (x_dtype == kBF16)
    err = launch_column_sum<bf16>(x, partial, rows, cols, kRowsPerChunk, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return launch_column_sum<float>(partial, out, chunks, cols, chunks, s);
}

// Column sums: x [rows, cols] (fp32 or bf16) -> out [cols] fp32.
//
// The token-axis sum (_csum, vit_with_opencl_tpu/ops/fused_block.py:699)
// of the fused layer's backward: the bias gradients (dfc2_b from dOut,
// dfc1_b from the fp32 dhid_pre, dout_b from dx2, dqkv_b from the fp32 dqkv)
// and the sums of the LN backward's per-block partial rows. On the TPU each
// of these accumulated in VMEM along a sequential batch grid. Here there are
// no atomics, and every column is summed in an order fixed by the shape
// alone, so the result has the same bits on every run.
//
// Bound on the card: bytes (x read once; the partial rows are a few hundred
// times smaller). Design: a thread reads 16-byte vectors (4 fp32 or 8 bf16
// columns; one element where cols is not a whole number of vectors) and
// keeps kColUnroll rows in flight, each into its own accumulator; the
// accumulators are added in a fixed order, and a block adds its row lanes
// by a fixed tree in shared memory. Past a few hundred rows the rows are cut
// into chunks (ops/layernorm.column_sum_rows_per_chunk: about
// COLSUM_TARGET_BLOCKS blocks in the first pass), whose partial rows a second
// launch of the same kernel sums in chunk order, spread over column tiles
// of 8 vectors; fewer rows (the LN backward's partials) take one pass.
#include "common.cuh"

namespace vit {

constexpr int kColThreads = 256;
constexpr int kColUnroll = 4;

// Sums rows [blockIdx.y * rows_per_chunk, + rows_per_chunk) of x over a
// tile of `width` V-element column vectors into row blockIdx.y of out. A
// thread (lane of the tile, row lane q of R = kColThreads / width) takes the
// rows first + q + k·R: row first + q + (n·kColUnroll + u)·R into
// accumulator u.
template <typename T, int V>
__global__ void __launch_bounds__(kColThreads)
column_sum_kernel(const T* __restrict__ x, float* __restrict__ out, int rows,
                  int cols, int rows_per_chunk, int width) {
  __shared__ float red[V][kColThreads];
  const int lane = threadIdx.x % width, q = threadIdx.x / width;
  const int R = kColThreads / width;
  const int vec = blockIdx.x * width + lane;
  const bool live = vec < cols / V;
  const int first = blockIdx.y * rows_per_chunk;
  const int last = min(first + rows_per_chunk, rows);
  float acc[kColUnroll][V];
#pragma unroll
  for (int u = 0; u < kColUnroll; ++u)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[u][e] = 0.f;
  if (live) {
    const T* col = x + static_cast<size_t>(vec) * V;
    int r = first + q;
    for (; r + (kColUnroll - 1) * R < last; r += kColUnroll * R) {
      float v[kColUnroll][V];
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u)
        load_floats<V>(v[u], col + static_cast<size_t>(r + u * R) * cols);
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[u][e] += v[u][e];
    }
#pragma unroll
    for (int u = 0; u < kColUnroll - 1; ++u) {
      if (r + u * R < last) {
        float v[V];
        load_floats<V>(v, col + static_cast<size_t>(r + u * R) * cols);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[u][e] += v[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    red[e][threadIdx.x] = (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
  for (int s = R / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (q < s) {
#pragma unroll
      for (int e = 0; e < V; ++e) red[e][threadIdx.x] += red[e][threadIdx.x + s * width];
    }
  }
  if (q != 0 || !live) return;
  float v[V];
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = red[e][threadIdx.x];
  const size_t off = static_cast<size_t>(blockIdx.y) * cols + static_cast<size_t>(vec) * V;
  if constexpr (V == 1) {
    out[off] = v[0];
  } else {
    store_vec<V>(out, off, 0, v);
  }
}

// One pass over rows [0, rows) in chunks of rows_per_chunk, each chunk's
// sums a row of out: tiles of 32 vectors (a warp reads 512 contiguous bytes
// of a row) where there are several chunks, of 8 where one chunk covers
// every row (more blocks for few rows).
template <typename T>
cudaError_t launch_column_sum(const void* x, float* out, int rows, int cols,
                              int rows_per_chunk, cudaStream_t stream) {
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  const int width = chunks > 1 ? 32 : 8;
  const T* xt = static_cast<const T*>(x);
  if (cols % kVec16<T> == 0) {
    constexpr int V = kVec16<T>;
    const dim3 grid((cols / V + width - 1) / width, chunks);
    column_sum_kernel<T, V><<<grid, kColThreads, 0, stream>>>(xt, out, rows, cols,
                                                             rows_per_chunk, width);
  } else {
    const dim3 grid((cols + width - 1) / width, chunks);
    column_sum_kernel<T, 1><<<grid, kColThreads, 0, stream>>>(xt, out, rows, cols,
                                                             rows_per_chunk, width);
  }
  return cudaGetLastError();
}

}  // namespace vit

// partial: fp32 scratch of ceil(rows / rows_per_chunk) * cols (unused, and
// may be null, when rows_per_chunk >= rows: one pass).
VIT_EXPORT int vit_column_sum(const void* x, int x_dtype, float* out, float* partial,
                              int rows, int cols, int rows_per_chunk, void* stream) {
  using namespace vit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0 || rows_per_chunk <= 0) return cudaErrorInvalidValue;
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  if (chunks > 65535 || (chunks > 1 && partial == nullptr)) return cudaErrorInvalidValue;
  float* first = chunks > 1 ? partial : out;
  cudaError_t err;
  if (x_dtype == kF32)
    err = launch_column_sum<float>(x, first, rows, cols, rows_per_chunk, s);
  else if (x_dtype == kBF16)
    err = launch_column_sum<bf16>(x, first, rows, cols, rows_per_chunk, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || chunks == 1) return err;
  return launch_column_sum<float>(partial, out, chunks, cols, chunks, s);
}

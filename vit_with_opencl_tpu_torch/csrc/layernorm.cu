// Per-row LayerNorm with fp32 statistics.
//
// Replaces vit_with_opencl_tpu/ops/layernorm.py:_ln_kernel (layer_norm) and
// the two LN stages that ops/fused_block.py:_block_kernel inlines (_ln).
// Contract: mean = E[x], var = E[x^2] - E[x]^2, both in fp32 whatever the
// input dtype; y = (x - mean) * rsqrt(var + eps) * w + b, cast to the output
// dtype. The input is bf16 or fp32 and the output dtype is chosen separately:
// the encoder chain normalises the fp32 residual stream into bf16 (LN2).
//
// Bound on the card: bytes. A row is read twice (statistics, then the
// normalised write), but the second read comes from L1/L2, so device memory
// sees each input byte once and each output byte once. Design: one warp per
// row, lanes striding over the row so each load instruction is coalesced, and
// the two sums reduced with warp shuffles; no shared memory and no
// __syncthreads, so a block of 8 warps normalises 8 independent rows.
#include "common.cuh"

namespace vit {

constexpr int kLnWarps = 8;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kLnWarps * 32)
layernorm_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, TOut* __restrict__ y, int rows,
                 int cols, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const TIn* xr = x + static_cast<size_t>(row) * cols;
  float sum = 0.f, sum_sq = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float v = to_float(xr[c]);
    sum += v;
    sum_sq += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sum_sq += __shfl_xor_sync(0xffffffffu, sum_sq, off);
  }
  const float mean = sum / cols;
  const float var = sum_sq / cols - mean * mean;
  const float inv = rsqrtf(var + eps);
  TOut* yr = y + static_cast<size_t>(row) * cols;
  for (int c = lane; c < cols; c += 32) {
    const float v = to_float(xr[c]);
    yr[c] = from_float<TOut>((v - mean) * inv * w[c] + b[c]);
  }
}

template <typename TIn, typename TOut>
cudaError_t launch_layernorm(const void* x, const float* w, const float* b,
                             void* y, int rows, int cols, float eps,
                             cudaStream_t stream) {
  const dim3 grid((rows + kLnWarps - 1) / kLnWarps);
  layernorm_kernel<TIn, TOut><<<grid, kLnWarps * 32, 0, stream>>>(
      static_cast<const TIn*>(x), w, b, static_cast<TOut*>(y), rows, cols,
      eps);
  return cudaGetLastError();
}

}  // namespace vit

VIT_EXPORT int vit_layernorm(const void* x, int x_dtype, const float* w,
                             const float* b, void* y, int y_dtype, int rows,
                             int cols, float eps, void* stream) {
  using namespace vit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16 && y_dtype == kBF16)
    return launch_layernorm<bf16, bf16>(x, w, b, y, rows, cols, eps, s);
  if (x_dtype == kF32 && y_dtype == kBF16)
    return launch_layernorm<float, bf16>(x, w, b, y, rows, cols, eps, s);
  if (x_dtype == kBF16 && y_dtype == kF32)
    return launch_layernorm<bf16, float>(x, w, b, y, rows, cols, eps, s);
  if (x_dtype == kF32 && y_dtype == kF32)
    return launch_layernorm<float, float>(x, w, b, y, rows, cols, eps, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// LayerNorm backward (ops/fused_block.py:_ln_bwd with _ln_fwd_stats, inside
// _mlp_bwd_kernel at LN2 and _attn_bwd_kernel at LN1). Per row, from x and
// the fp32 output gradient dy:
//   mean, inv as the forward (var = E[x^2] - E[x]^2); xhat = (x - mean) * inv
//   dxhat = dy * w
//   dx = inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//   out = g + dx (g: the residual branch's gradient, optional), cast to the
//   output dtype; the per-row dw = dy * xhat and db = dy summed over the
//   block's rows into one partial row each of dw and db.
// The TPU kernel summed dw and db over the tokens in VMEM along a sequential
// grid; here each block of 8 warps owns kLnBwdRows rows, each warp keeps its
// own column sums in shared memory (a lane owns the columns c = lane mod 32,
// so no two threads add to one address), the block adds its warps in a fixed
// order, and ops/layernorm.column_sum reduces the partial rows: no atomics,
// the same result from run to run. Bound on the card: bytes (x, dy, g read,
// dx written once; each row's second and third reads come from L1).
// ---------------------------------------------------------------------------

namespace vit {

constexpr int kLnBwdRows = 64;

template <typename TX, typename TG, typename TOut>
__global__ void __launch_bounds__(kLnWarps * 32)
layernorm_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ w, const TG* __restrict__ g,
                     TOut* __restrict__ dx, float* __restrict__ part_dw,
                     float* __restrict__ part_db, int rows, int cols, float eps) {
  extern __shared__ float sums[];  // [2][kLnWarps][cols]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sdw = sums + warp * cols;
  float* sdb = sums + (kLnWarps + warp) * cols;
  for (int c = lane; c < cols; c += 32) sdw[c] = sdb[c] = 0.f;
  const int first = blockIdx.x * kLnBwdRows;
  const int last = min(first + kLnBwdRows, rows);
  for (int row = first + warp; row < last; row += kLnWarps) {
    const TX* xr = x + static_cast<size_t>(row) * cols;
    const float* dyr = dy + static_cast<size_t>(row) * cols;
    float sum = 0.f, sum_sq = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float v = to_float(xr[c]);
      sum += v;
      sum_sq += v * v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sum_sq += __shfl_xor_sync(0xffffffffu, sum_sq, off);
    }
    const float mean = sum / cols;
    const float var = sum_sq / cols - mean * mean;
    const float inv = rsqrtf(var + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float xhat = (to_float(xr[c]) - mean) * inv;
      const float d = dyr[c];
      const float dxhat = d * w[c];
      s1 += dxhat;
      s2 += dxhat * xhat;
      sdw[c] += d * xhat;
      sdb[c] += d;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / cols, m2 = s2 / cols;
    TOut* outr = dx + static_cast<size_t>(row) * cols;
    const TG* gr = g == nullptr ? nullptr : g + static_cast<size_t>(row) * cols;
    for (int c = lane; c < cols; c += 32) {
      const float xhat = (to_float(xr[c]) - mean) * inv;
      const float dxhat = dyr[c] * w[c];
      float v = inv * (dxhat - m1 - xhat * m2);
      if (gr != nullptr) v = to_float(gr[c]) + v;
      outr[c] = from_float<TOut>(v);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    float dw = 0.f, db = 0.f;
    for (int k = 0; k < kLnWarps; ++k) {
      dw += sums[k * cols + c];
      db += sums[(kLnWarps + k) * cols + c];
    }
    part_dw[static_cast<size_t>(blockIdx.x) * cols + c] = dw;
    part_db[static_cast<size_t>(blockIdx.x) * cols + c] = db;
  }
}

template <typename TX, typename TG, typename TOut>
cudaError_t launch_layernorm_bwd(const void* x, const float* dy, const float* w,
                                 const void* g, void* dx, float* part_dw,
                                 float* part_db, int rows, int cols, float eps,
                                 cudaStream_t stream) {
  const size_t smem = 2 * kLnWarps * static_cast<size_t>(cols) * sizeof(float);
  auto kernel = layernorm_bwd_kernel<TX, TG, TOut>;
  cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kLnBwdRows - 1) / kLnBwdRows);
  kernel<<<grid, kLnWarps * 32, smem, stream>>>(
      static_cast<const TX*>(x), dy, w, static_cast<const TG*>(g),
      static_cast<TOut*>(dx), part_dw, part_db, rows, cols, eps);
  return cudaGetLastError();
}

template <typename TX, typename TG>
cudaError_t layernorm_bwd_out(const void* x, const float* dy, const float* w,
                              const void* g, void* dx, int dx_dtype, float* part_dw,
                              float* part_db, int rows, int cols, float eps,
                              cudaStream_t s) {
  if (dx_dtype == kF32)
    return launch_layernorm_bwd<TX, TG, float>(x, dy, w, g, dx, part_dw, part_db,
                                               rows, cols, eps, s);
  if (dx_dtype == kBF16)
    return launch_layernorm_bwd<TX, TG, bf16>(x, dy, w, g, dx, part_dw, part_db,
                                              rows, cols, eps, s);
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t layernorm_bwd_g(const void* x, const float* dy, const float* w,
                            const void* g, int g_dtype, void* dx, int dx_dtype,
                            float* part_dw, float* part_db, int rows, int cols,
                            float eps, cudaStream_t s) {
  if (g == nullptr || g_dtype == kF32)  // a null g of either type adds nothing
    return layernorm_bwd_out<TX, float>(x, dy, w, g, dx, dx_dtype, part_dw, part_db,
                                        rows, cols, eps, s);
  if (g_dtype == kBF16)
    return layernorm_bwd_out<TX, bf16>(x, dy, w, g, dx, dx_dtype, part_dw, part_db,
                                       rows, cols, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace vit

// x [rows, cols] fp32 or bf16, dy [rows, cols] fp32, w [cols] fp32, g (null
// or [rows, cols] fp32 or bf16) → dx [rows, cols] fp32 or bf16, and the
// partial column sums part_dw, part_db [ceil(rows / 64), cols] fp32.
VIT_EXPORT int vit_layernorm_bwd(const void* x, int x_dtype, const float* dy,
                                 const float* w, const void* g, int g_dtype, void* dx,
                                 int dx_dtype, float* part_dw, float* part_db,
                                 int rows, int cols, float eps, void* stream) {
  using namespace vit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  if (x_dtype == kF32)
    return layernorm_bwd_g<float>(x, dy, w, g, g_dtype, dx, dx_dtype, part_dw,
                                  part_db, rows, cols, eps, s);
  if (x_dtype == kBF16)
    return layernorm_bwd_g<bf16>(x, dy, w, g, g_dtype, dx, dx_dtype, part_dw,
                                 part_db, rows, cols, eps, s);
  return cudaErrorInvalidValue;
}

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

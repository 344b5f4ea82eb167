// Per-row symmetric int8 quantization with a dynamic absmax scale.
//
// Replaces the per-token quantize that ops/fused_block.py:_block_kernel runs
// in front of each of its four int8 GEMMs when w8a8=True (_quantize_rows,
// which is models/quant.py:quantize_act). Contract, for each row of K values:
//   absmax = max(max_k |x_k|, 2^-93)       the floor keeps a zero row finite
//   r      = 127 / absmax                  one IEEE divide per row
//   q_k    = round_half_even(x_k * r)      as int8; no clip is needed, since
//                                          |x_k * r| <= 127 * (1 + 2^-23)
//   scale  = absmax * float(1/127)         a multiply, not a divide
// The input is fp32 (the LN outputs and the GELU'd hidden of the encoder
// chain) or bf16 (the attention context), upcast exactly. Build without
// --use_fast_math: it would turn the divide into an approximate one.
//
// Bound on the card: bytes, M*K*(in + 1) + 4*M. Design: one warp per row,
// lanes striding over the row four values at a time (16-byte fp32 or 8-byte
// bf16 loads, 4-byte int8 stores), the absmax reduced with warp shuffles.
// The row is read twice, the second time from L1/L2, as layernorm.cu does.
// Not yet done: fusing this pass into the LN kernel or the producing GEMM's
// epilogue, which would save a round trip of the activation.
#include "common.cuh"

namespace vit {

constexpr int kQuantWarps = 8;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(b[e]);
}

template <typename TIn>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_kernel(const TIn* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int rows, int cols) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const TIn* xr = x + static_cast<size_t>(row) * cols;
  float amax = 0.f;
  for (int c = lane * 4; c < cols; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  amax = fmaxf(amax, 0x1p-93f);
  const float r = 127.0f / amax;  // IEEE division (nvcc's -prec-div=true)
  int8_t* qr = q + static_cast<size_t>(row) * cols;
  for (int c = lane * 4; c < cols; c += 128) {
    float v[4];
    load4(xr + c, v);
    char4 out;
    // __float2int_rn rounds half to even, as jnp.round; roundf would not.
    out.x = static_cast<signed char>(__float2int_rn(__fmul_rn(v[0], r)));
    out.y = static_cast<signed char>(__float2int_rn(__fmul_rn(v[1], r)));
    out.z = static_cast<signed char>(__float2int_rn(__fmul_rn(v[2], r)));
    out.w = static_cast<signed char>(__float2int_rn(__fmul_rn(v[3], r)));
    *reinterpret_cast<char4*>(qr + c) = out;
  }
  if (lane == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

template <typename TIn>
cudaError_t launch_quantize(const void* x, void* q, float* scale, int rows,
                            int cols, cudaStream_t stream) {
  const dim3 grid((rows + kQuantWarps - 1) / kQuantWarps);
  quantize_rows_kernel<TIn><<<grid, kQuantWarps * 32, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<int8_t*>(q), scale, rows, cols);
  return cudaGetLastError();
}

}  // namespace vit

VIT_EXPORT int vit_quantize_rows(const void* x, int x_dtype, void* q,
                                 float* scale, int rows, int cols,
                                 void* stream) {
  using namespace vit;
  if (rows <= 0 || cols <= 0 || cols % 4 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return launch_quantize<float>(x, q, scale, rows, cols, s);
  if (x_dtype == kBF16) return launch_quantize<bf16>(x, q, scale, rows, cols, s);
  return cudaErrorInvalidValue;
}

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
//
// Two forms for the calibrated outlier-aware W8A8 layer (_block_kernel with
// outlier=True), with the same exactness rules:
//   quantize_rows_split_kernel   _mm with hi_ref (fused_block.py:108-116):
//     the fp32 LN output or GELU'd hidden; the leading m of each row's K
//     values are quantized as above (the absmax over those m only; q has
//     row stride m), and the trailing K - m are rounded to bf16 for the side
//     GEMM in the same pass (__float2bfloat16_rn: round to nearest even, as
//     XLA's convert);
//   quantize_rows_masked_kernel  _mm_ctx_masked (fused_block.py:128-152):
//     the bf16 attention context, whose per-head tails (the last kh of each
//     head's head_dim columns) are left out of the absmax and clipped to
//     +-127 before the int8 cast (they can exceed the kept absmax; their
//     weight rows are zero), and copied out in head order for the side GEMM.
// Bound: bytes, M*(4*K + m + 2*(K - m) + 4) (split), M*(3*K + 2*nh*kh + 4)
// (masked).
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

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 raw;
  raw.x = pack_bf16x2(v[0], v[1]);
  raw.y = pack_bf16x2(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The warp's absmax (every lane gets it), floored, and r = 127 / absmax.
__device__ __forceinline__ float warp_absmax(float amax) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return fmaxf(amax, 0x1p-93f);
}

// __float2int_rn rounds half to even, as jnp.round; roundf would not.
__device__ __forceinline__ signed char quantize_one(float v, float r) {
  return static_cast<signed char>(__float2int_rn(__fmul_rn(v, r)));
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
  amax = warp_absmax(amax);
  const float r = 127.0f / amax;  // IEEE division (nvcc's -prec-div=true)
  int8_t* qr = q + static_cast<size_t>(row) * cols;
  for (int c = lane * 4; c < cols; c += 128) {
    float v[4];
    load4(xr + c, v);
    char4 out;
    out.x = quantize_one(v[0], r);
    out.y = quantize_one(v[1], r);
    out.z = quantize_one(v[2], r);
    out.w = quantize_one(v[3], r);
    *reinterpret_cast<char4*>(qr + c) = out;
  }
  if (lane == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

// Row stride cols in x, m in q, cols - m in hi; m and cols multiples of 4.
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_split_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                           float* __restrict__ scale, bf16* __restrict__ hi,
                           int rows, int cols, int m) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * cols;
  float amax = 0.f;
  for (int c = lane * 4; c < m; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = warp_absmax(amax);
  const float r = 127.0f / amax;
  int8_t* qr = q + static_cast<size_t>(row) * m;
  for (int c = lane * 4; c < m; c += 128) {
    float v[4];
    load4(xr + c, v);
    char4 out;
    out.x = quantize_one(v[0], r);
    out.y = quantize_one(v[1], r);
    out.z = quantize_one(v[2], r);
    out.w = quantize_one(v[3], r);
    *reinterpret_cast<char4*>(qr + c) = out;
  }
  bf16* hr = hi + static_cast<size_t>(row) * (cols - m);
  for (int c = m + lane * 4; c < cols; c += 128) {
    float v[4];
    load4(xr + c, v);
    store4(hr + (c - m), v);
  }
  if (lane == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

// The tail columns of head h are h*head_dim + [head_dim - kh, head_dim);
// hi has row stride num_heads * kh.
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_masked_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                            float* __restrict__ scale, bf16* __restrict__ hi,
                            int rows, int cols, int head_dim, int kh) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int keep = head_dim - kh;
  const bf16* xr = x + static_cast<size_t>(row) * cols;
  float amax = 0.f;
  for (int c = lane * 4; c < cols; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((c + e) % head_dim < keep) amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = warp_absmax(amax);
  const float r = 127.0f / amax;
  int8_t* qr = q + static_cast<size_t>(row) * cols;
  bf16* hr = hi + static_cast<size_t>(row) * (cols / head_dim) * kh;
  for (int c = lane * 4; c < cols; c += 128) {
    float v[4];
    load4(xr + c, v);
    signed char out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int in_head = (c + e) % head_dim;
      // Clip, then cast: a tail value may be many times the kept absmax
      // (__float2int_rn saturates, so even a huge product clips right).
      const int qi = __float2int_rn(__fmul_rn(v[e], r));
      out[e] = static_cast<signed char>(max(-127, min(127, qi)));
      if (in_head >= keep)  // exact: v[e] was read from bf16
        hr[((c + e) / head_dim) * kh + in_head - keep] = __float2bfloat16_rn(v[e]);
    }
    *reinterpret_cast<char4*>(qr + c) = make_char4(out[0], out[1], out[2], out[3]);
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

// x fp32 [rows, cols]; q int8 [rows, m]; hi bf16 [rows, cols - m].
VIT_EXPORT int vit_quantize_rows_split(const float* x, void* q, float* scale,
                                       void* hi, int rows, int cols, int m,
                                       void* stream) {
  using namespace vit;
  if (rows <= 0 || cols <= 0 || m <= 0 || m >= cols || cols % 4 != 0 ||
      m % 4 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((rows + kQuantWarps - 1) / kQuantWarps);
  quantize_rows_split_kernel<<<grid, kQuantWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int8_t*>(q), scale, static_cast<bf16*>(hi), rows, cols, m);
  return cudaGetLastError();
}

// x bf16 [rows, cols = num_heads * head_dim]; q int8 [rows, cols];
// hi bf16 [rows, num_heads * kh].
VIT_EXPORT int vit_quantize_rows_masked(const void* x, void* q, float* scale,
                                        void* hi, int rows, int cols,
                                        int head_dim, int kh, void* stream) {
  using namespace vit;
  if (rows <= 0 || cols <= 0 || cols % 4 != 0 || head_dim <= 0 ||
      cols % head_dim != 0 || kh <= 0 || kh >= head_dim)
    return cudaErrorInvalidValue;
  const dim3 grid((rows + kQuantWarps - 1) / kQuantWarps);
  quantize_rows_masked_kernel<<<grid, kQuantWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(q), scale,
      static_cast<bf16*>(hi), rows, cols, head_dim, kh);
  return cudaGetLastError();
}

// Blockwise (long-sequence) multi-head attention in fp32: the forward, with
// each row's log-sum-exp as an option.
//
// Replaces vit_with_opencl_tpu/ops/attention.py:_flash_kernel and
// _flash_kernel_lse (_blockwise_fwd_flat) with fp32 inputs, the route the
// JAX package takes past padded T = SINGLE_PASS_MAX_T = 1024; the bf16 form
// is attention_flash.cu's. Per head, the TPU kernel's arithmetic:
//   s  = (q . k^T) * scale      fp32 sums, scale an fp32 multiplier of the
//                               scores (q is not scaled)
//   keys at and past kv_len masked (MASK_VALUE in JAX: exp underflows to 0;
//   -inf here, the same p, and the same max, since every key block holds a
//   key below kv_len)
//   over key blocks of block_k in order: m' = max(m, rowmax(s)),
//   a = exp(m - m'), p = exp(s - m'), l = a * l + rowsum(p),
//   acc = acc * a + p . v
//   o = acc * (1 / l), lse = m + log(l)   (l == 0 -> 1 in both)
// In fp32, JAX's p.astype(v.dtype) rounds nothing: block_k (128, its
// default, or 256 and 512, its sweep's) sets only where a is taken and the
// order of the fp32 sums, not a rounding point. The wrapper takes those
// three tiles, as the bf16 form's instances, so both dtypes keep one rule.
//
// Bound on the card: operations, 4 T^2 hd a head (the two products) at 67
// TFLOP/s fp32: 0.257 ms at ViT-L/16@512 (T = 1025, 16 heads of 64) and
// B = 4, 1.028 ms at B = 16; the bytes (q, k, v and the context, 16 T hd
// bytes a head) take 0.080 ms at B = 16. Design: the register-tiled
// CUDA-core body of attention_f32.cuh (plain FMA, no TF32) in its blockwise
// form: blocks of 64 queries, 4 x 4 micro-tiles of S read as float4s from
// row-major q and K tiles in shared memory, p staged there for the
// register-tiled p . V, K and V double-buffered by cp.async in 64-key
// tiles; each key block's tiles taken twice (its exact row max, then p, its
// row sums and p . V), so the body's own work is 6 T^2 hd a head. Tiles of the last block that hold no
// key below kv_len are not taken. Every sum runs in a fixed order: two
// calls give the same bits.
//
// One kernel serves both entries: q, k, v and out are strided [B, H, T, hd]
// views (the slab entry's are the head columns of [B, T, 3D] and [B, T, D],
// flash_attention's any split-head views with 16-byte rows).
#include "attention_f32.cuh"

namespace vit {
namespace flash32 {

template <int HDP>
__global__ void __launch_bounds__(f32attn::kThreads, f32attn::min_blocks<HDP>())
blockwise_f32_tiled_kernel(const __grid_constant__ f32attn::Args args) {
  f32attn::attention_f32<HDP, f32attn::kBlockwise>(args);
}

template <int HDP>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* lse,
                   HeadViews views, int B, int H, int T, int kv_len, int hd, int block_k,
                   float scale, cudaStream_t stream) {
  f32attn::Args args{q, k, v, out, views.q, views.k, views.v, views.o,
                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     T, kv_len, block_k, hd, scale, lse};
  return f32attn::launch(blockwise_f32_tiled_kernel<HDP>, f32attn::smem_bytes<HDP>(), args,
                         H, B, stream);
}

}  // namespace flash32
}  // namespace vit

// q, k, v -> out, all fp32 [B, num_heads, T, head_dim] views given by base
// pointers and `strides` (12 element strides: image, head and row of q, k,
// v and out in turn; the last axis contiguous, rows 16-byte aligned); lse
// [B, num_heads, T] fp32 or NULL. Keys at and past kv_len (1 <= kv_len <=
// T) are masked; block_k is 128, 256 or 512; `scale` is float32(1 /
// sqrt(head_dim)); head_dim a multiple of 8 up to 128 (ops/attention.py
// checks all of it first).
VIT_EXPORT int vit_flash_attention_fwd_strided_f32(const float* q, const float* k,
                                                   const float* v, float* out, float* lse,
                                                   const long long* strides, int B, int T,
                                                   int kv_len, int num_heads, int head_dim,
                                                   int block_k, float scale, void* stream) {
  using vit::flash32::launch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || kv_len <= 0 || kv_len > T ||
      head_dim % 8 != 0 || head_dim > 128 ||
      (block_k != 128 && block_k != 256 && block_k != 512))
    return cudaErrorInvalidValue;
  const vit::HeadViews w = vit::head_views(strides);
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return launch<16>(q, k, v, out, lse, w, B, num_heads, T, kv_len, head_dim, block_k, scale, s);
    case 32: return launch<32>(q, k, v, out, lse, w, B, num_heads, T, kv_len, head_dim, block_k, scale, s);
    case 48: return launch<48>(q, k, v, out, lse, w, B, num_heads, T, kv_len, head_dim, block_k, scale, s);
    case 64: return launch<64>(q, k, v, out, lse, w, B, num_heads, T, kv_len, head_dim, block_k, scale, s);
    case 80: return launch<80>(q, k, v, out, lse, w, B, num_heads, T, kv_len, head_dim, block_k, scale, s);
    case 96: return launch<96>(q, k, v, out, lse, w, B, num_heads, T, kv_len, head_dim, block_k, scale, s);
    case 112: return launch<112>(q, k, v, out, lse, w, B, num_heads, T, kv_len, head_dim, block_k, scale, s);
    case 128: return launch<128>(q, k, v, out, lse, w, B, num_heads, T, kv_len, head_dim, block_k, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// qkv [B, T, 3D] fp32, slab-packed -> out [B, T, D] fp32 (head-major
// context) and, where lse is not NULL, lse [B, num_heads, T] fp32: the
// strided entry on the slabs' head views (head h's q, k and v at columns
// h hd, D + h hd and 2 D + h hd of rows 3 D floats apart).
VIT_EXPORT int vit_flash_attention_fwd_f32(const float* qkv, float* out, float* lse, int B,
                                           int T, int kv_len, int num_heads, int head_dim,
                                           int block_k, float scale, void* stream) {
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  const long long D = static_cast<long long>(num_heads) * head_dim;
  const long long strides[12] = {T * 3 * D, head_dim, 3 * D, T * 3 * D, head_dim, 3 * D,
                                 T * 3 * D, head_dim, 3 * D, T * D,     head_dim, D};
  return vit_flash_attention_fwd_strided_f32(qkv, qkv + D, qkv + 2 * D, out, lse, strides, B,
                                             T, kv_len, num_heads, head_dim, block_k, scale,
                                             stream);
}

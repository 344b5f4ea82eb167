// One-shot (single-pass) multi-head attention on split heads: [B, H, T, hd]
// -> [B, H, T, hd], bf16 or fp32.
//
// Replaces vit_with_opencl_tpu/ops/attention.py:_single_pass_kernel
// (flash_attention for T <= SINGLE_PASS_MAX_T = 1024). Per head, the
// numerics of _head_attention with keys past kv_len masked:
//   qs = q * scale          scale rounded to q's dtype, product rounded too
//   s  = qs . k^T           fp32; keys >= kv_len masked to MASK_VALUE
//   m  = rowmax(s)          over all keys: one-shot, no online rescaling
//   e  = exp(s - m)         fp32; inv = 1 / rowsum(e), fp32
//   o  = (dtype(e) . v) * inv, fp32 accumulation, cast to q's dtype
// q, k, v and out are strided views (image, head and row strides, the last
// axis contiguous), so one entry serves split-head tensors, the permuted
// views of a [B, T, 3D] GEMM output and the slab- or head-packed qkv of
// packed_fused_attention.
//
// bf16: the Hopper body of the packed attention (attention.cu,
// single_pass_attention_kernel), which is this function with kv_len = T:
// K and V read by TMA from maps over their views, wgmma products, one pass
// up to 256 keys and the exact max then e in two passes past that.
//
// fp32: the register-tiled CUDA-core body of attention_f32.cuh (plain FMA,
// no TF32, e not rounded), shared with the ring step's fp32 form: blocks of
// 64 queries, 4 x 4 micro-tiles of S read as float4s from row-major q and
// K tiles in rows of hd + 4 floats in shared memory, e staged in shared
// memory for the register-tiled e . V (V row-major alike), two
// passes over double-buffered 64-key tiles (the exact row max, then e, its
// sum and e . V). Bound on the card: operations (fp32 at ViT-B's T = 197,
// B = 16: 1.9 GFLOP, 0.0285 ms at 67 TFLOP/s).
//
// The fp32 slab entry (vit_packed_attention_f32) is the same body on the
// packed [B, T, 3D] qkv over every key: it replaces
// vit_with_opencl_tpu/ops/attention.py:_packed_kernel (packed_fused_attention
// with slab packing, T <= 1024) in fp32, whose per-head arithmetic is
// _head_attention's, this function's with kv_len = T (in fp32 the scale and
// the PV operand round nowhere). Head h's q, k and v are the views at
// columns h hd, D + h hd and 2 D + h hd of rows 3 D floats apart; the
// context goes to columns h hd of [B, T, D].
#include "attention_f32.cuh"

namespace vit {
namespace single {

template <int HDP>
__global__ void __launch_bounds__(f32attn::kThreads, f32attn::min_blocks<HDP>())
single_pass_f32_tiled_kernel(const __grid_constant__ f32attn::Args args) {
  f32attn::attention_f32<HDP, f32attn::kSinglePass>(args);
}

template <int HDP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       HeadViews views, int B, int H, int T, int kv_len, int hd,
                       float scale, cudaStream_t stream) {
  f32attn::Args args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(out),
                     views.q, views.k, views.v, views.o, nullptr, nullptr, nullptr,
                     nullptr, nullptr, nullptr, T, kv_len, kv_len, hd, scale};
  return f32attn::launch(single_pass_f32_tiled_kernel<HDP>, f32attn::smem_bytes<HDP>(), args,
                         H, B, stream);
}

}  // namespace single

namespace attn90 {
// The bf16 form, in attention.cu.
cudaError_t single_pass_views_bf16(const void* q, const void* k, const void* v, void* out,
                                   const long long* strides, int B, int H, int T, int kv_len,
                                   int hd, float scale, cudaStream_t stream);
}  // namespace attn90
}  // namespace vit

// q, k, v -> out, all [B, num_heads, T, head_dim] views of `dtype` (0 fp32,
// 1 bf16) given by base pointers and `strides` (12 element strides: image,
// head and row of q, k, v and out in turn; the last axis contiguous, rows
// 16-byte aligned). Keys at and past kv_len (1 <= kv_len <= T) are masked.
// `scale` is 1/sqrt(head_dim) already rounded to the dtype. head_dim must be
// a multiple of 8 up to 128 (ops/attention.py checks all of it first).
VIT_EXPORT int vit_single_pass_attention(const void* q, const void* k, const void* v,
                                         void* out, int dtype,
                                         const long long* strides, int B,
                                         int num_heads, int T, int kv_len,
                                         int head_dim, float scale, void* stream) {
  using namespace vit::single;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || kv_len <= 0 || kv_len > T ||
      head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  if (dtype == vit::kBF16)
    return vit::attn90::single_pass_views_bf16(q, k, v, out, strides, B, num_heads, T,
                                                kv_len, head_dim, scale, s);
  if (dtype != vit::kF32) return cudaErrorInvalidValue;
  const vit::HeadViews views = vit::head_views(strides);
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return launch_f32<16>(q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 32: return launch_f32<32>(q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 48: return launch_f32<48>(q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 64: return launch_f32<64>(q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 80: return launch_f32<80>(q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 96: return launch_f32<96>(q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 112: return launch_f32<112>(q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 128: return launch_f32<128>(q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// qkv [B, T, 3D] fp32, slab-packed -> out [B, T, D] fp32, every key of each
// head (packed_fused_attention's slab route in fp32). `scale` is
// float32(1/sqrt(head_dim)); head_dim a multiple of 8 up to 128.
VIT_EXPORT int vit_packed_attention_f32(const float* qkv, float* out, int B, int T,
                                        int num_heads, int head_dim, float scale,
                                        void* stream) {
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  const long long D = static_cast<long long>(num_heads) * head_dim;
  const long long strides[12] = {T * 3 * D, head_dim, 3 * D, T * 3 * D, head_dim, 3 * D,
                                 T * 3 * D, head_dim, 3 * D, T * D,     head_dim, D};
  return vit_single_pass_attention(qkv, qkv + D, qkv + 2 * D, out, vit::kF32, strides, B,
                                   num_heads, T, T, head_dim, scale, stream);
}

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
// fp32 (not rebuilt for Hopper yet): plain FMA on the CUDA cores (no TF32,
// e not rounded), one thread per query row (two for head dims past 64, each
// holding half of the row), K/V tiles of 32 rows in shared memory read as
// broadcasts, two passes (the exact row max, then e, its sum and e . V).
// Bound on the card: operations (fp32 at ViT-B's T = 197, B = 16: 1.9
// GFLOP, 0.0285 ms at 67 TFLOP/s).
#include <math.h>

#include "attention_tiles.cuh"

namespace vit {
namespace single {

using namespace tiles;

// fp32: one thread per query row, or two (SPLIT) holding half of the head
// dim each, which add their partial dot products with a shuffle.
constexpr int kF32Rows = 64;  // query rows of a block
constexpr int kF32Tile = 32;  // K/V rows of a tile

template <int HDP>
__host__ __device__ constexpr int f32_split() {
  return HDP > 64 ? 2 : 1;
}
template <int HDP>
__host__ __device__ constexpr size_t f32_smem_bytes() {  // a K and a V tile
  return 2 * kF32Tile * HDP * sizeof(float);
}

template <int HDP>
__global__ void __launch_bounds__(kF32Rows * (HDP > 64 ? 2 : 1))
single_pass_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       HeadViews views, int T, int kv_len, int hd, float scale) {
  constexpr int kSplit = f32_split<HDP>();
  constexpr int kDims = HDP / kSplit;  // a thread's share of the head dim
  const int b = blockIdx.z, h = blockIdx.y;
  const float* kb = head_base(k, views.k, b, h);
  const float* vb = head_base(v, views.v, b, h);
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [kF32Tile][HDP]
  float* vs = ks + kF32Tile * HDP;             // [kF32Tile][HDP]
  const int part = threadIdx.x % kSplit, d0 = part * kDims;
  const int row = blockIdx.x * kF32Rows + threadIdx.x / kSplit;

  float qr[kDims], o[kDims];
  const float* qrow = head_base(q, views.q, b, h) + static_cast<long long>(row) * views.q.row;
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    qr[d] = row < T && d0 + d < hd ? qrow[d0 + d] * scale : 0.f;
    o[d] = 0.f;
  }
  // Rows [j0, j0 + kF32Tile) of K (and V) into shared memory, zeros past
  // kv_len and hd; 16-byte loads (hd and the row strides are multiples of 4).
  auto load = [&](float* dst, const float* base, long long pitch, int j0) {
    constexpr int kChunks = HDP / 4;
    for (int i = threadIdx.x; i < kF32Tile * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + r < kv_len && c < hd)
        val = *reinterpret_cast<const float4*>(base + (j0 + r) * pitch + c);
      *reinterpret_cast<float4*>(dst + r * HDP + c) = val;
    }
  };
  auto score = [&](int j) {  // the same FMA order in both passes
    const float* kr = ks + j * HDP + d0;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kDims; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
      s = fmaf(qr[d], kv.x, s);
      s = fmaf(qr[d + 1], kv.y, s);
      s = fmaf(qr[d + 2], kv.z, s);
      s = fmaf(qr[d + 3], kv.w, s);
    }
    if (kSplit == 2) s += __shfl_xor_sync(0xffffffffu, s, 1);
    return s;
  };

  // Pass 1: each row's max over the keys below kv_len (masked keys score
  // MASK_VALUE, below any real score, and their e is exactly 0: skipped).
  float m = -INFINITY;
  for (int j0 = 0; j0 < kv_len; j0 += kF32Tile) {
    __syncthreads();
    load(ks, kb, views.k.row, j0);
    __syncthreads();
    const int n = min(kF32Tile, kv_len - j0);
    for (int j = 0; j < n; ++j) m = fmaxf(m, score(j));
  }
  // Pass 2: e against the final max, fp32 row sum, fp32 e . V.
  float l = 0.f;
  for (int j0 = 0; j0 < kv_len; j0 += kF32Tile) {
    __syncthreads();
    load(ks, kb, views.k.row, j0);
    load(vs, vb, views.v.row, j0);
    __syncthreads();
    const int n = min(kF32Tile, kv_len - j0);
    for (int j = 0; j < n; ++j) {
      const float e = expf(score(j) - m);
      l += e;
      const float* vr = vs + j * HDP + d0;
#pragma unroll
      for (int d = 0; d < kDims; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        o[d] = fmaf(e, vv.x, o[d]);
        o[d + 1] = fmaf(e, vv.y, o[d + 1]);
        o[d + 2] = fmaf(e, vv.z, o[d + 2]);
        o[d + 3] = fmaf(e, vv.w, o[d + 3]);
      }
    }
  }
  if (row >= T) return;  // no barrier follows
  const float inv = 1.f / l;
  float* orow = head_base(out, views.o, b, h) + static_cast<long long>(row) * views.o.row;
#pragma unroll
  for (int d = 0; d < kDims; ++d)
    if (d0 + d < hd) orow[d0 + d] = o[d] * inv;
}

template <int HDP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       HeadViews views, int B, int H, int T, int kv_len, int hd,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HDP>();
  cudaError_t err = allow_dynamic_smem(single_pass_f32_kernel<HDP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kF32Rows - 1) / kF32Rows, H, B);
  single_pass_f32_kernel<HDP><<<grid, kF32Rows * f32_split<HDP>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), views, T, kv_len, hd,
      scale);
  return cudaGetLastError();
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
  const vit::tiles::HeadViews views = vit::tiles::head_views(strides);
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

// One-shot (single-pass) multi-head attention on split heads, streaming its
// K/V tiles: [B, H, T, hd] -> [B, H, T, hd], bf16 or fp32.
//
// Replaces vit_with_opencl_tpu/ops/attention.py:_single_pass_kernel
// (flash_attention for T <= SINGLE_PASS_MAX_T = 1024). Per head, the
// numerics of _head_attention with keys past kv_len masked:
//   qs = q * scale          scale rounded to q's dtype, product rounded too
//   s  = qs . k^T           fp32; keys >= kv_len masked to MASK_VALUE
//   m  = rowmax(s)          over all keys: one-shot, no online rescaling
//   e  = exp(s - m)         fp32; inv = 1 / rowsum(e), fp32
//   o  = (dtype(e) . v) * inv, fp32 accumulation, cast to q's dtype
// The TPU kernel keeps the whole padded K and V in VMEM with several heads a
// grid cell; one head's K and V at T = 1024, hd 64 (256 KB in bf16) do not
// fit an SM's 227 KB. Design here: two passes over 64-row K/V tiles
// streamed through a double-buffered cp.async ring. Pass 1 streams K and
// takes each row's exact max (a max does not depend on order); pass 2
// streams K and V, recomputes the scores, forms e against that final max,
// sums e in fp32 and accumulates bf16(e) . V. So e is rounded where the
// reference rounds it, only the fp32 sums run in another order, and any T
// fits; the price is 1.5x the function's QK^T work (6 T^2 hd a head against
// its 4 T^2 hd).
//
// Bound on the card: bytes at ViT-B's T = 197 (B = 16: 19.4 MB of q, k, v
// and out, 0.0058 ms, against 1.9 GFLOP, 0.0019 ms at the bf16 peak);
// operations at T = 1024 (B = 4, 16 heads: 17.2 GFLOP, 0.0174 ms, against
// 33.6 MB, 0.0100 ms). Design, bf16: one block of 4 warps per (image, head,
// 64-query tile), each warp owning 16 query rows with its q fragments (q
// scaled and rounded to bf16 on load), running max, row sums and [16, hd]
// fp32 output in registers; products on mma.sync m16n8k16 with the tile
// helpers of attention_tiles.cuh. fp32: plain FMA on the CUDA cores (no
// TF32, e not rounded), one thread per query row (two for head dims past
// 64, each holding half of the row), K/V tiles of 32 rows in shared memory
// read as broadcasts. q, k, v and out are strided views (image, head and
// row strides, the last axis contiguous), so one kernel serves split-head
// tensors, the permuted views of a [B, T, 3D] GEMM output and the
// slab-packed qkv of packed_fused_attention. Not yet used: wgmma, TMA,
// reuse of K/V across the query tiles of one head.
#include <math.h>

#include "attention_tiles.cuh"

namespace vit {
namespace single {

using namespace tiles;
constexpr int kTile = 64;  // K/V rows of a streamed tile (bf16 kernel)

template <int HDP>
__host__ __device__ constexpr size_t stage_bytes() {  // a K and a V tile
  return 2 * tile_elems<HDP, kTile>() * sizeof(bf16);
}

// Masks the 4 scores of an mma accumulator whose keys are key and key + 1.
__device__ __forceinline__ void mask_keys(float c[4], int key, int kv_len) {
  if (key >= kv_len) c[0] = c[2] = kMaskValue;
  if (key + 1 >= kv_len) c[1] = c[3] = kMaskValue;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
single_pass_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        HeadViews views, int T, int kv_len, int hd, float scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const bf16* kb = head_base(k, views.k, b, h);
  const bf16* vb = head_base(v, views.v, b, h);
  const int ntiles = (kv_len + kTile - 1) / kTile;
  const int kvp = (kv_len + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (s % kStages) * stage_bytes<HDP>());
  };
  // Steps [0, ntiles) are pass 1 (K tile s), [ntiles, 2 ntiles) pass 2 (K and
  // V tile s - ntiles); keys past kv_len are read as zeros and masked.
  auto fetch = [&](int s) {
    const int k0 = (s < ntiles ? s : s - ntiles) * kTile;
    load_tile<HDP, kTile>(stage(s), kb, views.k.row, 0, k0, kv_len, hd);
    if (s >= ntiles)
      load_tile<HDP, kTile>(stage(s) + tile_elems<HDP, kTile>(), vb, views.v.row, 0,
                            k0, kv_len, hd);
    cp_async_commit();
  };
  fetch(0);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // Warps whose rows lie past T compute on zero rows and store nothing: they
  // must stay for the block's barriers.
  const int r0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;
  uint32_t qa[HDP / 16][4];  // q * scale, rounded to bf16
  load_a<HDP>(qa, head_base(q, views.q, b, h), views.q.row, 0, r0, T, hd, scale, g,
              t);

  // Rows g (0) and g + 8 (1) of the warp's 16.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  for (int s = 0; s < 2 * ntiles; ++s) {
    if (s + 1 < 2 * ntiles) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = stage(s);
    const int k0 = (s < ntiles ? s : s - ntiles) * kTile;
    // 16-key chunks up to kvp; the keys of a chunk past kv_len are masked,
    // and chunks past kvp (masked keys only, e exactly 0) are skipped.
    const int nchunk = min(kTile, kvp - k0) / 16;
    if (s < ntiles) {
#pragma unroll
      for (int sub = 0; sub < kTile / 8; ++sub) {
        if (sub < 2 * nchunk) {
          float c[4];
          dot_tile<HDP, false>(c, qa, ks, sub, 1.f, g, t);
          mask_keys(c, k0 + sub * 8 + 2 * t, kv_len);
          m0 = fmaxf(m0, fmaxf(c[0], c[1]));
          m1 = fmaxf(m1, fmaxf(c[2], c[3]));
        }
      }
      if (s == ntiles - 1) {
        quad_max(m0);
        quad_max(m1);
      }
    } else {
      const bf16* vs = ks + tile_elems<HDP, kTile>();
#pragma unroll
      for (int chunk = 0; chunk < kTile / 16; ++chunk) {
        if (chunk < nchunk) {
          float c0[4], c1[4];
          dot_tile<HDP, false>(c0, qa, ks, 2 * chunk, 1.f, g, t);
          dot_tile<HDP, false>(c1, qa, ks, 2 * chunk + 1, 1.f, g, t);
          mask_keys(c0, k0 + chunk * 16 + 2 * t, kv_len);
          mask_keys(c1, k0 + chunk * 16 + 8 + 2 * t, kv_len);
          const float e00 = expf(c0[0] - m0), e01 = expf(c0[1] - m0);
          const float e02 = expf(c0[2] - m1), e03 = expf(c0[3] - m1);
          const float e10 = expf(c1[0] - m0), e11 = expf(c1[1] - m0);
          const float e12 = expf(c1[2] - m1), e13 = expf(c1[3] - m1);
          l0 += e00 + e01 + e10 + e11;
          l1 += e02 + e03 + e12 + e13;
          // The rounded e in the accumulator layout is the A operand of the
          // PV product; the row sums take e in fp32.
          const uint32_t pa[4] = {pack_bf16x2(e00, e01), pack_bf16x2(e02, e03),
                                  pack_bf16x2(e10, e11), pack_bf16x2(e12, e13)};
          accumulate<HDP>(o, pa, vs, chunk, lane);
        }
      }
    }
    __syncthreads();  // the stage is refilled two steps on
  }
  quad_sum(l0);
  quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    o[d][0] *= inv0;
    o[d][1] *= inv0;
    o[d][2] *= inv1;
    o[d][3] *= inv1;
  }
  store_rows<HDP, bf16>(head_base(out, views.o, b, h), views.o.row, 0, o, r0, T, hd,
                        g, t);
}

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
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out,
                        HeadViews views, int B, int H, int T, int kv_len, int hd,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = kStages * stage_bytes<HDP>();
  cudaError_t err = allow_dynamic_smem(single_pass_bf16_kernel<HDP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kRows - 1) / kRows, H, B);
  single_pass_bf16_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), views, T, kv_len, hd,
      scale);
  return cudaGetLastError();
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

template <int HDP>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* out,
                   HeadViews views, int B, int H, int T, int kv_len, int hd,
                   float scale, cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_bf16<HDP>(q, k, v, out, views, B, H, T, kv_len, hd, scale, stream);
  if (dtype == kF32)
    return launch_f32<HDP>(q, k, v, out, views, B, H, T, kv_len, hd, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace single
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
  const vit::tiles::HeadViews views = vit::tiles::head_views(strides);
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return launch<16>(dtype, q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 32: return launch<32>(dtype, q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 48: return launch<48>(dtype, q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 64: return launch<64>(dtype, q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 80: return launch<80>(dtype, q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 96: return launch<96>(dtype, q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 112: return launch<112>(dtype, q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    case 128: return launch<128>(dtype, q, k, v, out, views, B, num_heads, T, kv_len, head_dim, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

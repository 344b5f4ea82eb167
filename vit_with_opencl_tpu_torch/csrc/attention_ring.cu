// One ring-attention rotation's local step: blockwise attention whose
// online-softmax statistics come in from the previous rotation and go out
// un-normalised. q, k, v [n, t_loc, hd] (bf16 or fp32, one dtype), a key
// bias [t_loc] fp32 shared by all n rows, carried m, l [n, t_loc] and acc
// [n, t_loc, hd] fp32 in; the updated m, l and acc out.
//
// Replaces vit_with_opencl_tpu/ops/attention.py:_flash_carry_kernel
// (blockwise_ring_step). Per row, over the key blocks of block_k keys in
// order, the TPU kernel's arithmetic:
//   s   = fp32(q . k^T) * scale + bias[key]   (two roundings: no FMA, and
//                                             the scale multiplies the fp32
//                                             scores, q is not pre-scaled)
//   m'  = max(m, rowmax(s));  a = exp(m - m')  (0 where m = -inf)
//   p   = exp(s - m');        l' = a * l + rowsum(p), p in fp32
//   acc = a * acc + dtype(p) . v, fp32 sums (at fp32 p is not rounded)
// block_k is part of the function: p is rounded against the running max,
// which moves once a key block. A row whose block is all masked gets a
// finite m' near MASK_VALUE and counts its masked keys as ones in rowsum(p);
// a later live block wipes that out with a = 0, as on the TPU.
//
// Bound on the card: bytes. The carried statistics and accumulator are fp32
// and go both ways, so at ViT-L/16@512 on 4 shards (t_loc = 257, hd 64, n =
// 64) the step moves ~15 MB (0.0045 ms at 3.35 TB/s) against 1.1 GFLOP
// (0.0011 ms at the bf16 peak). Design, as attention_single.cu's: one block
// of 4 warps per (row group n, 64-query tile); within each key block two
// passes over 64-row K/V tiles streamed through a double-buffered cp.async
// ring (the ring's real shapes give ragged whole-shard blocks, 129-343
// keys): pass 1 takes the block's exact row max of s, pass 2 forms p
// against m', sums it in fp32 and accumulates bf16(p) . V into the carried
// accumulator, rescaled by a between the passes. An online softmax over the
// 64-key tiles would move the rounding points of p. bf16 on mma.sync
// m16n8k16 with the tile helpers of attention_tiles.cuh, each warp holding
// 16 query rows, their (m, l) and [16, hd] fp32 accumulator in registers;
// fp32 on CUDA-core FMA (no TF32), one thread per query row (two past hd 64),
// K/V/bias tiles of 32 rows in shared memory. Not yet used: wgmma, TMA,
// K/V reuse across the query tiles of a row group.
#include <math.h>

#include "attention_tiles.cuh"

namespace vit {
namespace ring {

using namespace tiles;
constexpr int kTile = 64;  // K/V rows of a streamed tile (bf16 kernel)

template <int HDP>
__host__ __device__ constexpr size_t stage_bytes() {  // a K and a V tile
  return 2 * tile_elems<HDP, kTile>() * sizeof(bf16);
}

// The scores of an mma accumulator (keys key and key + 1): times the fp32
// scale plus the key's bias, rounded after each; keys at or past the end of
// the key block are no keys of it (-inf: no max, p exactly 0).
__device__ __forceinline__ void bias_scores(float c[4], int key, int kend,
                                            const float* __restrict__ bias,
                                            float scale) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int kk = key + e;
    const float b = kk < kend ? bias[kk] : 0.f;
    c[e] = kk < kend ? __fadd_rn(__fmul_rn(c[e], scale), b) : -INFINITY;
    c[e + 2] = kk < kend ? __fadd_rn(__fmul_rn(c[e + 2], scale), b) : -INFINITY;
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
ring_step_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ m_in, const float* __restrict__ l_in,
                      const float* __restrict__ acc_in, float* __restrict__ m_out,
                      float* __restrict__ l_out, float* __restrict__ acc_out,
                      int t_loc, int hd, int block_k, float scale) {
  const size_t row_base = static_cast<size_t>(blockIdx.y) * t_loc;
  const size_t base = row_base * hd;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int nt = (block_k + kTile - 1) / kTile;  // streamed tiles of a key block
  const int nsteps = (t_loc / block_k) * 2 * nt;
  extern __shared__ __align__(16) unsigned char smem[];
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (s % kStages) * stage_bytes<HDP>());
  };
  // Step s: key block s / (2 nt); its steps [0, nt) are pass 1 (K tile),
  // [nt, 2 nt) pass 2 (K and V tile). Rows past the block are read as zeros.
  auto first_key = [&](int s) {
    const int r = s % (2 * nt);
    return (s / (2 * nt)) * block_k + (r < nt ? r : r - nt) * kTile;
  };
  auto fetch = [&](int s) {
    const int k0 = first_key(s), kend = (s / (2 * nt) + 1) * block_k;
    load_tile<HDP, kTile>(stage(s), kb, hd, 0, k0, kend, hd);
    if (s % (2 * nt) >= nt)
      load_tile<HDP, kTile>(stage(s) + tile_elems<HDP, kTile>(), vb, hd, 0, k0, kend,
                            hd);
    cp_async_commit();
  };
  fetch(0);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // Warps whose rows lie past t_loc compute on zero rows and store nothing:
  // they must stay for the block's barriers.
  const int r0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;
  const int row0 = r0 + g, row1 = r0 + g + 8;
  uint32_t qa[HDP / 16][4];  // q as it is: the scale multiplies the scores
  load_a<HDP>(qa, q + base, hd, 0, r0, t_loc, hd, 1.f, g, t);

  // Rows g (0) and g + 8 (1) of the warp's 16: the carried statistics and
  // accumulator (accumulator layout: o[d] holds columns 8d + 2t, + 1).
  float m0 = row0 < t_loc ? m_in[row_base + row0] : -INFINITY;
  float m1 = row1 < t_loc ? m_in[row_base + row1] : -INFINITY;
  float l0 = row0 < t_loc ? l_in[row_base + row0] : 0.f;
  float l1 = row1 < t_loc ? l_in[row_base + row1] : 0.f;
  float o[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    const int col = d * 8 + 2 * t;
    float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
    if (col < hd && row0 < t_loc)
      a = *reinterpret_cast<const float2*>(acc_in + (row_base + row0) * hd + col);
    if (col < hd && row1 < t_loc)
      b = *reinterpret_cast<const float2*>(acc_in + (row_base + row1) * hd + col);
    o[d][0] = a.x;
    o[d][1] = a.y;
    o[d][2] = b.x;
    o[d][3] = b.y;
  }

  float mb0 = -INFINITY, mb1 = -INFINITY;  // the key block's row max (pass 1)
  float lb0 = 0.f, lb1 = 0.f;              // and its row sums of p (pass 2)
  float a0 = 1.f, a1 = 1.f;
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = stage(s);
    const int r = s % (2 * nt);
    const int k0 = first_key(s), kend = (s / (2 * nt) + 1) * block_k;
    const int nkeys = min(kTile, kend - k0);  // keys of the block in this tile
    if (r < nt) {
#pragma unroll
      for (int sub = 0; sub < kTile / 8; ++sub) {
        if (sub * 8 < nkeys) {
          float c[4];
          dot_tile<HDP, false>(c, qa, ks, sub, 1.f, g, t);
          bias_scores(c, k0 + sub * 8 + 2 * t, kend, bias, scale);
          mb0 = fmaxf(mb0, fmaxf(c[0], c[1]));
          mb1 = fmaxf(mb1, fmaxf(c[2], c[3]));
        }
      }
      if (r == nt - 1) {  // the block's max is known: move the running max
        quad_max(mb0);
        quad_max(mb1);
        const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
        a0 = expf(m0 - mn0);  // 0 from the first rotation's m = -inf
        a1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int d = 0; d < HDP / 8; ++d) {
          o[d][0] *= a0;
          o[d][1] *= a0;
          o[d][2] *= a1;
          o[d][3] *= a1;
        }
      }
    } else {
      const bf16* vs = ks + tile_elems<HDP, kTile>();
#pragma unroll
      for (int chunk = 0; chunk < kTile / 16; ++chunk) {
        if (chunk * 16 < nkeys) {
          float c0[4], c1[4];
          dot_tile<HDP, false>(c0, qa, ks, 2 * chunk, 1.f, g, t);
          dot_tile<HDP, false>(c1, qa, ks, 2 * chunk + 1, 1.f, g, t);
          bias_scores(c0, k0 + chunk * 16 + 2 * t, kend, bias, scale);
          bias_scores(c1, k0 + chunk * 16 + 8 + 2 * t, kend, bias, scale);
          const float p00 = expf(c0[0] - m0), p01 = expf(c0[1] - m0);
          const float p02 = expf(c0[2] - m1), p03 = expf(c0[3] - m1);
          const float p10 = expf(c1[0] - m0), p11 = expf(c1[1] - m0);
          const float p12 = expf(c1[2] - m1), p13 = expf(c1[3] - m1);
          lb0 += p00 + p01 + p10 + p11;
          lb1 += p02 + p03 + p12 + p13;
          // The rounded p in the accumulator layout is the A operand of the
          // PV product; the row sums take p in fp32.
          const uint32_t pa[4] = {pack_bf16x2(p00, p01), pack_bf16x2(p02, p03),
                                  pack_bf16x2(p10, p11), pack_bf16x2(p12, p13)};
          accumulate<HDP>(o, pa, vs, chunk, lane);
        }
      }
      if (r == 2 * nt - 1) {  // the block is done: l' = a * l + rowsum(p)
        quad_sum(lb0);
        quad_sum(lb1);
        l0 = __fadd_rn(__fmul_rn(a0, l0), lb0);
        l1 = __fadd_rn(__fmul_rn(a1, l1), lb1);
        mb0 = mb1 = -INFINITY;
        lb0 = lb1 = 0.f;
      }
    }
    __syncthreads();  // the stage is refilled two steps on
  }
  if (t == 0) {  // one lane per row
    if (row0 < t_loc) {
      m_out[row_base + row0] = m0;
      l_out[row_base + row0] = l0;
    }
    if (row1 < t_loc) {
      m_out[row_base + row1] = m1;
      l_out[row_base + row1] = l1;
    }
  }
  store_rows<HDP, float>(acc_out + base, hd, 0, o, r0, t_loc, hd, g, t);
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
__host__ __device__ constexpr size_t f32_smem_bytes() {  // K, V and bias tiles
  return (2 * kF32Tile * HDP + kF32Tile) * sizeof(float);
}

template <int HDP>
__global__ void __launch_bounds__(kF32Rows * (HDP > 64 ? 2 : 1))
ring_step_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ m_in, const float* __restrict__ l_in,
                     const float* __restrict__ acc_in, float* __restrict__ m_out,
                     float* __restrict__ l_out, float* __restrict__ acc_out,
                     int t_loc, int hd, int block_k, float scale) {
  constexpr int kSplit = f32_split<HDP>();
  constexpr int kDims = HDP / kSplit;  // a thread's share of the head dim
  const size_t row_base = static_cast<size_t>(blockIdx.y) * t_loc;
  const float* kb = k + row_base * hd;
  const float* vb = v + row_base * hd;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [kF32Tile][HDP]
  float* vs = ks + kF32Tile * HDP;             // [kF32Tile][HDP]
  float* bs = vs + kF32Tile * HDP;             // [kF32Tile]
  const int part = threadIdx.x % kSplit, d0 = part * kDims;
  const int row = blockIdx.x * kF32Rows + threadIdx.x / kSplit;
  const bool live = row < t_loc;

  float qr[kDims], o[kDims];
  const float* qrow = q + (row_base + (live ? row : 0)) * hd;
  const float* arow = acc_in + (row_base + (live ? row : 0)) * hd;
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    qr[d] = live && d0 + d < hd ? qrow[d0 + d] : 0.f;
    o[d] = live && d0 + d < hd ? arow[d0 + d] : 0.f;
  }
  float m = live ? m_in[row_base + row] : -INFINITY;
  float l = live ? l_in[row_base + row] : 0.f;

  // Rows [j0, j0 + kF32Tile) of K (and V) and their bias into shared memory,
  // zeros past the key block's end `kend` and past hd; 16-byte loads (hd is
  // a multiple of 4).
  auto load = [&](float* dst, const float* src, int j0, int kend) {
    constexpr int kChunks = HDP / 4;
    for (int i = threadIdx.x; i < kF32Tile * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j0 + r < kend && c < hd)
        val = *reinterpret_cast<const float4*>(src + static_cast<size_t>(j0 + r) * hd + c);
      *reinterpret_cast<float4*>(dst + r * HDP + c) = val;
    }
  };
  auto load_bias = [&](int j0, int kend) {
    for (int i = threadIdx.x; i < kF32Tile; i += blockDim.x)
      bs[i] = j0 + i < kend ? bias[j0 + i] : 0.f;
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
    return __fadd_rn(__fmul_rn(s, scale), bs[j]);
  };

  for (int k0 = 0; k0 < t_loc; k0 += block_k) {
    const int kend = k0 + block_k;
    // Pass 1: the key block's row max.
    float mb = -INFINITY;
    for (int j0 = k0; j0 < kend; j0 += kF32Tile) {
      __syncthreads();
      load(ks, kb, j0, kend);
      load_bias(j0, kend);
      __syncthreads();
      const int nrow = min(kF32Tile, kend - j0);
      for (int j = 0; j < nrow; ++j) mb = fmaxf(mb, score(j));
    }
    const float mn = fmaxf(m, mb);
    const float a = expf(m - mn);  // 0 from the first rotation's m = -inf
    m = mn;
#pragma unroll
    for (int d = 0; d < kDims; ++d) o[d] *= a;
    // Pass 2: p against the moved max, its fp32 row sum and p . V.
    float lb = 0.f;
    for (int j0 = k0; j0 < kend; j0 += kF32Tile) {
      __syncthreads();
      load(ks, kb, j0, kend);
      load(vs, vb, j0, kend);
      load_bias(j0, kend);
      __syncthreads();
      const int nrow = min(kF32Tile, kend - j0);
      for (int j = 0; j < nrow; ++j) {
        const float p = expf(score(j) - m);
        lb += p;
        const float* vr = vs + j * HDP + d0;
#pragma unroll
        for (int d = 0; d < kDims; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + d);
          o[d] = fmaf(p, vv.x, o[d]);
          o[d + 1] = fmaf(p, vv.y, o[d + 1]);
          o[d + 2] = fmaf(p, vv.z, o[d + 2]);
          o[d + 3] = fmaf(p, vv.w, o[d + 3]);
        }
      }
    }
    l = __fadd_rn(__fmul_rn(a, l), lb);
  }
  if (!live) return;  // no barrier follows
  if (part == 0) {
    m_out[row_base + row] = m;
    l_out[row_base + row] = l;
  }
  float* orow = acc_out + (row_base + row) * hd;
#pragma unroll
  for (int d = 0; d < kDims; ++d)
    if (d0 + d < hd) orow[d0 + d] = o[d];
}

template <int HDP>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const float* bias, const float* m_in, const float* l_in,
                   const float* acc_in, float* m_out, float* l_out, float* acc_out,
                   int n, int t_loc, int hd, int block_k, float scale,
                   cudaStream_t stream) {
  if (dtype == kBF16) {
    constexpr size_t smem = kStages * stage_bytes<HDP>();
    cudaError_t err = allow_dynamic_smem(ring_step_bf16_kernel<HDP>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((t_loc + kRows - 1) / kRows, n);
    ring_step_bf16_kernel<HDP><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), bias, m_in, l_in, acc_in, m_out, l_out, acc_out,
        t_loc, hd, block_k, scale);
    return cudaGetLastError();
  }
  if (dtype == kF32) {
    constexpr size_t smem = f32_smem_bytes<HDP>();
    cudaError_t err = allow_dynamic_smem(ring_step_f32_kernel<HDP>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((t_loc + kF32Rows - 1) / kF32Rows, n);
    ring_step_f32_kernel<HDP><<<grid, kF32Rows * f32_split<HDP>(), smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, m_in, l_in, acc_in, m_out, l_out, acc_out,
        t_loc, hd, block_k, scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace ring
}  // namespace vit

// q, k, v [n, t_loc, head_dim] of `dtype` (0 fp32, 1 bf16), contiguous;
// bias [t_loc], m_in, l_in [n, t_loc], acc_in [n, t_loc, head_dim] fp32 ->
// m_out, l_out, acc_out of the same shapes (other buffers than the inputs).
// block_k must divide t_loc; `scale` is the fp32 multiplier of the scores.
// head_dim must be a multiple of 8 up to 128 (ops/attention.py checks all
// of it first).
VIT_EXPORT int vit_ring_step(const void* q, const void* k, const void* v,
                             const float* bias, const float* m_in, const float* l_in,
                             const float* acc_in, float* m_out, float* l_out,
                             float* acc_out, int dtype, int n, int t_loc,
                             int head_dim, int block_k, float scale, void* stream) {
  using namespace vit::ring;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || t_loc <= 0 || block_k <= 0 || t_loc % block_k != 0 ||
      head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return launch<16>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 32: return launch<32>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 48: return launch<48>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 64: return launch<64>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 80: return launch<80>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 96: return launch<96>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 112: return launch<112>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 128: return launch<128>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// Blockwise (long-sequence) multi-head attention over a packed QKV buffer:
// the forward, with each row's log-sum-exp as an option, and its backward.
//
// Replaces vit_with_opencl_tpu/ops/attention.py:_flash_kernel and
// _flash_kernel_lse (_blockwise_fwd_flat, one kernel here with the LSE as an
// option) and _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel
// (blockwise_attention_bwd), the route the JAX package takes for padded
// T > SINGLE_PASS_MAX_T = 1024. "slab" packing as attention.cu: head h's q,
// k and v are the hd columns at h*hd, D + h*hd and 2D + h*hd of [B, T, 3D];
// the kernels read them there (rows past T as zeros) and write the
// head-major context [B, T, D] or the dqkv slabs, so no split or padded copy
// is made. The forward also has a strided entry for split heads ([B, H, T,
// hd] views, flash_attention past T = 1024); the slab entry passes the slabs
// to it as views, reading and writing the same addresses. Per head, the
// numerics of the TPU kernels:
//   forward   s = (q . k^T) * scale, fp32 (scale is fp32, not folded into q);
//             keys past T masked to MASK_VALUE; over key tiles of 128 in
//             order: m' = max(m, rowmax(s)), a = exp(m - m'),
//             p = exp(s - m'), l = a * l + rowsum(p),
//             acc = acc * a + bf16(p) . v; then o = bf16(acc * (1 / l)) and
//             lse = m + log(l) (l == 0 -> 1 in both);
//   backward  dvec = rowsum(dO * O) from the forward's rounded output;
//             p = exp(s - lse), dp = dO . v^T,
//             ds = bf16((p * (dp - dvec)) * scale),
//             dq = ds . k,  dk = ds^T . q (unscaled q),  dv = bf16(p)^T . dO.
// The key tile of the forward is 128, JAX's block_k: the running max moves
// once a tile, so p is rounded to bf16 at the same values as on the TPU.
//
// Bound on the card: operations. At ViT-L/16@512 (T = 1025, padded to 1152
// by JAX; hd 64) the forward does 4 T^2 hd a head (69 GFLOP a layer at
// B = 16, 0.07 ms at the bf16 peak) against 50 MB of bytes (0.015 ms); the
// backward's two kernels do 4 + 6 T^2 hd (the dq kernel s, dp, dq; the
// dK/dV kernel s, dp, dv, dk). Design: FlashAttention-2's split, so that no
// block sums into another's output and results repeat from run to run.
//   forward     one block of 4 warps per (image, head, 64-query tile); each
//               warp owns 16 query rows (q fragment in registers) and the
//               scores of one 128-key tile (64 fp32 registers), its running
//               (m, l) and fp32 output accumulator; K and V tiles of 128 rows
//               stream through a double-buffered cp.async ring;
//   dq          one block per (image, head, 64-query tile): q and dO
//               fragments, each row's lse and dvec (computed here from dO and
//               O, and written for the dK/dV kernel) stay in registers; K and
//               V tiles of 64 rows stream; dq accumulates in registers;
//   dK/dV       one block per (image, head, 64-key tile): k and v fragments
//               in registers; q, dO and the rows' lse and dvec stream in
//               tiles of 64; dv and dk accumulate in registers.
// Products use mma.sync m16n8k16 (bf16 in, fp32 out) as attention_bwd.cu,
// whose tile helpers (attention_tiles.cuh) these kernels share. Head dims
// that are a multiple of 8 are zero-padded to the next of the compiled
// widths (16..128). Not yet used: wgmma, TMA.
#include <math.h>

#include "attention_tiles.cuh"

namespace vit {
namespace flash {

using namespace tiles;
constexpr int kKeyTile = 128;  // the forward's K/V tile: the running max's step
constexpr int kTile = 64;      // the backward's streamed tiles

template <int HDP>
__host__ __device__ constexpr size_t fwd_stage_bytes() {  // a K and a V tile
  return 2 * tile_elems<HDP, kKeyTile>() * sizeof(bf16);
}
template <int HDP>
__host__ __device__ constexpr size_t dq_stage_bytes() {  // a K and a V tile
  return 2 * tile_elems<HDP, kTile>() * sizeof(bf16);
}
template <int HDP>
__host__ __device__ constexpr size_t dkv_stage_bytes() {  // q, dO, lse, dvec
  return 2 * tile_elems<HDP, kTile>() * sizeof(bf16) + 2 * kTile * sizeof(float);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, HeadViews views,
                 float* __restrict__ lse, int T, int kv_len, int num_heads, int hd,
                 float scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int kvp = (kv_len + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* qb = head_base(q, views.q, b, h);
  const bf16* kb = head_base(k, views.k, b, h);
  const bf16* vb = head_base(v, views.v, b, h);
  // Key tiles wholly past kv_len hold masked keys only: a = 1, p = 0, so
  // they move nothing and are skipped.
  const int ntiles = (kv_len + kKeyTile - 1) / kKeyTile;
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (s % kStages) * fwd_stage_bytes<HDP>());
  };
  auto fetch = [&](int s) {
    const int k0 = s * kKeyTile;
    load_tile<HDP, kKeyTile>(stage(s), kb, views.k.row, 0, k0, kv_len, hd);
    load_tile<HDP, kKeyTile>(stage(s) + tile_elems<HDP, kKeyTile>(), vb,
                             views.v.row, 0, k0, kv_len, hd);
    cp_async_commit();
  };
  fetch(0);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // Warps whose rows lie past T compute on zero rows and store nothing: they
  // must stay for the block's barriers.
  const int r0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;
  uint32_t qa[HDP / 16][4];
  load_a<HDP>(qa, qb, views.q.row, 0, r0, T, hd, 1.f, g, t);

  // Rows g (0) and g + 8 (1) of the warp's 16.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  for (int s = 0; s < ntiles; ++s) {
    if (s + 1 < ntiles) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = stage(s);
    const bf16* vs = ks + tile_elems<HDP, kKeyTile>();
    const int k0 = s * kKeyTile;
    // 8-key sub-tiles up to kvp; the ones past it hold masked keys only,
    // whose p is exactly 0, and a tile always holds a key below kv_len.
    const int nsub = min(kKeyTile, kvp - k0) / 8;

    float sc[kKeyTile / 8][4];  // the tile's scores, then its p
    float mc0 = -INFINITY, mc1 = -INFINITY;
#pragma unroll
    for (int sub = 0; sub < kKeyTile / 8; ++sub) {
      if (sub < nsub) {
        float* c = sc[sub];
        dot_tile<HDP, false>(c, qa, ks, sub, 1.f, g, t);
        const int key = k0 + sub * 8 + 2 * t;
        c[0] = key < kv_len ? c[0] * scale : kMaskValue;
        c[1] = key + 1 < kv_len ? c[1] * scale : kMaskValue;
        c[2] = key < kv_len ? c[2] * scale : kMaskValue;
        c[3] = key + 1 < kv_len ? c[3] * scale : kMaskValue;
        mc0 = fmaxf(mc0, fmaxf(c[0], c[1]));
        mc1 = fmaxf(mc1, fmaxf(c[2], c[3]));
      }
    }
    quad_max(mc0);
    quad_max(mc1);
    const float mn0 = fmaxf(m0, mc0), mn1 = fmaxf(m1, mc1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);  // 0 on the first tile
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int sub = 0; sub < kKeyTile / 8; ++sub) {
      if (sub < nsub) {
        float* c = sc[sub];
        c[0] = expf(c[0] - mn0);
        c[1] = expf(c[1] - mn0);
        c[2] = expf(c[2] - mn1);
        c[3] = expf(c[3] - mn1);
        ls0 += c[0] + c[1];
        ls1 += c[2] + c[3];
      }
    }
    quad_sum(ls0);
    quad_sum(ls1);
    l0 = a0 * l0 + ls0;
    l1 = a1 * l1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }
    // acc += bf16(p) . V, 16 keys at a time: two sub-tiles of p in the
    // accumulator layout are the A operand of the next product.
#pragma unroll
    for (int chunk = 0; chunk < kKeyTile / 16; ++chunk) {
      if (chunk < nsub / 2) {
        const float* p0 = sc[2 * chunk];
        const float* p1 = sc[2 * chunk + 1];
        const uint32_t pa[4] = {pack_bf16x2(p0[0], p0[1]), pack_bf16x2(p0[2], p0[3]),
                                pack_bf16x2(p1[0], p1[1]), pack_bf16x2(p1[2], p1[3])};
        accumulate<HDP>(o, pa, vs, chunk, lane);
      }
    }
    __syncthreads();  // the stage is refilled two steps on
  }

  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    o[d][0] *= inv0;
    o[d][1] *= inv0;
    o[d][2] *= inv1;
    o[d][3] *= inv1;
  }
  store_rows<HDP, bf16>(head_base(out, views.o, b, h), views.o.row, 0, o, r0, T, hd,
                        g, t);
  if (lse != nullptr && t == 0) {  // one lane per row
    float* row_lse = lse + (static_cast<size_t>(b) * num_heads + h) * T;
    if (r0 + g < T) row_lse[r0 + g] = m0 + logf(l0 == 0.f ? 1.f : l0);
    if (r0 + g + 8 < T) row_lse[r0 + g + 8] = m1 + logf(l1 == 0.f ? 1.f : l1);
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                    const float* __restrict__ lse, const bf16* __restrict__ dout,
                    bf16* __restrict__ dqkv, float* __restrict__ dvec, int T,
                    int num_heads, int hd, float scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int D = num_heads * hd, pitch = 3 * D;
  const int Tp = (T + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* img = qkv + static_cast<size_t>(b) * T * pitch;
  const bf16* oimg = out + static_cast<size_t>(b) * T * D;
  const bf16* dimg = dout + static_cast<size_t>(b) * T * D;
  const size_t row_stat = (static_cast<size_t>(b) * num_heads + h) * T;
  const int ntiles = (T + kTile - 1) / kTile;  // key tiles
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (s % kStages) * dq_stage_bytes<HDP>());
  };
  auto fetch = [&](int s) {
    const int k0 = s * kTile;
    load_tile<HDP, kTile>(stage(s), img, pitch, D + h * hd, k0, T, hd);
    load_tile<HDP, kTile>(stage(s) + tile_elems<HDP, kTile>(), img, pitch,
                          2 * D + h * hd, k0, T, hd);
    cp_async_commit();
  };
  fetch(0);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;
  const int row0 = r0 + g, row1 = r0 + g + 8;
  uint32_t qa[HDP / 16][4], da[HDP / 16][4];
  load_a<HDP>(qa, img, pitch, h * hd, r0, T, hd, 1.f, g, t);
  load_a<HDP>(da, dimg, D, h * hd, r0, T, hd, 1.f, g, t);

  // dvec = rowsum(dO * O): each lane takes the columns its dO fragment
  // holds (zero past T and hd), then the row's 4 lanes combine.
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int row = reg & 1 ? row1 : row0;
      const int col = s * 16 + 2 * t + (reg >> 1) * 8;
      if (row < T && col < hd) {
        const __nv_bfloat162 dv = *reinterpret_cast<const __nv_bfloat162*>(&da[s][reg]);
        const __nv_bfloat162 ov = *reinterpret_cast<const __nv_bfloat162*>(
            oimg + static_cast<size_t>(row) * D + h * hd + col);
        const float part = __bfloat162float(dv.x) * __bfloat162float(ov.x) +
                           __bfloat162float(dv.y) * __bfloat162float(ov.y);
        if (reg & 1)
          dl1 += part;
        else
          dl0 += part;
      }
    }
  }
  quad_sum(dl0);
  quad_sum(dl1);
  const float lse0 = row0 < T ? lse[row_stat + row0] : 0.f;
  const float lse1 = row1 < T ? lse[row_stat + row1] : 0.f;
  if (t == 0) {  // for the dK/dV kernel
    if (row0 < T) dvec[row_stat + row0] = dl0;
    if (row1 < T) dvec[row_stat + row1] = dl1;
  }

  float dq[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int s = 0; s < ntiles; ++s) {
    if (s + 1 < ntiles) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = stage(s);
    const bf16* vs = ks + tile_elems<HDP, kTile>();
    const int k0 = s * kTile;
    const int nsub = min(kTile, Tp - k0) / 8;  // 8-key sub-tiles up to Tp

    // ds of keys k0 + [8 * sub, 8 * sub + 8), keys past T masked (p = 0).
    auto grads = [&](float ds[4], int sub) {
      float c[4], dp[4];
      dot_tile<HDP, false>(c, qa, ks, sub, 1.f, g, t);
      dot_tile<HDP, false>(dp, da, vs, sub, 1.f, g, t);  // V rows past T are zero
      const int key = k0 + sub * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = key + (e & 1) < T ? c[e] * scale : kMaskValue;
        const float p = expf(sv - (e < 2 ? lse0 : lse1));
        ds[e] = (p * (dp[e] - (e < 2 ? dl0 : dl1))) * scale;
      }
    };
    for (int chunk = 0; chunk < nsub / 2; ++chunk) {
      float ds0[4], ds1[4];
      grads(ds0, 2 * chunk);
      grads(ds1, 2 * chunk + 1);
      const uint32_t dsa[4] = {pack_bf16x2(ds0[0], ds0[1]), pack_bf16x2(ds0[2], ds0[3]),
                               pack_bf16x2(ds1[0], ds1[1]), pack_bf16x2(ds1[2], ds1[3])};
      accumulate<HDP>(dq, dsa, ks, chunk, lane);  // dq += ds . K
    }
    __syncthreads();  // the stage is refilled two steps on
  }
  store_rows<HDP, bf16>(dqkv + static_cast<size_t>(b) * T * pitch, pitch, h * hd, dq,
                        r0, T, hd, g, t);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ lse,
                     const float* __restrict__ dvec, const bf16* __restrict__ dout,
                     bf16* __restrict__ dqkv, int T, int num_heads, int hd,
                     float scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int D = num_heads * hd, pitch = 3 * D;
  const int Tp = (T + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* img = qkv + static_cast<size_t>(b) * T * pitch;
  const bf16* dimg = dout + static_cast<size_t>(b) * T * D;
  const size_t row_stat = (static_cast<size_t>(b) * num_heads + h) * T;
  const int ntiles = (T + kTile - 1) / kTile;  // query tiles
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (s % kStages) * dkv_stage_bytes<HDP>());
  };
  auto fetch = [&](int s) {  // q (unscaled), dO and the rows' lse and dvec
    const int q0 = s * kTile;
    bf16* buf = stage(s);
    load_tile<HDP, kTile>(buf, img, pitch, h * hd, q0, T, hd);
    load_tile<HDP, kTile>(buf + tile_elems<HDP, kTile>(), dimg, D, h * hd, q0, T, hd);
    float* st = reinterpret_cast<float*>(buf + 2 * tile_elems<HDP, kTile>());
    for (int i = threadIdx.x; i < 2 * kTile; i += kThreads) {
      const int row = q0 + i % kTile;
      const float* src = (i < kTile ? lse : dvec) + row_stat;
      const bool ok = row < T;
      cp_async4(st + i, ok ? src + row : src, ok);
    }
    cp_async_commit();
  };
  fetch(0);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // This warp's 16 keys. Keys past T compute on zero rows and are not
  // stored, so they need no mask.
  const int r0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;
  uint32_t ka[HDP / 16][4], va[HDP / 16][4];
  load_a<HDP>(ka, img, pitch, D + h * hd, r0, T, hd, 1.f, g, t);
  load_a<HDP>(va, img, pitch, 2 * D + h * hd, r0, T, hd, 1.f, g, t);

  float dk[HDP / 8][4], dv[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }
  for (int s = 0; s < ntiles; ++s) {
    if (s + 1 < ntiles) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = stage(s);
    const bf16* dt = qt + tile_elems<HDP, kTile>();
    const float* st_lse = reinterpret_cast<const float*>(qt + 2 * tile_elems<HDP, kTile>());
    const float* st_dvec = st_lse + kTile;
    const int q0 = s * kTile;
    const int nsub = min(kTile, Tp - q0) / 8;
    // p^T and ds^T of this warp's 16 keys against queries q0 + [8 * sub, +8):
    // element e is key row g (e < 2) or g + 8, query 8 * sub + 2t + (e & 1).
    // Queries past T give zero (their q and dO rows are zero too).
    auto grads = [&](float p[4], float ds[4], int sub) {
      float dp[4];
      dot_tile<HDP, false>(p, ka, qt, sub, 1.f, g, t);  // s^T = k . q^T
      dot_tile<HDP, false>(dp, va, dt, sub, 1.f, g, t);  // dp^T = v . dO^T
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = sub * 8 + 2 * t + (e & 1);
        if (q0 + q < T) {
          p[e] = expf(p[e] * scale - st_lse[q]);
          ds[e] = (p[e] * (dp[e] - st_dvec[q])) * scale;
        } else {
          p[e] = ds[e] = 0.f;
        }
      }
    };
    for (int chunk = 0; chunk < nsub / 2; ++chunk) {
      float p0[4], ds0[4], p1[4], ds1[4];
      grads(p0, ds0, 2 * chunk);
      grads(p1, ds1, 2 * chunk + 1);
      const uint32_t pa[4] = {pack_bf16x2(p0[0], p0[1]), pack_bf16x2(p0[2], p0[3]),
                              pack_bf16x2(p1[0], p1[1]), pack_bf16x2(p1[2], p1[3])};
      const uint32_t dsa[4] = {pack_bf16x2(ds0[0], ds0[1]), pack_bf16x2(ds0[2], ds0[3]),
                               pack_bf16x2(ds1[0], ds1[1]), pack_bf16x2(ds1[2], ds1[3])};
      accumulate<HDP>(dv, pa, dt, chunk, lane);   // dv += bf16(p)^T . dO
      accumulate<HDP>(dk, dsa, qt, chunk, lane);  // dk += ds^T . q
    }
    __syncthreads();  // the stage is refilled two steps on
  }
  bf16* o = dqkv + static_cast<size_t>(b) * T * pitch;
  store_rows<HDP, bf16>(o, pitch, D + h * hd, dk, r0, T, hd, g, t);
  store_rows<HDP, bf16>(o, pitch, 2 * D + h * hd, dv, r0, T, hd, g, t);
}

template <int HDP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       HeadViews views, float* lse, int B, int T, int kv_len,
                       int num_heads, int hd, float scale, cudaStream_t stream) {
  constexpr size_t smem = kStages * fwd_stage_bytes<HDP>();
  cudaError_t err = allow_dynamic_smem(flash_fwd_kernel<HDP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kRows - 1) / kRows, num_heads, B);
  flash_fwd_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), views, lse, T, kv_len,
      num_heads, hd, scale);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_bwd(const void* qkv, const void* out, const float* lse,
                       const void* dout, void* dqkv, float* dvec, int B, int T,
                       int num_heads, int hd, float scale, cudaStream_t stream) {
  constexpr size_t s_dq = kStages * dq_stage_bytes<HDP>();
  constexpr size_t s_dkv = kStages * dkv_stage_bytes<HDP>();
  cudaError_t err = allow_dynamic_smem(flash_bwd_dq_kernel<HDP>, s_dq);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(flash_bwd_dkv_kernel<HDP>, s_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kRows - 1) / kRows, num_heads, B);
  flash_bwd_dq_kernel<HDP><<<grid, kThreads, s_dq, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(out), lse,
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), dvec, T, num_heads,
      hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<HDP><<<grid, kThreads, s_dkv, stream>>>(
      static_cast<const bf16*>(qkv), lse, dvec, static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), T, num_heads, hd, scale);
  return cudaGetLastError();
}

}  // namespace flash
}  // namespace vit

#define VIT_FLASH_DISPATCH(launch, ...)                                    \
  switch ((head_dim + 15) / 16 * 16) {                                     \
    case 16: return launch<16>(__VA_ARGS__);                               \
    case 32: return launch<32>(__VA_ARGS__);                               \
    case 48: return launch<48>(__VA_ARGS__);                               \
    case 64: return launch<64>(__VA_ARGS__);                               \
    case 80: return launch<80>(__VA_ARGS__);                               \
    case 96: return launch<96>(__VA_ARGS__);                               \
    case 112: return launch<112>(__VA_ARGS__);                             \
    case 128: return launch<128>(__VA_ARGS__);                             \
    default: return cudaErrorInvalidValue;                                 \
  }

// qkv [B, T, 3D] bf16 -> out [B, T, D] bf16 and, unless lse is null, lse
// [B, num_heads, T] fp32; keys at and past kv_len (1 <= kv_len <= T) are
// masked (a caller whose token axis is already padded: JAX's
// _blockwise_fwd_flat(seq_len=)). head_dim must be a multiple of 8 up to 128
// (ops/attention.py checks it before calling); any T.
VIT_EXPORT int vit_flash_attention_fwd(const void* qkv, void* out, float* lse, int B,
                                       int T, int kv_len, int num_heads, int head_dim,
                                       float scale, void* stream) {
  using namespace vit::flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || kv_len <= 0 || kv_len > T || num_heads <= 0 ||
      head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  const vit::bf16* base = static_cast<const vit::bf16*>(qkv);
  const int D = num_heads * head_dim;
  VIT_FLASH_DISPATCH(launch_fwd, base, base + D, base + 2 * D, out,
                     slab_views(T, num_heads, head_dim), lse, B, T, kv_len,
                     num_heads, head_dim, scale, s)
}

// The same kernel on split heads: q, k, v and out are [B, num_heads, T,
// head_dim] views given by base pointers and `strides` (12 element strides:
// image, head and row of q, k, v and out in turn; the last axis contiguous,
// rows 16-byte aligned), all bf16; lse as above or null.
VIT_EXPORT int vit_flash_attention_fwd_strided(const void* q, const void* k,
                                               const void* v, void* out, float* lse,
                                               const long long* strides, int B, int T,
                                               int num_heads, int head_dim, float scale,
                                               void* stream) {
  using namespace vit::flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  VIT_FLASH_DISPATCH(launch_fwd, q, k, v, out, head_views(strides), lse, B, T, T,
                     num_heads, head_dim, scale, s)
}

// qkv [B, T, 3D], the forward's out [B, T, D] and lse [B, num_heads, T],
// dout [B, T, D] -> dqkv [B, T, 3D], all bf16 but lse; dvec: fp32 scratch of
// B * num_heads * T (rowsum(dO * O), written by the dq kernel, read by the
// dK/dV kernel).
VIT_EXPORT int vit_flash_attention_bwd(const void* qkv, const void* out,
                                       const float* lse, const void* dout, void* dqkv,
                                       float* dvec, int B, int T, int num_heads,
                                       int head_dim, float scale, void* stream) {
  using namespace vit::flash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  VIT_FLASH_DISPATCH(launch_bwd, qkv, out, lse, dout, dqkv, dvec, B, T, num_heads,
                     head_dim, scale, s)
}

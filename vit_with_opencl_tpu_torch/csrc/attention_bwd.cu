// Backward of multi-head attention over a packed QKV buffer:
// (qkv [B, T, 3D], dO [B, T, D]) -> dqkv [B, T, 3D].
//
// Replaces vit_with_opencl_tpu/ops/attention.py:_packed_bwd_kernel
// (packed_attention_bwd) and the per-head backward that
// ops/fused_block.py:_attn_bwd_kernel inlines. "slab" packing as the forward
// (attention.cu). Per head, the numerics of the TPU kernel, which recomputes
// the softmax instead of saving it:
//   qs = bf16(q * q_scale)        as the forward (_head_attention)
//   s  = qs . k^T, fp32; m = rowmax(s); e = exp(s - m); inv = 1 / rowsum(e)
//   p  = e * inv                  the NORMALISED fp32 probability
//   dp = dO . v^T                 fp32
//   ds = bf16((p * (dp - delta)) * ds_scale),  delta = rowsum(dp * p)
//   dq = ds . k,  dk = ds^T . q (the unscaled q),  dv = bf16(p)^T . dO
// dqkv is written in bf16 or in fp32: the fused layer's backward keeps it in
// fp32 for the bias gradient and rounds it for its GEMMs. delta is taken
// from the recomputed p, not as FlashAttention's rowsum(dO * O) from the
// forward's rounded output: the two differ by the output's rounding. The
// design's one reassociation: delta = inv * rowsum(e * dp), one fp32 scale
// of the sum in place of a scale of each term, so that delta comes out of
// the same pass as rowsum(e); besides that only the order of fp32 sums
// differs from the plain version (rowsum(e) and rowsum(e * dp) pairwise
// within each chunk).
//
// Bound on the card: bytes at ViT-B's T = 197 (qkv and dO read, dqkv
// written: 136 MB at B = 64, about 0.04 ms; the products are about a
// quarter of that at the bf16 peak), operations at ViT-L/16@384's T = 577
// (10 T^2 hd a head: 109 GFLOP a layer at B = 32, about 0.11 ms). Design
// (Hopper, sm_90a; tiles and maps in attention_sm90.cuh): FlashAttention-2's
// split into two kernels, so that no block sums into another's output and
// dqkv has the same bits from run to run. Each block is one producer
// warpgroup, whose one thread keeps a TMA ring of 64-row tiles full, and two
// consumer warpgroups of 64 rows each; products are wgmma m64n64k16 with
// fp32 accumulators in registers. A block's shared memory depends on the
// head dim only, never on T:
//   dq kernel   per (image, head, 128 queries): qs and dO in registers as A
//               operands; K and V tiles stream three times: pass 1 S = qs .
//               K^T for the exact row max; pass 2 S and dP = dO . V^T for
//               rowsum(e) and rowsum(e * dp); pass 3 S and dP again for ds,
//               which (rounded in registers) is the A operand of dq += ds .
//               K, K read MN-major. It writes each row's (m, inv, delta) to
//               the stats buffer, 16 bytes a row, 64-row blocks whole.
//   dkv kernel  per (image, head, 128 keys): each consumer's K and V tiles
//               sit in shared memory as A operands; q tiles, dO tiles and
//               their rows' statistics (one bulk copy) stream in once. A
//               consumer writes qs = bf16(q * q_scale) into a tile of its
//               own (the swizzle permutes whole 16-byte chunks, so element
//               for element), then S^T = K . qs^T and dP^T = V . dO^T (both
//               operands from shared memory); p^T and ds^T are built in
//               registers and are the A operands of dv += bf16(p)^T . dO and
//               dk += ds^T . q, dO and the unscaled q read MN-major.
// Operations: 12 T^2 hd a head in the dq kernel, 8 in the dkv kernel (T
// padded to whole 64-row tiles); exponentials: three a score, expf (the
// plain version's torch.exp).
#include "attention_sm90.cuh"

namespace vit {
namespace attn90 {

constexpr int kDqStages = 4;      // K/V tile pairs in the dq kernel's ring
constexpr int kStatsBytes = kRows * 16;  // (m, inv, delta, unused) of 64 rows

template <int HDP>
__host__ __device__ constexpr int dkv_stages() {
  return boxes<HDP>() == 1 ? 4 : 3;
}
template <int HDP>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 1024 + kDqStages * 2 * tile_bytes<HDP>() + 2 * kDqStages * 8;
}
// The consumers' K and V tiles and qs tiles, then the ring (q, dO, stats).
template <int HDP>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 1024 + 3 * kConsumers * tile_bytes<HDP>() +
         dkv_stages<HDP>() * (2 * tile_bytes<HDP>() + kStatsBytes) +
         (1 + 2 * dkv_stages<HDP>()) * 8;
}

template <int HDP, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_qkv,
                        const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                        TOut* __restrict__ dqkv, float4* __restrict__ stats, int T,
                        int num_heads, int hd, float q_scale, float ds_scale) {
  constexpr int kB = boxes<HDP>(), kTile = tile_bytes<HDP>(), kSteps = HDP / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = smem_u32(aligned_smem(smem_raw));  // stage i: K, then V
  const uint32_t full = ring + kDqStages * 2 * kTile;
  const uint32_t empty = full + kDqStages * 8;
  const int b = blockIdx.z, h = blockIdx.y;
  const int nchunks = (T + kRows - 1) / kRows;
  const int active = min(kConsumers, (T - blockIdx.x * kConsumers * kRows + kRows - 1) / kRows);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < 3 * nchunks; ++s) {  // pass 1 loads K alone
        const int c = s % nchunks;
        const bool with_v = s >= nchunks;
        mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes
        const uint32_t bar = full + 8 * stage, k = ring + stage * 2 * kTile;
        mbar_expect_tx(bar, (with_v ? 2 : 1) * kTile);  // zero-filled boxes count whole
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          tma_load_4d(k + j * kBox, &map_qkv, 64 * j, num_heads + h, c * kRows, b, bar);
          if (with_v)
            tma_load_4d(k + kTile + j * kBox, &map_qkv, 64 * j, 2 * num_heads + h,
                        c * kRows, b, bar);
        }
        if (++stage == kDqStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128 - 1;
  if (wg >= active) return;  // no barrier of the block waits for it
  const int t = threadIdx.x % 128, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int r0 = (blockIdx.x * kConsumers + wg) * kRows + 16 * (t / 32);  // the warp's rows
  const int D = num_heads * hd;
  const bf16* img = qkv + static_cast<size_t>(b) * T * 3 * D;
  uint32_t qa[kSteps][4], da[kSteps][4];
  tiles::load_a<HDP>(qa, img, 3 * D, h * hd, r0, T, hd, q_scale, g, tq);
  tiles::load_a<HDP>(da, dout + static_cast<size_t>(b) * T * D, D, h * hd, r0, T, hd, 1.f,
                     g, tq);

  int stage = 0;
  uint32_t phase = 0;
  // The next tile pair: wait for it, issue S = qs . K^T (and dP = dO . V^T).
  auto products = [&](float (&s)[32], float (&dp)[32], bool with_dp) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t k = ring + stage * 2 * kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_rs<0>(s, qa[kk], desc_k(k, kk), kk > 0);
    if (with_dp)
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        wgmma_rs<0>(dp, da[kk], desc_k(k + kTile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
  };
  auto release = [&]() {
    mbar_arrive(empty + 8 * stage);
    if (++stage == kDqStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  auto mask = [&](float (&c)[32], int chunk) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = chunk * kRows + 8 * j + 2 * tq;
      if (key >= T) c[4 * j] = c[4 * j + 2] = kMaskValue;
      if (key + 1 >= T) c[4 * j + 1] = c[4 * j + 3] = kMaskValue;
    }
  };

  // Pass 1: the exact row max.
  float m0 = -FLT_MAX, m1 = -FLT_MAX;
  for (int c = 0; c < nchunks; ++c) {
    float s[32], dp[32];
    products(s, dp, false);
    release();
    mask(s, c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
      m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
  quad_max(m0);
  quad_max(m1);
  // Pass 2: rowsum(e) and rowsum(e * dp).
  float l0 = 0.f, l1 = 0.f, el0 = 0.f, el1 = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    float s[32], dp[32];
    products(s, dp, true);
    release();
    mask(s, c);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = expf(s[4 * j + e] - (e < 2 ? m0 : m1));
        dp[4 * j + e] *= s[4 * j + e];
      }
    float r0, r1, q0, q1;
    row_sums(s, r0, r1);
    row_sums(dp, q0, q1);
    l0 += r0;
    l1 += r1;
    el0 += q0;
    el1 += q1;
  }
  quad_sum(l0);
  quad_sum(l1);
  quad_sum(el0);
  quad_sum(el1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const float dl0 = inv0 * el0, dl1 = inv1 * el1;
  // Pass 3: ds, rounded to bf16 as the A operand of dq += ds . K.
  float dq[kB][32];
  for (int c = 0; c < nchunks; ++c) {
    float s[32], dp[32];
    products(s, dp, true);
    mask(s, c);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[4 * j + e] - (e < 2 ? m0 : m1)) * (e < 2 ? inv0 : inv1);
        s[4 * j + e] = (p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1))) * ds_scale;
      }
    uint32_t dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a(dsa[kk], s, kk);
    const uint32_t k = ring + stage * 2 * kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < kB; ++j) wgmma_rs<1>(dq[j], dsa[kk], desc_mn(k, j, kk), c + kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kB; ++j) fence_acc(dq[j]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_frag(dsa[kk]);
    release();
  }
  store_rows<kB, TOut>(dqkv + static_cast<size_t>(b) * T * 3 * D, 3 * D, h * hd, dq, 1.f, 1.f,
                       r0, T, hd, g, tq);
  if (tq == 0) {  // one lane a row
    float4* st = stats + static_cast<size_t>(b * num_heads + h) * nchunks * kRows;
    if (r0 + g < T) st[r0 + g] = make_float4(m0, inv0, dl0, 0.f);
    if (r0 + g + 8 < T) st[r0 + g + 8] = make_float4(m1, inv1, dl1, 0.f);
  }
}

template <int HDP, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_qkv,
                         const __grid_constant__ CUtensorMap map_do,
                         const float4* __restrict__ stats, TOut* __restrict__ dqkv, int T,
                         int num_heads, int hd, float q_scale, float ds_scale) {
  constexpr int kB = boxes<HDP>(), kTile = tile_bytes<HDP>(), kSteps = HDP / 16;
  constexpr int kStages = dkv_stages<HDP>(), kStage = 2 * kTile + kStatsBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  // Consumer w's K tile at kv + 2w tiles, its V tile after it; its qs tile
  // at qs + w tiles; ring stage i: q, dO, stats.
  const uint32_t kv = base, qs = kv + 2 * kConsumers * kTile, ring = qs + kConsumers * kTile;
  const uint32_t kv_full = ring + kStages * kStage, full = kv_full + 8,
                 empty = full + kStages * 8;
  const int b = blockIdx.z, h = blockIdx.y;
  const int nchunks = (T + kRows - 1) / kRows;
  const int active = min(kConsumers, (T - blockIdx.x * kConsumers * kRows + kRows - 1) / kRows);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, active * 2 * kTile);
      for (int w = 0; w < active; ++w) {
        const int k0 = (blockIdx.x * kConsumers + w) * kRows;
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          tma_load_4d(kv + 2 * w * kTile + j * kBox, &map_qkv, 64 * j, num_heads + h, k0, b,
                      kv_full);
          tma_load_4d(kv + (2 * w + 1) * kTile + j * kBox, &map_qkv, 64 * j,
                      2 * num_heads + h, k0, b, kv_full);
        }
      }
      const float4* st = stats + static_cast<size_t>(b * num_heads + h) * nchunks * kRows;
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c < nchunks; ++c) {
        mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes
        const uint32_t bar = full + 8 * stage, q = ring + stage * kStage;
        mbar_expect_tx(bar, kStage);
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          tma_load_4d(q + j * kBox, &map_qkv, 64 * j, h, c * kRows, b, bar);
          tma_load_4d(q + kTile + j * kBox, &map_do, 64 * j, h, c * kRows, b, bar);
        }
        bulk_load(q + 2 * kTile, st + c * kRows, kStatsBytes, bar);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128 - 1;
  if (wg >= active) return;  // no barrier of the block waits for it
  const int t = threadIdx.x % 128, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int r0 = (blockIdx.x * kConsumers + wg) * kRows + 16 * (t / 32);  // the warp's keys
  const uint32_t kt = kv + 2 * wg * kTile, vt = kt + kTile, qst = qs + wg * kTile;
  uint4* qs_tile = reinterpret_cast<uint4*>(smem + (qst - base));

  mbar_wait(kv_full, 0);
  float dk[kB][32], dv[kB][32];
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < nchunks; ++c) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t qt = ring + stage * kStage, dt = qt + kTile;
    const unsigned char* stage_ptr = smem + (qt - base);
    // qs = bf16(q * q_scale), element for element, once every warp's
    // products of the last step have read the tile.
    warpgroup_sync(wg);
    for (int i = t; i < kTile / 16; i += 128) {
      uint4 v = reinterpret_cast<const uint4*>(stage_ptr)[i];
      v.x = tiles::scale2(v.x, q_scale);
      v.y = tiles::scale2(v.y, q_scale);
      v.z = tiles::scale2(v.z, q_scale);
      v.w = tiles::scale2(v.w, q_scale);
      qs_tile[i] = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(wg);
    float s[32], dp[32];  // S^T and dP^T: rows are keys, columns queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_ss(s, desc_k(kt, kk), desc_k(qst, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_ss(dp, desc_k(vt, kk), desc_k(dt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // p^T into s, ds^T into dp; queries past T contribute nothing.
    const float4* st = reinterpret_cast<const float4*>(stage_ptr + 2 * kTile);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * j + 2 * tq + (e & 1);
        const float4 r = st[q];
        const bool ok = c * kRows + q < T;
        const float p = expf(s[4 * j + e] - r.x) * r.y;
        s[4 * j + e] = ok ? p : 0.f;
        dp[4 * j + e] = ok ? (p * (dp[4 * j + e] - r.z)) * ds_scale : 0.f;
      }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      to_a(pa[kk], s, kk);
      to_a(dsa[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        wgmma_rs<1>(dv[j], pa[kk], desc_mn(dt, j, kk), c + kk > 0);
        wgmma_rs<1>(dk[j], dsa[kk], desc_mn(qt, j, kk), c + kk > 0);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      fence_acc(dk[j]);
      fence_acc(dv[j]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_frag(pa[kk]);
      fence_frag(dsa[kk]);
    }
    mbar_arrive(empty + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  const int D = num_heads * hd;
  TOut* out = dqkv + static_cast<size_t>(b) * T * 3 * D;
  store_rows<kB, TOut>(out, 3 * D, D + h * hd, dk, 1.f, 1.f, r0, T, hd, g, tq);
  store_rows<kB, TOut>(out, 3 * D, 2 * D + h * hd, dv, 1.f, 1.f, r0, T, hd, g, tq);
}

template <int HDP, typename TOut>
cudaError_t launch(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                   int T, int num_heads, int hd, float q_scale, float ds_scale,
                   cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap map_qkv, map_do;
  if (!encode_head_map(&map_qkv, encode, qkv, hd, 3 * num_heads, T, B) ||
      !encode_head_map(&map_do, encode, dout, hd, num_heads, T, B))
    return cudaErrorInvalidValue;
  constexpr int s_dq = dq_smem_bytes<HDP>(), s_dkv = dkv_smem_bytes<HDP>();
  cudaError_t err = allow_dynamic_smem(attention_bwd_dq_kernel<HDP, TOut>, s_dq);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(attention_bwd_dkv_kernel<HDP, TOut>, s_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kConsumers * kRows - 1) / (kConsumers * kRows), num_heads, B);
  float4* st = reinterpret_cast<float4*>(stats);
  attention_bwd_dq_kernel<HDP, TOut><<<grid, kThreads, s_dq, stream>>>(
      map_qkv, static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<TOut*>(dqkv), st, T, num_heads, hd, q_scale, ds_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<HDP, TOut><<<grid, kThreads, s_dkv, stream>>>(
      map_qkv, map_do, st, static_cast<TOut*>(dqkv), T, num_heads, hd, q_scale, ds_scale);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t dispatch(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                     int T, int nh, int hd, float qs, float dss, cudaStream_t s) {
  switch ((hd + 15) / 16 * 16) {
    case 16: return launch<16, TOut>(qkv, dout, dqkv, stats, B, T, nh, hd, qs, dss, s);
    case 32: return launch<32, TOut>(qkv, dout, dqkv, stats, B, T, nh, hd, qs, dss, s);
    case 48: return launch<48, TOut>(qkv, dout, dqkv, stats, B, T, nh, hd, qs, dss, s);
    case 64: return launch<64, TOut>(qkv, dout, dqkv, stats, B, T, nh, hd, qs, dss, s);
    case 80: return launch<80, TOut>(qkv, dout, dqkv, stats, B, T, nh, hd, qs, dss, s);
    case 96: return launch<96, TOut>(qkv, dout, dqkv, stats, B, T, nh, hd, qs, dss, s);
    case 112: return launch<112, TOut>(qkv, dout, dqkv, stats, B, T, nh, hd, qs, dss, s);
    case 128: return launch<128, TOut>(qkv, dout, dqkv, stats, B, T, nh, hd, qs, dss, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn90
}  // namespace vit

// qkv [B, T, 3D] and dout [B, T, D] bf16; dqkv [B, T, 3D] in fp32 (0) or
// bf16 (1); stats: fp32 scratch of B * num_heads * ceil(T / 64) * 64 * 4,
// 16-byte aligned (each row's (m, inv, delta), padded to 16 bytes, in whole
// 64-row blocks). head_dim must be a multiple of 8 up to 128
// (ops/attention.py checks it before calling); any T.
VIT_EXPORT int vit_packed_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                        int dqkv_dtype, float* stats, int B, int T,
                                        int num_heads, int head_dim, float q_scale,
                                        float ds_scale, void* stream) {
  using namespace vit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  if (dqkv_dtype == kBF16)
    return attn90::dispatch<bf16>(qkv, dout, dqkv, stats, B, T, num_heads, head_dim,
                                  q_scale, ds_scale, s);
  if (dqkv_dtype == kF32)
    return attn90::dispatch<float>(qkv, dout, dqkv, stats, B, T, num_heads, head_dim,
                                   q_scale, ds_scale, s);
  return cudaErrorInvalidValue;
}

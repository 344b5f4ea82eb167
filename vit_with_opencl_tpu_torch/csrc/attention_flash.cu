// Blockwise (long-sequence) multi-head attention: the forward, with each
// row's log-sum-exp as an option, and its backward.
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
// hd] views, flash_attention past T = 1024): the same kernel, its K and V
// maps over the views. Per head, the numerics of the TPU kernels:
//   forward   s = (q . k^T) * scale, fp32 (scale is fp32, not folded into q);
//             keys at and past kv_len masked to MASK_VALUE; over key tiles
//             of 128 in order: m' = max(m, rowmax(s)), a = exp(m - m'),
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
// backward's function is 10 T^2 hd a head (s, dp, dq, dk, dv: 0.17 ms a
// layer at B = 16), its two kernels do 6 + 8 (the dq kernel s, dp, dq; the
// dK/dV kernel s, dp, dv, dk).
//
// Forward design (Hopper, sm_90a; maps and tiles of attention_sm90.cuh):
// a persistent grid of one block an SM walking units of (image, head, 192
// queries up to hd 64, 128 past it), a head's units side by side so that
// the blocks running at once share its K/V in L2. A block is one producer
// warpgroup and three consumer warpgroups of 64 queries each up to hd 64
// (two past it, where a consumer's accumulator doubles), which share every
// staged K/V tile. One producer thread loads each unit's 64-row q tiles
// (into two slots up to hd 64, so the next unit's load runs under this one;
// one past it) and 128-key K and V tiles (two 64-row boxes of 64 columns
// each, two column boxes past hd 64) by TMA into a ring of 5 stages up to
// hd 64, 3 past it; rows past T and columns past hd arrive as zeros, and a
// tile half wholly at or past kv_len is not loaded. V stays row-major, the
// PV product's MN-major B operand. Each consumer multiplies its unscaled q
// tile, from shared memory, into S = q . K^T (wgmma m64n128k16, both
// operands in shared memory: no registers hold q, which at hd 128 would
// spill), scales the fp32 scores, and runs the online softmax once per
// 128-key tile on 64 fp32 scores a thread; p, rounded to bf16 in registers,
// is the A operand of pv = bf16(p) . V (fp32, in registers), and acc = acc *
// a + pv, the tile's sum complete before it meets acc, as in the TPU kernel.
// The softmax, not the tensor cores, bounds a consumer (64 exponentials a
// thread a tile), so the consumers run independently and more of them hide
// more of its latency: a third consumer measured faster at hd 64, while
// turns at the tensor cores (as the packed kernel takes them) and,
// within a consumer, tile i's S issued with tile i - 1's PV product under
// tile i's softmax both measured slower. A consumer whose 64 queries all
// lie past T issues no products and stores nothing, but frees its stages.
// Tiles wholly past kv_len are skipped (a = 1, p = 0), and so is the
// product of a tile's second half when it holds only masked keys (p
// exactly 0, and the first half holds the row's max).
//
// Backward design (the same Hopper parts): FlashAttention-2's split into
// two kernels, so that no block sums into another's output and dqkv has the
// same bits from run to run (no atomics). Each block is one producer
// warpgroup and two consumer warpgroups of 64 rows (queries in the dq
// kernel, keys in the dK/dV kernel); products are wgmma m64n64k16 with fp32
// accumulators in registers; a block's shared memory depends on the head
// dim only.
//   dq     per (image, head, 128 queries): each consumer holds its q and dO
//          rows as A fragments, its rows' lse and their dvec (computed here
//          from dO and O, and written for the dK/dV kernel). One producer
//          thread streams each key tile's K and V once by TMA through a
//          ring; per tile S = q . K^T and dP = dO . V^T, p = exp(S * scale -
//          lse) (one expf a score), ds rounded in registers as the A
//          operand of dq += ds . K, K read MN-major: 6 T^2 hd a head.
//   dK/dV  per (image, head, 128 keys): each consumer's K and V tiles sit in
//          shared memory as A operands; q and dO tiles stream in by TMA,
//          and the producer warpgroup's 128 threads gather their rows' lse
//          and dvec into the stage (64 of each) and arrive on its barrier.
//          S^T = K . q^T and dP^T = V . dO^T from shared memory, p^T and
//          ds^T built in registers as the A operands of dv += bf16(p)^T .
//          dO and dk += ds^T . q (the unscaled q), dO and q read MN-major:
//          8 T^2 hd a head.
// Each accumulator takes its terms in tile order, as JAX's grids do: dq over
// key tiles, dk and dv over query tiles. Head dims that are a multiple of 8
// are zero-padded to the next of the compiled widths (16..128): the maps
// zero-fill the columns past hd (a second 64-column box past hd 64).
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "attention_sm90.cuh"

namespace vit {
namespace flash90 {

using namespace attn90;

// ---------------------------------------------------------------------------
// The backward: the dq kernel, then the dK/dV kernel.
// ---------------------------------------------------------------------------

constexpr int kBwdStages = 4;  // the rings' stages
// A dK/dV stage: a q tile, a dO tile, then 64 rows' lse and 64 dvec (512
// bytes, padded to 1024 so that the next stage's tiles keep the swizzle's
// alignment).
constexpr int kRowStatsBytes = 1024;

template <int HDP>
__host__ __device__ constexpr int bwd_dq_smem_bytes() {
  return 1024 + kBwdStages * 2 * tile_bytes<HDP>() + 2 * kBwdStages * 8;
}
template <int HDP>
__host__ __device__ constexpr int bwd_dkv_smem_bytes() {
  return 1024 + 2 * kConsumers * tile_bytes<HDP>() +
         kBwdStages * (2 * tile_bytes<HDP>() + kRowStatsBytes) + (1 + 2 * kBwdStages) * 8;
}

// Consumers of a block whose 64 rows start below T (warpgroup-uniform).
__device__ __forceinline__ int active_consumers(int T) {
  return min(kConsumers, (T - static_cast<int>(blockIdx.x) * kConsumers * kRows + kRows - 1) /
                             kRows);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
blockwise_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_qkv,
                        const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                        const float* __restrict__ lse, const bf16* __restrict__ dout,
                        bf16* __restrict__ dqkv, float* __restrict__ dvec, int T,
                        int num_heads, int hd, float scale) {
  constexpr int kB = boxes<HDP>(), kTile = tile_bytes<HDP>(), kSteps = HDP / 16;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = smem_u32(aligned_smem(smem_raw));  // stage i: K, then V
  const uint32_t full = ring + kBwdStages * 2 * kTile;
  const uint32_t empty = full + kBwdStages * 8;
  const int b = blockIdx.z, h = blockIdx.y;
  const int nchunks = (T + kRows - 1) / kRows;
  const int active = active_consumers(T);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
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
      for (int c = 0; c < nchunks; ++c) {
        mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes
        const uint32_t bar = full + 8 * stage, k = ring + stage * 2 * kTile;
        mbar_expect_tx(bar, 2 * kTile);  // zero-filled boxes count whole
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          tma_load_4d(k + j * kBox, &map_qkv, 64 * j, num_heads + h, c * kRows, b, bar);
          tma_load_4d(k + kTile + j * kBox, &map_qkv, 64 * j, 2 * num_heads + h, c * kRows,
                      b, bar);
        }
        if (++stage == kBwdStages) {
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
  const int row0 = r0 + g, row1 = r0 + g + 8;
  const int D = num_heads * hd;
  uint32_t qa[kSteps][4], da[kSteps][4];
  tiles::load_a<HDP>(qa, qkv + static_cast<size_t>(b) * T * 3 * D, 3 * D, h * hd, r0, T, hd,
                     1.f, g, tq);
  tiles::load_a<HDP>(da, dout + static_cast<size_t>(b) * T * D, D, h * hd, r0, T, hd, 1.f, g,
                     tq);
  // dvec = rowsum(dO * O) of the forward's rounded output: each lane the
  // columns of its dO fragment (zero past T and hd), then the row's 4 lanes.
  const bf16* oimg = out + static_cast<size_t>(b) * T * D;
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int row = reg & 1 ? row1 : row0;
      const int col = s * 16 + 2 * tq + (reg >> 1) * 8;
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
  quad_sum(dl0);
  quad_sum(dl1);
  const size_t row_stat = (static_cast<size_t>(b) * num_heads + h) * T;
  const float lse0 = row0 < T ? lse[row_stat + row0] : 0.f;
  const float lse1 = row1 < T ? lse[row_stat + row1] : 0.f;
  if (tq == 0) {  // for the dK/dV kernel
    if (row0 < T) dvec[row_stat + row0] = dl0;
    if (row1 < T) dvec[row_stat + row1] = dl1;
  }

  float dq[kB][32];
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < nchunks; ++c) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t k = ring + stage * 2 * kTile;
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_rs<0>(s, qa[kk], desc_k(k, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_rs<0>(dp, da[kk], desc_k(k + kTile, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // ds into s; keys at and past T masked (p = 0).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c * kRows + 8 * j + 2 * tq + (e & 1);
        const float sv = key < T ? s[4 * j + e] * scale : kMaskValue;
        const float p = expf(sv - (e < 2 ? lse0 : lse1));
        s[4 * j + e] = (p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1))) * scale;
      }
    uint32_t dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a(dsa[kk], s, kk);
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
    mbar_arrive(empty + 8 * stage);
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<kB, bf16>(dqkv + static_cast<size_t>(b) * T * 3 * D, 3 * D, h * hd, dq, 1.f, 1.f,
                       r0, T, hd, g, tq);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
blockwise_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_qkv,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         bf16* __restrict__ dqkv, int T, int num_heads, int hd,
                         float scale) {
  constexpr int kB = boxes<HDP>(), kTile = tile_bytes<HDP>(), kSteps = HDP / 16;
  constexpr int kStage = 2 * kTile + kRowStatsBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  // Consumer w's K tile at kv + 2w tiles, its V tile after it; ring stage
  // i: q, dO, the rows' lse and dvec.
  const uint32_t kv = base, ring = kv + 2 * kConsumers * kTile;
  const uint32_t kv_full = ring + kBwdStages * kStage, full = kv_full + 8,
                 empty = full + kBwdStages * 8;
  const int b = blockIdx.z, h = blockIdx.y;
  const int nchunks = (T + kRows - 1) / kRows;
  const int active = active_consumers(T);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + 8 * s, 1 + 128);  // the TMA loads' expect_tx, the gathers
      mbar_init(empty + 8 * s, 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int t = threadIdx.x;
    if (t == 0) {
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
    }
    // Thread t gathers lse (t < 64) or dvec of query row t % 64 of each tile.
    const float* src = (t < kRows ? lse : dvec) + (static_cast<size_t>(b) * num_heads + h) * T;
    float* st = reinterpret_cast<float*>(smem + (ring - base) + 2 * kTile) + t;
    int stage = 0;
    uint32_t phase = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int row = c * kRows + t % kRows;
      const float v = row < T ? src[row] : 0.f;
      mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes
      const uint32_t bar = full + 8 * stage, q = ring + stage * kStage;
      if (t == 0) {
        mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          tma_load_4d(q + j * kBox, &map_qkv, 64 * j, h, c * kRows, b, bar);
          tma_load_4d(q + kTile + j * kBox, &map_do, 64 * j, h, c * kRows, b, bar);
        }
      }
      st[stage * (kStage / 4)] = v;
      mbar_arrive(bar);
      if (++stage == kBwdStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128 - 1;
  if (wg >= active) return;  // no barrier of the block waits for it
  const int t = threadIdx.x % 128, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int r0 = (blockIdx.x * kConsumers + wg) * kRows + 16 * (t / 32);  // the warp's keys
  const uint32_t kt = kv + 2 * wg * kTile, vt = kt + kTile;

  mbar_wait(kv_full, 0);
  float dk[kB][32], dv[kB][32];
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < nchunks; ++c) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t qt = ring + stage * kStage, dt = qt + kTile;
    float s[32], dp[32];  // S^T and dP^T: rows are keys, columns queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_ss(s, desc_k(kt, kk), desc_k(qt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) wgmma_ss(dp, desc_k(vt, kk), desc_k(dt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    // p^T into s, ds^T into dp; queries past T contribute nothing.
    const float* st = reinterpret_cast<const float*>(smem + (qt - base) + 2 * kTile);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = 8 * j + 2 * tq;
      const float2 l = *reinterpret_cast<const float2*>(st + q);
      const float2 dl = *reinterpret_cast<const float2*>(st + kRows + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = c * kRows + q + (e & 1) < T;
        const float p = expf(s[4 * j + e] * scale - (e & 1 ? l.y : l.x));
        s[4 * j + e] = ok ? p : 0.f;
        dp[4 * j + e] = ok ? (p * (dp[4 * j + e] - (e & 1 ? dl.y : dl.x))) * scale : 0.f;
      }
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
    if (++stage == kBwdStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  const int D = num_heads * hd;
  bf16* o = dqkv + static_cast<size_t>(b) * T * 3 * D;
  store_rows<kB, bf16>(o, 3 * D, D + h * hd, dk, 1.f, 1.f, r0, T, hd, g, tq);
  store_rows<kB, bf16>(o, 3 * D, 2 * D + h * hd, dv, 1.f, 1.f, r0, T, hd, g, tq);
}

template <int HDP>
cudaError_t launch_bwd(const void* qkv, const void* out, const float* lse, const void* dout,
                       void* dqkv, float* dvec, int B, int T, int num_heads, int hd,
                       float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap map_qkv, map_do;
  if (!encode_head_map(&map_qkv, encode, qkv, hd, 3 * num_heads, T, B) ||
      !encode_head_map(&map_do, encode, dout, hd, num_heads, T, B))
    return cudaErrorInvalidValue;
  constexpr int s_dq = bwd_dq_smem_bytes<HDP>(), s_dkv = bwd_dkv_smem_bytes<HDP>();
  cudaError_t err = allow_dynamic_smem(blockwise_bwd_dq_kernel<HDP>, s_dq);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(blockwise_bwd_dkv_kernel<HDP>, s_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kConsumers * kRows - 1) / (kConsumers * kRows), num_heads, B);
  blockwise_bwd_dq_kernel<HDP><<<grid, kThreads, s_dq, stream>>>(
      map_qkv, static_cast<const bf16*>(qkv), static_cast<const bf16*>(out), lse,
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), dvec, T, num_heads, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  blockwise_bwd_dkv_kernel<HDP><<<grid, kThreads, s_dkv, stream>>>(
      map_qkv, map_do, lse, dvec, static_cast<bf16*>(dqkv), T, num_heads, hd, scale);
  return cudaGetLastError();
}


constexpr int kKeyTile = 128;  // the running max's step (JAX's block_k)

// A stage: a 128-key K tile, then its V tile. Column box j of a tile (64
// columns) is 128 rows of 128 bytes, two 64-row boxes back to back.
template <int HDP>
__host__ __device__ constexpr int key_tile_bytes() {
  return boxes<HDP>() * 2 * kBox;
}
// Consumer warpgroups of a block (64 queries each): three up to hd 64,
// where a consumer's scores, accumulator and p fit 160 registers, two past
// it; and the registers of a producer and of a consumer thread
// (setmaxnreg: within the SM's 64K).
template <int HDP>
__host__ __device__ constexpr int fwd_consumers() {
  return boxes<HDP>() == 1 ? 3 : 2;
}
template <int HDP>
__host__ __device__ constexpr int fwd_threads() {
  return 128 * (1 + fwd_consumers<HDP>());
}
template <int HDP>
__host__ __device__ constexpr int producer_regs() {
  return fwd_consumers<HDP>() == 2 ? 40 : 24;
}
template <int HDP>
__host__ __device__ constexpr int consumer_regs() {
  return fwd_consumers<HDP>() == 2 ? 232 : 160;
}
template <int HDP>
__host__ __device__ constexpr int fwd_stages() {
  return boxes<HDP>() == 1 ? 5 : 3;
}
// The consumers' q tiles: two units' at hd <= 64 (the next unit's load runs
// under this one), one past it.
template <int HDP>
__host__ __device__ constexpr int q_slots() {
  return boxes<HDP>() == 1 ? 2 : 1;
}
template <int HDP>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 1024 + fwd_stages<HDP>() * 2 * key_tile_bytes<HDP>() +
         q_slots<HDP>() * fwd_consumers<HDP>() * tile_bytes<HDP>() +
         2 * (fwd_stages<HDP>() + q_slots<HDP>()) * 8;
}

// K as the K-major B operand of S: keys 64 half.. (64 half + 63, or the
// tile's 128 keys from half 0 for an m64n128 product), hd step kk.
__device__ __forceinline__ uint64_t desc_key(uint32_t tile, int half, int kk) {
  return smem_desc(tile + (kk / 4) * 2 * kBox + half * kBox + (kk % 4) * 32, 16, 1024);
}
// V as the MN-major B operand of PV: keys 16 kk..16 kk + 15, columns 64j..
__device__ __forceinline__ uint64_t desc_val(uint32_t tile, int j, int kk) {
  return smem_desc(tile + j * 2 * kBox + kk * 2048, 2 * kBox, 1024);
}

struct FwdArgs {
  bf16* out;
  float* lse;           // [B, H, T] or null
  tiles::Strides os;    // element strides (image, head, row) of out
  MapOrder qo, ko, vo;  // where the maps of q, K and V keep head, row and image
  int q_head0, k_head0, v_head0;  // head h at head coordinate head0 + h of each map
  int T, kv_len, num_heads, hd, units;
  float scale;
};

template <int HDP>
__global__ void __launch_bounds__(fwd_threads<HDP>(), 1)
blockwise_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ FwdArgs a) {
  constexpr int kB = boxes<HDP>(), kKT = key_tile_bytes<HDP>(), kSteps = HDP / 16;
  constexpr int kStages = fwd_stages<HDP>(), kQSlots = q_slots<HDP>();
  constexpr int kTile = tile_bytes<HDP>(), kConsumers = fwd_consumers<HDP>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = smem_u32(aligned_smem(smem_raw));  // stage i: K, then V
  const uint32_t qbuf = ring + kStages * 2 * kKT;  // slot i: consumer 0's q, then 1's
  const uint32_t full = qbuf + kQSlots * kConsumers * kTile;
  const uint32_t empty = full + kStages * 8;
  const uint32_t q_full = empty + kStages * 8;
  const uint32_t q_empty = q_full + kQSlots * 8;
  const int T = a.T, kv_len = a.kv_len, num_heads = a.num_heads, hd = a.hd;
  const int units = a.units;
  const int ntiles = (kv_len + kKeyTile - 1) / kKeyTile;
  const int nqb = (T + kConsumers * kRows - 1) / (kConsumers * kRows);
  // Tile steps n = 0, 1, ... of this block, over its units in turn, take
  // stage n % kStages in phase (n / kStages) & 1; the block's i-th unit
  // takes q slot i % kQSlots in phase (i / kQSlots) & 1.
  auto stage_of = [](int n) { return n % kStages; };
  auto phase_of = [](int n) { return static_cast<uint32_t>((n / kStages) & 1); };
  auto qslot_of = [](int i) { return i % kQSlots; };
  auto qphase_of = [](int i) { return static_cast<uint32_t>((i / kQSlots) & 1); };
  // Whether tile i's second half holds a key below kv_len.
  auto both_halves = [kv_len](int i) { return i * kKeyTile + kRows < kv_len; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    for (int s = 0; s < kQSlots; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(producer_regs<HDP>()));
    if (threadIdx.x == 0) {
      int n = 0, i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
        const FwdUnit w = fwd_unit(u, nqb, num_heads);
        {  // the unit's two q tiles (rows past T zero-filled)
          const int qs = qslot_of(i);
          mbar_wait(q_empty + 8 * qs, qphase_of(i) ^ 1);  // the first round passes
          const uint32_t bar = q_full + 8 * qs;
          mbar_expect_tx(bar, kConsumers * kTile);
          for (int c = 0; c < kConsumers; ++c)
            for (int j = 0; j < kB; ++j)
              tma_load_view(qbuf + (qs * kConsumers + c) * kTile + j * kBox, &map_q, a.qo,
                            64 * j, a.q_head0 + w.h, (w.qb * kConsumers + c) * kRows, w.b,
                            bar);
        }
        for (int it = 0; it < ntiles; ++it, ++n) {
          const int halves = both_halves(it) ? 2 : 1;
          mbar_wait(empty + 8 * stage_of(n), phase_of(n) ^ 1);  // the first round passes
          const uint32_t bar = full + 8 * stage_of(n), k = ring + stage_of(n) * 2 * kKT;
          mbar_expect_tx(bar, 2 * kB * halves * kBox);  // zero-filled boxes count whole
          for (int j = 0; j < kB; ++j)
            for (int hf = 0; hf < halves; ++hf) {
              const int row = it * kKeyTile + hf * kRows;
              const uint32_t off = j * 2 * kBox + hf * kBox;
              tma_load_view(k + off, &map_k, a.ko, 64 * j, a.k_head0 + w.h, row, w.b, bar);
              tma_load_view(k + kKT + off, &map_v, a.vo, 64 * j, a.v_head0 + w.h, row, w.b,
                            bar);
            }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs<HDP>()));
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, lane = t % 32, g = lane / 4, tq = lane % 4;
  const float scale = a.scale;
  int n = 0, i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const FwdUnit w = fwd_unit(u, nqb, num_heads);
    const int q0 = (w.qb * kConsumers + wg) * kRows;  // this consumer's first query
    // Whether this consumer's 64 queries hold one below T (warpgroup-uniform).
    const bool live = q0 < T;
    const uint32_t qt = qbuf + (qslot_of(i) * kConsumers + wg) * kTile;
    mbar_wait(q_full + 8 * qslot_of(i), qphase_of(i));

    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[kB][32];
#pragma unroll
    for (int j = 0; j < kB; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[j][e] = 0.f;

    // One 128-key tile (NH 64-key halves of it): tile it of the unit, step n.
    auto tile = [&](auto nh, int it) {
      constexpr int NH = decltype(nh)::value;
      const uint32_t kt = ring + stage_of(n) * 2 * kKT, vt = kt + kKT;
      // A consumer past T leaves its products out, and its softmax runs on
      // these zeros: only the products are predicated, since branches
      // around the softmax made ptxas spill past hd 64.
      float s[NH][32] = {};
      mbar_wait(full + 8 * stage_of(n), phase_of(n));
      if (live) {
        wgmma_fence();
        if constexpr (NH == 2) {  // one m64n128k16 product a step
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            wgmma_ss_n128(s[0], s[NH - 1], desc_k(qt, kk), desc_key(kt, 0, kk), kk > 0);
        } else {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            wgmma_ss(s[0], desc_k(qt, kk), desc_key(kt, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      if (it == ntiles - 1) mbar_arrive(q_empty + 8 * qslot_of(i));  // q read for good
      const int k0 = it * kKeyTile;
      float mc0 = -INFINITY, mc1 = -INFINITY;
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {
        fence_acc(s[hf]);
#pragma unroll
        for (int e = 0; e < 32; ++e) s[hf][e] *= scale;
        if (k0 + NH * kRows > kv_len) {  // the tile holds masked keys
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = k0 + hf * kRows + 8 * j + 2 * tq;
            if (key >= kv_len) s[hf][4 * j] = s[hf][4 * j + 2] = kMaskValue;
            if (key + 1 >= kv_len) s[hf][4 * j + 1] = s[hf][4 * j + 3] = kMaskValue;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mc0 = fmaxf(mc0, fmaxf(s[hf][4 * j], s[hf][4 * j + 1]));
          mc1 = fmaxf(mc1, fmaxf(s[hf][4 * j + 2], s[hf][4 * j + 3]));
        }
      }
      quad_max(mc0);
      quad_max(mc1);
      const float mn0 = fmaxf(m0, mc0), mn1 = fmaxf(m1, mc1);
      const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);  // 0 on the first tile
      float ls0 = 0.f, ls1 = 0.f;
      uint32_t pa[4 * NH][4];
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[hf][4 * j] = expf(s[hf][4 * j] - mn0);
          s[hf][4 * j + 1] = expf(s[hf][4 * j + 1] - mn0);
          s[hf][4 * j + 2] = expf(s[hf][4 * j + 2] - mn1);
          s[hf][4 * j + 3] = expf(s[hf][4 * j + 3] - mn1);
        }
        float r0, r1;
        row_sums(s[hf], r0, r1);
        ls0 += r0;
        ls1 += r1;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) to_a(pa[4 * hf + kk], s[hf], kk);
      }
      quad_sum(ls0);
      quad_sum(ls1);
      l0 = a0 * l0 + ls0;
      l1 = a1 * l1 + ls1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < kB; ++j)
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          o[j][4 * d] *= a0;
          o[j][4 * d + 1] *= a0;
          o[j][4 * d + 2] *= a1;
          o[j][4 * d + 3] *= a1;
        }
      // The tile's bf16(p) . V in an accumulator of its own, then acc * a +
      // pv: the TPU kernel's acc * alpha + pv, the tile's sum complete before
      // it meets acc (accumulating into acc * a itself would round there
      // after every 16 keys).
      float pv[kB][32] = {};
      if (live) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NH; ++kk)
#pragma unroll
          for (int j = 0; j < kB; ++j) wgmma_rs<1>(pv[j], pa[kk], desc_val(vt, j, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        fence_acc(pv[j]);
#pragma unroll
        for (int e = 0; e < 32; ++e) o[j][e] += pv[j][e];
      }
#pragma unroll
      for (int kk = 0; kk < 4 * NH; ++kk) fence_frag(pa[kk]);
      mbar_arrive(empty + 8 * stage_of(n));
      ++n;
    };
    for (int it = 0; it < ntiles; ++it) {
      if (both_halves(it))
        tile(std::integral_constant<int, 2>(), it);
      else
        tile(std::integral_constant<int, 1>(), it);
    }
    if (!live) continue;
    const float inv0 = l0 == 0.f ? 1.f : 1.f / l0, inv1 = l1 == 0.f ? 1.f : 1.f / l1;
    const int r0 = q0 + 16 * (t / 32);  // the warp's first query
    store_rows<kB, bf16>(a.out + w.b * a.os.batch + w.h * a.os.head,
                         static_cast<int>(a.os.row), 0, o, inv0, inv1, r0, T, hd, g, tq);
    if (a.lse != nullptr && tq == 0) {  // one lane per row
      float* row_lse = a.lse + (static_cast<size_t>(w.b) * num_heads + w.h) * T;
      if (r0 + g < T) row_lse[r0 + g] = m0 + logf(l0 == 0.f ? 1.f : l0);
      if (r0 + g + 8 < T) row_lse[r0 + g + 8] = m1 + logf(l1 == 0.f ? 1.f : l1);
    }
  }
}

template <int HDP>
cudaError_t launch_fwd(const CUtensorMap& map_q, const CUtensorMap& map_k,
                       const CUtensorMap& map_v, FwdArgs args, int B, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  constexpr int smem = fwd_smem_bytes<HDP>(), kQ = fwd_consumers<HDP>() * kRows;
  const long long units =
      static_cast<long long>((args.T + kQ - 1) / kQ) * args.num_heads * B;
  if (units > INT_MAX || args.os.row > INT_MAX) return cudaErrorInvalidValue;
  args.units = static_cast<int>(units);
  const cudaError_t err = allow_dynamic_smem(blockwise_fwd_kernel<HDP>, smem);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(units < sms ? units : sms);  // persistent
  blockwise_fwd_kernel<HDP><<<grid, fwd_threads<HDP>(), smem, stream>>>(map_q, map_k, map_v,
                                                                       args);
  return cudaGetLastError();
}

// The slabs of qkv [B, T, 3D]: one map of 3H heads, q, K and V at head
// coordinates h, H + h and 2H + h; out [B, T, D].
template <int HDP>
cudaError_t launch_slabs(const void* qkv, void* out, float* lse, int B, int T, int kv_len,
                         int num_heads, int hd, float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const long long D = static_cast<long long>(num_heads) * hd;
  FwdArgs args{static_cast<bf16*>(out), lse, {T * D, hd, D}, {}, {}, {},
               0, num_heads, 2 * num_heads, T, kv_len, num_heads, hd, 0, scale};
  CUtensorMap map;
  if (!encode_view_map(&map, &args.qo, encode, qkv, hd, B, 3 * num_heads, T, T * 3 * D, hd,
                       3 * D))
    return cudaErrorInvalidValue;
  args.ko = args.vo = args.qo;
  return launch_fwd<HDP>(map, map, map, args, B, stream);
}

// Split heads: q, k, v and out as [B, H, T, hd] views (12 element strides).
template <int HDP>
cudaError_t launch_views(const void* q, const void* k, const void* v, void* out, float* lse,
                         const long long* st, int B, int T, int num_heads, int hd,
                         float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  FwdArgs args{static_cast<bf16*>(out), lse, {st[9], st[10], st[11]}, {}, {}, {},
               0, 0, 0, T, T, num_heads, hd, 0, scale};
  CUtensorMap map_q, map_k, map_v;
  if (!encode_view_map(&map_q, &args.qo, encode, q, hd, B, num_heads, T, st[0], st[1], st[2]) ||
      !encode_view_map(&map_k, &args.ko, encode, k, hd, B, num_heads, T, st[3], st[4], st[5]) ||
      !encode_view_map(&map_v, &args.vo, encode, v, hd, B, num_heads, T, st[6], st[7], st[8]))
    return cudaErrorInvalidValue;
  return launch_fwd<HDP>(map_q, map_k, map_v, args, B, stream);
}
}  // namespace flash90
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
  using namespace vit::flash90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || kv_len <= 0 || kv_len > T || num_heads <= 0 ||
      head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  VIT_FLASH_DISPATCH(launch_slabs, qkv, out, lse, B, T, kv_len, num_heads, head_dim, scale, s)
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
  using namespace vit::flash90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  VIT_FLASH_DISPATCH(launch_views, q, k, v, out, lse, strides, B, T, num_heads, head_dim,
                     scale, s)
}

// qkv [B, T, 3D], the forward's out [B, T, D] and lse [B, num_heads, T],
// dout [B, T, D] -> dqkv [B, T, 3D], all bf16 but lse; dvec: fp32 scratch of
// B * num_heads * T (rowsum(dO * O), written by the dq kernel, read by the
// dK/dV kernel).
VIT_EXPORT int vit_flash_attention_bwd(const void* qkv, const void* out,
                                       const float* lse, const void* dout, void* dqkv,
                                       float* dvec, int B, int T, int num_heads,
                                       int head_dim, float scale, void* stream) {
  using namespace vit::flash90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  VIT_FLASH_DISPATCH(launch_bwd, qkv, out, lse, dout, dqkv, dvec, B, T, num_heads,
                     head_dim, scale, s)
}

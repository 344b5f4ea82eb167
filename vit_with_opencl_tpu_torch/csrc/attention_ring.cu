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
// which moves once a key block, so there is no online softmax across the
// tiles of a block. A row whose block is all masked gets a finite m' near
// MASK_VALUE and counts its masked keys as ones in rowsum(p); a later live
// block wipes that out with a = 0, as on the TPU.
//
// Bound on the card: bytes. The carried statistics and accumulator are fp32
// and go both ways, so at ViT-L/16@512 on 4 shards (t_loc = 257, hd 64, B =
// 8: n = 128) the step moves ~30 MB, 56% of it acc, (0.0090 ms at 3.35
// TB/s) against 2.2 GFLOP (0.0022 ms at the bf16 peak).
//
// bf16 design (Hopper, sm_90a; maps and tiles of attention_sm90.cuh): a
// persistent grid of one block an SM walking units of (row group, 64 C
// queries), a row group's units side by side. A block is one producer
// warpgroup and C consumer warpgroups of 64 queries each (C = 3 up to hd
// 64, 2 past it, where a consumer's accumulator doubles), so a row group's
// queries take few units (two at t_loc = 257) and all of a unit's
// consumers share every K/V tile the block stages: a row group's K and V
// are read once a unit, not once a 64-query tile. One producer thread
// loads each unit's q tiles into q slots and the 64-key K and V tiles into
// a ring of stages by TMA from 3-D maps over [n, t_loc, hd] (rows past
// t_loc arrive as zeros; past hd 64 a tile is two 64-column boxes), while
// 64 producer threads stage each tile's fp32 key biases beside it, -inf at
// and past the key block's end (a ragged whole-shard block: 129-343 keys),
// and arrive on its barrier. Each consumer multiplies its unscaled q tile
// into S = q . K^T (wgmma m64n64k16, both operands in shared memory; a
// last chunk of at most 8 keys m64n8k16, so that a ragged shard's one key
// past 256 or 128 costs an eighth of a chunk), scales and biases the fp32
// scores, and takes two passes over the block's tiles: the stages stream K
// alone (pass 1: the exact max, chunk by chunk), then K and V (pass 2: S
// again, p, its row sum and acc += bf16(p) . V).
// The carried acc is loaded straight into the PV accumulator's fragment
// layout (8-byte loads, under pass 1), rescaled by a once a block, and
// stored from it; m and l are read and written once a row. A consumer
// whose 64 queries all lie past t_loc issues no products and stores
// nothing, but frees its stages. One pass at 257 keys would hold 132
// scores a thread besides acc, past the 128 (three consumers) or 168 (two)
// registers ptxas gives these blocks, and the ring's blocks hold at least
// 128 keys, so every block takes two passes.
// Measured no faster: a block's K/V held in the ring for both passes (no
// second load of K), and S(c + 1) kept in flight under the softmax of
// chunk c (two sets of A fragments; about 10% slower).
//
// fp32: the register-tiled CUDA-core body of attention_f32.cuh (plain FMA,
// no TF32), shared with the single-pass attention's fp32 form.
#include <limits.h>
#include <math.h>

#include "attention_f32.cuh"
#include "attention_sm90.cuh"

namespace vit {
namespace ring90 {

using namespace attn90;

constexpr int kBiasBytes = 1024;  // a stage's 64 biases (256 bytes), padded
                                  // to keep the next stage's swizzle aligned

// Consumer warpgroups of a block (64 queries each): three up to hd 64, two
// past it; the registers of a producer and of a consumer thread
// (setmaxnreg: within the block's 64K); the stages of the K/V ring and the
// q slots (two units' q at hd <= 64, so the next unit's load runs under
// this one's products; one past it).
template <int HDP>
__host__ __device__ constexpr int consumers() {
  return boxes<HDP>() == 1 ? 3 : 2;
}
template <int HDP>
__host__ __device__ constexpr int threads() {
  return 128 * (1 + consumers<HDP>());
}
template <int HDP>
__host__ __device__ constexpr int producer_regs() {
  return consumers<HDP>() == 2 ? 40 : 32;
}
template <int HDP>
__host__ __device__ constexpr int consumer_regs() {
  return consumers<HDP>() == 2 ? 232 : 160;
}
template <int HDP>
__host__ __device__ constexpr int stages() {
  return boxes<HDP>() == 1 ? 6 : 4;
}
template <int HDP>
__host__ __device__ constexpr int q_slots() {
  return boxes<HDP>() == 1 ? 2 : 1;
}
// A stage: a K tile, a V tile, then the tile's 64 key biases.
template <int HDP>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * tile_bytes<HDP>() + kBiasBytes;
}
template <int HDP>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<HDP>() * stage_bytes<HDP>() +
         q_slots<HDP>() * consumers<HDP>() * tile_bytes<HDP>() +
         2 * (stages<HDP>() + q_slots<HDP>()) * 8;
}

struct Args {
  const float* bias;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
  MapOrder qo, ko, vo;  // where the maps keep head (one), row and row group
  int t_loc, hd, block_k, units;
  float scale;
};

template <int HDP>
__global__ void __launch_bounds__(threads<HDP>(), 1)
ring_step_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ Args a) {
  constexpr int kB = boxes<HDP>(), kTile = tile_bytes<HDP>(), kSteps = HDP / 16;
  constexpr int kC = consumers<HDP>(), kStages = stages<HDP>(), kQSlots = q_slots<HDP>();
  constexpr int kStage = stage_bytes<HDP>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t ring = smem_u32(smem);             // stage i: K, V, the keys' bias
  const uint32_t qbuf = ring + kStages * kStage;    // slot i: consumer 0's q, then 1's, ...
  const uint32_t full = qbuf + kQSlots * kC * kTile;
  const uint32_t empty = full + kStages * 8;
  const uint32_t q_full = empty + kStages * 8;
  const uint32_t q_empty = q_full + kQSlots * 8;
  const int t_loc = a.t_loc, hd = a.hd, block_k = a.block_k, units = a.units;
  const int nblocks = t_loc / block_k;
  const int nc = (block_k + kRows - 1) / kRows;  // 64-key chunks of a key block
  const int block_steps = 2 * nc;  // pass 1 loads K alone
  // A block's last chunk holding at most 8 keys (ViT-L/16@512's 257-key and
  // 129-key shards, ViT-B's 197) takes m64n8k16 products: S of its 8 keys,
  // and PV over 16 keys of which the last 8 have p = 0.
  const bool tail8 = block_k - (nc - 1) * kRows <= 8;
  const int nqb = (t_loc + kC * kRows - 1) / (kC * kRows);
  // Tile steps n = 0, 1, ... of this block, over its units and their key
  // blocks in turn, take stage n % kStages in phase (n / kStages) & 1; the
  // block's i-th unit takes q slot i % kQSlots in phase (i / kQSlots) & 1.
  auto stage_of = [](int n) { return n % kStages; };
  auto phase_of = [](int n) { return static_cast<uint32_t>((n / kStages) & 1); };
  auto qslot_of = [](int i) { return i % kQSlots; };
  auto qphase_of = [](int i) { return static_cast<uint32_t>((i / kQSlots) & 1); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + kRows);  // the TMA loads' expect_tx, the biases
      mbar_init(empty + 8 * s, 128 * kC);
    }
    for (int s = 0; s < kQSlots; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 128 * kC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(producer_regs<HDP>()));
    const int pt = threadIdx.x;  // threads 0..63 stage the biases, 0 the tiles
    if (pt >= kRows) return;
    int n = 0, i = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
      const int rg = u / nqb, qb = u % nqb;
      if (pt == 0) {  // the unit's q tiles (rows past t_loc zero-filled)
        const int qs = qslot_of(i);
        mbar_wait(q_empty + 8 * qs, qphase_of(i) ^ 1);  // the first round passes
        const uint32_t bar = q_full + 8 * qs;
        mbar_expect_tx(bar, kC * kTile);
        for (int c = 0; c < kC; ++c)
          for (int j = 0; j < kB; ++j)
            tma_load_view(qbuf + (qs * kC + c) * kTile + j * kBox, &map_q, a.qo, 64 * j, 0,
                          (qb * kC + c) * kRows, rg, bar);
      }
      for (int b = 0; b < nblocks; ++b) {
        const int kend = (b + 1) * block_k;
        for (int s = 0; s < block_steps; ++s, ++n) {
          const bool with_v = s >= nc;
          const int k0 = b * block_k + (s % nc) * kRows;
          const float bv = k0 + pt < kend ? __ldg(a.bias + k0 + pt) : -INFINITY;
          mbar_wait(empty + 8 * stage_of(n), phase_of(n) ^ 1);  // the first round passes
          const uint32_t st = ring + stage_of(n) * kStage, bar = full + 8 * stage_of(n);
          if (pt == 0) {
            mbar_expect_tx(bar, (with_v ? 2 : 1) * kTile);  // zero-filled boxes count whole
            for (int j = 0; j < kB; ++j) {
              tma_load_view(st + j * kBox, &map_k, a.ko, 64 * j, 0, k0, rg, bar);
              if (with_v)
                tma_load_view(st + kTile + j * kBox, &map_v, a.vo, 64 * j, 0, k0, rg, bar);
            }
          }
          reinterpret_cast<float*>(smem + stage_of(n) * kStage + 2 * kTile)[pt] = bv;
          mbar_arrive(bar);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(consumer_regs<HDP>()));
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, lane = t % 32, g = lane / 4, tq = lane % 4;
  const float scale = a.scale;
  auto k_tile = [&](int m) { return ring + stage_of(m) * kStage; };
  auto biases = [&](int m) {
    return reinterpret_cast<const float*>(smem + stage_of(m) * kStage + 2 * kTile);
  };
  // s = fp32(q . k^T) * scale + bias, rounded after each (the stage's bias
  // is -inf at and past the block's end: no max, p exactly 0).
  auto bias_scores = [&](float (&s)[32], const float* bs) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * tq);
      s[4 * j] = __fadd_rn(__fmul_rn(s[4 * j], scale), bb.x);
      s[4 * j + 1] = __fadd_rn(__fmul_rn(s[4 * j + 1], scale), bb.y);
      s[4 * j + 2] = __fadd_rn(__fmul_rn(s[4 * j + 2], scale), bb.x);
      s[4 * j + 3] = __fadd_rn(__fmul_rn(s[4 * j + 3], scale), bb.y);
    }
  };
  // The same for the 8 keys of a tail (s[0], s[1]: row g, keys 2tq, + 1).
  auto bias_tail = [&](float (&s)[4], const float* bs) {
    const float2 bb = *reinterpret_cast<const float2*>(bs + 2 * tq);
    s[0] = __fadd_rn(__fmul_rn(s[0], scale), bb.x);
    s[1] = __fadd_rn(__fmul_rn(s[1], scale), bb.y);
    s[2] = __fadd_rn(__fmul_rn(s[2], scale), bb.x);
    s[3] = __fadd_rn(__fmul_rn(s[3], scale), bb.y);
  };
  auto row_max = [](const float (&c)[32], float& m0, float& m1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(c[4 * j], c[4 * j + 1]));
      m1 = fmaxf(m1, fmaxf(c[4 * j + 2], c[4 * j + 3]));
    }
  };
  // p = exp(s - m') in place, its row sums (pairwise) added to (l0, l1).
  auto exp_rows = [](float (&c)[32], float m0, float m1, float& l0, float& l1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[4 * j] = expf(c[4 * j] - m0);
      c[4 * j + 1] = expf(c[4 * j + 1] - m0);
      c[4 * j + 2] = expf(c[4 * j + 2] - m1);
      c[4 * j + 3] = expf(c[4 * j + 3] - m1);
    }
    float r0, r1;
    row_sums(c, r0, r1);
    l0 += r0;
    l1 += r1;
  };

  int n = 0, i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int rg = u / nqb, qb = u % nqb;
    const int q0 = (qb * kC + wg) * kRows;  // this consumer's first query
    // Whether this consumer's 64 queries hold one below t_loc
    // (warpgroup-uniform); only the products are predicated on it.
    const bool live = q0 < t_loc;
    const int r0 = q0 + 16 * (t / 32), row0 = r0 + g, row1 = r0 + g + 8;
    const size_t base = static_cast<size_t>(rg) * t_loc;
    float m0 = row0 < t_loc ? a.m_in[base + row0] : -INFINITY;
    float m1 = row1 < t_loc ? a.m_in[base + row1] : -INFINITY;
    float l0 = row0 < t_loc ? a.l_in[base + row0] : 0.f;
    float l1 = row1 < t_loc ? a.l_in[base + row1] : 0.f;
    // The carried acc in the PV accumulator's layout (o[j][4d], o[j][4d+1]:
    // row0, columns 64j + 8d + 2tq, +1; o[j][4d+2], o[j][4d+3]: row1).
    float o[kB][32];
#pragma unroll
    for (int j = 0; j < kB; ++j)
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int col = 64 * j + 8 * d + 2 * tq;
        float2 x0 = make_float2(0.f, 0.f), x1 = make_float2(0.f, 0.f);
        if (col < hd && row0 < t_loc)
          x0 = __ldg(reinterpret_cast<const float2*>(a.acc_in + (base + row0) * hd + col));
        if (col < hd && row1 < t_loc)
          x1 = __ldg(reinterpret_cast<const float2*>(a.acc_in + (base + row1) * hd + col));
        o[j][4 * d] = x0.x;
        o[j][4 * d + 1] = x0.y;
        o[j][4 * d + 2] = x1.x;
        o[j][4 * d + 3] = x1.y;
      }
    const uint32_t qt = qbuf + (qslot_of(i) * kC + wg) * kTile;
    mbar_wait(q_full + 8 * qslot_of(i), qphase_of(i));
    // S = q . K^T of the K tile at `k` into s; of its first 8 keys alone.
    auto scores = [&](float (&s)[32], uint32_t k) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) wgmma_ss(s, desc_k(qt, kk), desc_k(k, kk), kk > 0);
    };
    auto scores_n8 = [&](float (&s)[4], uint32_t k) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) wgmma_ss_n8(s, desc_k(qt, kk), desc_k(k, kk), kk > 0);
    };
    // The block's max is known: move the running max, rescale acc.
    auto move_max = [&](float mb0, float mb1, float& a0, float& a1) {
      quad_max(mb0);
      quad_max(mb1);
      const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
      a0 = expf(m0 - mn0);  // 0 from the first rotation's m = -inf
      a1 = expf(m1 - mn1);
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
    };
    // acc += bf16(p) . V_chunk (pa: the chunk's p as A fragments).
    auto pv = [&](const uint32_t (&pa)[4][4], uint32_t v) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < kB; ++j) wgmma_rs<1>(o[j], pa[kk], desc_mn(v, j, kk), 1);
    };
    for (int b = 0; b < nblocks; ++b) {
      const bool last = b == nblocks - 1;
      float a0, a1, lb0 = 0.f, lb1 = 0.f;
      // Pass 1: the block's exact max of each row.
      float mb0 = -INFINITY, mb1 = -INFINITY;
      for (int c = 0; c < nc; ++c, ++n) {
        mbar_wait(full + 8 * stage_of(n), phase_of(n));
        if (tail8 && c == nc - 1) {
          float s[4] = {0.f, 0.f, 0.f, 0.f};
          if (live) {
            wgmma_fence();
            scores_n8(s, k_tile(n));
            wgmma_commit();
            wgmma_wait<0>();
          }
          fence_acc(s);
          bias_tail(s, biases(n));
          mbar_arrive(empty + 8 * stage_of(n));
          mb0 = fmaxf(mb0, fmaxf(s[0], s[1]));
          mb1 = fmaxf(mb1, fmaxf(s[2], s[3]));
          continue;
        }
        float s[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.f;
        if (live) {
          wgmma_fence();
          scores(s, k_tile(n));
          wgmma_commit();
          wgmma_wait<0>();
        }
        fence_acc(s);
        bias_scores(s, biases(n));
        mbar_arrive(empty + 8 * stage_of(n));
        row_max(s, mb0, mb1);
      }
      move_max(mb0, mb1, a0, a1);
      // Pass 2: p against the moved max, its row sums, acc += bf16(p) . V.
      for (int c = 0; c < nc; ++c, ++n) {
        mbar_wait(full + 8 * stage_of(n), phase_of(n));
        const uint32_t k = k_tile(n);
        const bool q_done = last && c == nc - 1;  // q read for good after this S
        if (tail8 && c == nc - 1) {
          float s[4] = {0.f, 0.f, 0.f, 0.f};
          if (live) {
            wgmma_fence();
            scores_n8(s, k);
            wgmma_commit();
            wgmma_wait<0>();
          }
          if (q_done) mbar_arrive(q_empty + 8 * qslot_of(i));
          fence_acc(s);
          bias_tail(s, biases(n));
          s[0] = expf(s[0] - m0);
          s[1] = expf(s[1] - m0);
          s[2] = expf(s[2] - m1);
          s[3] = expf(s[3] - m1);
          lb0 += s[0] + s[1];
          lb1 += s[2] + s[3];
          // Keys 0..7 of the tail's first 16 (the rest have p = 0).
          uint32_t pa[4] = {pack_bf16x2(s[0], s[1]), pack_bf16x2(s[2], s[3]), 0u, 0u};
          if (live) {
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < kB; ++j) wgmma_rs<1>(o[j], pa, desc_mn(k + kTile, j, 0), 1);
            wgmma_commit();
            wgmma_wait<0>();
          }
#pragma unroll
          for (int j = 0; j < kB; ++j) fence_acc(o[j]);
          fence_frag(pa);
          mbar_arrive(empty + 8 * stage_of(n));
          continue;
        }
        float s[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.f;
        if (live) {
          wgmma_fence();
          scores(s, k);
          wgmma_commit();
          wgmma_wait<0>();
        }
        if (q_done) mbar_arrive(q_empty + 8 * qslot_of(i));
        fence_acc(s);
        bias_scores(s, biases(n));
        exp_rows(s, m0, m1, lb0, lb1);
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) to_a(pa[kk], s, kk);
        if (live) {
          wgmma_fence();
          pv(pa, k + kTile);
          wgmma_commit();
          wgmma_wait<0>();
        }
#pragma unroll
        for (int j = 0; j < kB; ++j) fence_acc(o[j]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_frag(pa[kk]);
        mbar_arrive(empty + 8 * stage_of(n));
      }
      quad_sum(lb0);
      quad_sum(lb1);
      l0 = __fadd_rn(__fmul_rn(a0, l0), lb0);
      l1 = __fadd_rn(__fmul_rn(a1, l1), lb1);
    }
    if (!live) continue;
    if (tq == 0) {  // one lane per row
      if (row0 < t_loc) {
        a.m_out[base + row0] = m0;
        a.l_out[base + row0] = l0;
      }
      if (row1 < t_loc) {
        a.m_out[base + row1] = m1;
        a.l_out[base + row1] = l1;
      }
    }
    store_rows<kB, float>(a.acc_out + base * hd, hd, 0, o, 1.f, 1.f, r0, t_loc, hd, g, tq);
  }
}

// The three 3-D maps ([n, 1, t_loc, hd] views: 64-row boxes, rows past
// t_loc zero-filled), a persistent grid of one block an SM.
template <int HDP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* bias,
                        const float* m_in, const float* l_in, const float* acc_in,
                        float* m_out, float* l_out, float* acc_out, int n, int t_loc, int hd,
                        int block_k, float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  Args args{bias, m_in, l_in, acc_in, m_out, l_out, acc_out, {}, {}, {},
            t_loc, hd, block_k, 0, scale};
  const long long sb = static_cast<long long>(t_loc) * hd;
  CUtensorMap map_q, map_k, map_v;
  if (!encode_view_map(&map_q, &args.qo, encode, q, hd, n, 1, t_loc, sb, hd, hd) ||
      !encode_view_map(&map_k, &args.ko, encode, k, hd, n, 1, t_loc, sb, hd, hd) ||
      !encode_view_map(&map_v, &args.vo, encode, v, hd, n, 1, t_loc, sb, hd, hd))
    return cudaErrorInvalidValue;
  constexpr int kQ = consumers<HDP>() * kRows, smem = smem_bytes<HDP>();
  const long long units = static_cast<long long>((t_loc + kQ - 1) / kQ) * n;
  if (units > INT_MAX) return cudaErrorInvalidValue;
  args.units = static_cast<int>(units);
  const cudaError_t err = allow_dynamic_smem(ring_step_wgmma_kernel<HDP>, smem);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(units < sms ? units : sms);  // persistent
  ring_step_wgmma_kernel<HDP><<<grid, threads<HDP>(), smem, stream>>>(map_q, map_k, map_v,
                                                                      args);
  return cudaGetLastError();
}

}  // namespace ring90

namespace ring32 {

template <int HDP>
__global__ void __launch_bounds__(f32attn::kThreads, f32attn::min_blocks<HDP>())
ring_step_f32_tiled_kernel(const __grid_constant__ f32attn::Args args) {
  f32attn::attention_f32<HDP, f32attn::kRingStep>(args);
}

// [n, t_loc, hd] as n images of one head.
template <int HDP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const float* bias,
                       const float* m_in, const float* l_in, const float* acc_in,
                       float* m_out, float* l_out, float* acc_out, int n, int t_loc, int hd,
                       int block_k, float scale, cudaStream_t stream) {
  const Strides st{static_cast<long long>(t_loc) * hd, 0, hd};
  f32attn::Args args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), acc_out, st, st, st, st, bias, m_in,
                     l_in, acc_in, m_out, l_out, t_loc, t_loc, block_k, hd, scale};
  return f32attn::launch(ring_step_f32_tiled_kernel<HDP>, f32attn::smem_bytes<HDP>(), args,
                         1, n, stream);
}

}  // namespace ring32

template <int HDP>
cudaError_t ring_launch(int dtype, const void* q, const void* k, const void* v,
                        const float* bias, const float* m_in, const float* l_in,
                        const float* acc_in, float* m_out, float* l_out, float* acc_out,
                        int n, int t_loc, int hd, int block_k, float scale,
                        cudaStream_t stream) {
  if (dtype == kBF16)
    return ring90::launch_bf16<HDP>(q, k, v, bias, m_in, l_in, acc_in, m_out, l_out,
                                    acc_out, n, t_loc, hd, block_k, scale, stream);
  if (dtype == kF32)
    return ring32::launch_f32<HDP>(q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out,
                                   n, t_loc, hd, block_k, scale, stream);
  return cudaErrorInvalidValue;
}

template <int HDP>
int ring_geometry(int what) {
  switch (what) {
    case 0: return ring90::smem_bytes<HDP>();
    case 1: return ring90::consumers<HDP>() * attn90::kRows;
    case 2: return static_cast<int>(f32attn::smem_bytes<HDP>());
    default: return -1;
  }
}

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
  using vit::ring_launch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || t_loc <= 0 || block_k <= 0 || t_loc % block_k != 0 ||
      head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return ring_launch<16>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 32: return ring_launch<32>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 48: return ring_launch<48>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 64: return ring_launch<64>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 80: return ring_launch<80>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 96: return ring_launch<96>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 112: return ring_launch<112>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    case 128: return ring_launch<128>(dtype, q, k, v, bias, m_in, l_in, acc_in, m_out, l_out, acc_out, n, t_loc, head_dim, block_k, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The kernels' geometry at a head_dim vit_ring_step takes, for the host's
// copies of it (ops/attention.py) to be held against: `what` 0 the bf16
// kernel's shared memory a block, 1 its queries a unit, 2 the fp32 body's
// shared memory a block (bytes; the fp32 single-pass attention's too).
// -1 for anything else.
VIT_EXPORT int vit_ring_step_geometry(int head_dim, int what) {
  if (head_dim <= 0 || head_dim % 8 != 0 || head_dim > 128) return -1;
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return vit::ring_geometry<16>(what);
    case 32: return vit::ring_geometry<32>(what);
    case 48: return vit::ring_geometry<48>(what);
    case 64: return vit::ring_geometry<64>(what);
    case 80: return vit::ring_geometry<80>(what);
    case 96: return vit::ring_geometry<96>(what);
    case 112: return vit::ring_geometry<112>(what);
    default: return vit::ring_geometry<128>(what);
  }
}

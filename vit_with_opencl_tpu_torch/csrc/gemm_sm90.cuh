// The bf16 GEMM core for Hopper (sm_90a): out[M, N] = epi(A[M, K] . B[K, N])
// with fp32 accumulation, TMA loads and wgmma.
//
// Replaces, on one core:
//   * vit_with_opencl_tpu/ops/linear.py:_linear_kernel and the four bf16
//     matmuls of ops/fused_block.py:_block_kernel (_mm): the forward form,
//     A = x [M, K] row-major, B = w [K, N] row-major (models/vit.stack_params'
//     layout); also the MLP backward's fc1 recompute (two outputs);
//   * the backward's GEMM forms of ops/fused_block.py (_dot inside
//     _mlp_bwd_kernel, _mlp_light_bwd_kernel, _mlp_wgrad_kernel and
//     _attn_bwd_kernel): dgrad, dY [M, N'] . W^T with W stored [K', N'] (B
//     read K-major), and wgrad, X^T . dY over the B*T tokens (A and B both
//     read MN-major; the contraction is the ragged token axis).
// The three operand layouts are wgmma's transpose bits (kAMN, kBMN), not
// separate staging code: a K-major operand is one TMA box of 64 x 128 (K
// inner), an MN-major one two boxes of 64 x 64 (MN inner), both with the
// 128-byte swizzle, which the shared-memory descriptors below describe.
//
// Bound on the card: operations at the encoder's shapes (K = 768 or 3072
// against M = B*197 rows, far above ~295 bf16 operations per byte); bytes
// for out-proj and fc2 with their fp32 residual and output at small K/N.
// Design: 128 x 128 output tiles, 64-deep K slices in a ring of kStages
// stages (32 KiB a stage) that one producer warpgroup keeps full (one
// thread issues the TMA loads; setmaxnreg gives the registers to the
// consumers). Two consumer warpgroups take the work units in turns
// ("ping-pong"): each computes a whole tile as two m64n128k16 wgmma per
// 16-deep step (one k-slice's group kept in flight: a stage is released
// when the next slice's products have been issued), so that one runs its
// epilogue while the other's products keep the tensor cores busy; turn
// barriers keep the two in order. The grid is persistent: a block per SM
// walks the units in order. The products and TMA's writes keep shared
// memory busy, so the epilogue spends little of it: a tile whose epilogue
// is the bias at most (qkv, the dgrads, the wgrads, split partials) is
// staged in the output type, swizzled as the TMA store's boxes want, and
// stored by TMA; the others (residual, GELU, its gradient, a second output)
// are staged in fp32 64 rows at a time and finished along the rows
// (16-byte loads and stores, a warp a row), 4 rows at a time with their
// reads issued first, with one copy of the epilogue's code (unrolled over
// the accumulator's registers it ran from outside the instruction cache).
// TMA zero-fills the ragged edges on load (M = B*197, the token axis of
// wgrad, N or K = 192 at ViT-Ti) and clips them on store; the staged
// epilogue masks its stores. Split-K (the weight gradients, few tiles over
// many tokens): the first `full` tiles (whole waves of SMs) run whole; the
// rest run in `splits` runs of `chunk` slices, each unit storing its fp32
// partial tile into a slot of `partial`, which gemm_sm90.cu's second kernel
// sums in a fixed order: no atomics, the same bits from run to run.
#pragma once

#include "epilogue.cuh"
#include "sm90.cuh"

namespace vit {
namespace sm90 {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups, a whole tile each, in turns
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kATile = kBM * kBK * 2;  // bytes
constexpr int kBTile = kBN * kBK * 2;
constexpr int kStageBytes = kATile + kBTile;
constexpr int kBox = 64 * 64 * 2;  // one 64 x 64 MN-major box: 8 KiB
// The epilogue's staging tile: 64 x 128 fp32 products for each consumer
// warpgroup, rows padded by 8 floats (conflict-free float2 writes in the
// accumulator's layout and float4 reads along the rows).
constexpr int kEpiPitch = kBN + 8;
constexpr int kEpiBytes = kConsumers * 64 * kEpiPitch * 4;
// The ring, 1024-byte aligned for the 128-byte swizzle (the dynamic shared
// memory's base is aligned by hand), the staging tiles, then the full and
// empty barriers and the consumers' two turn barriers.
constexpr int kSmemBytes =
    1024 + kStages * kStageBytes + kEpiBytes + (2 * kStages + 2) * 8;

struct GemmArgs {
  int M, N;
  int tiles_m, tiles_n;
  int k_tiles;      // 64-deep slices of K
  int full;         // tiles 0..full-1 run whole, with the epilogue
  int splits;       // the other tiles run in `splits` runs of `chunk` slices
  int chunk;
  float* partial;   // their fp32 slots [splits][tiles - full][kBM][kBN]
  int store_out;    // whole tiles' epilogue: the bias at most, TMA stores
  Epilogue ep;
};

// d[64 x 128] += A[64 x 16] . B[16 x 128], both from shared memory; kTA /
// kTB: the operand is MN-major (transposed against wgmma's K-major default).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// Work unit u: the whole tiles first, in row-major tile order (the units
// running at once share their A rows in L2); then the split tiles,
// split-major, so that the units running at once share their K range.
struct Unit {
  int m0, n0, k_begin, k_end;
  int slot;  // -1: a whole tile; else its partial's slot
};
__device__ __forceinline__ Unit unit_of(int u, const GemmArgs& g) {
  Unit w;
  int tile = u;
  w.k_begin = 0;
  w.k_end = g.k_tiles;
  w.slot = -1;
  if (u >= g.full) {
    const int rest = g.tiles_m * g.tiles_n - g.full, v = u - g.full;
    const int split = v / rest;
    tile = g.full + (v - split * rest);
    w.k_begin = split * g.chunk;
    w.k_end = min(w.k_begin + g.chunk, g.k_tiles);
    w.slot = v;  // split * rest + (tile - full)
  }
  const int mb = tile / g.tiles_n;
  w.m0 = mb * kBM;
  w.n0 = (tile - mb * g.tiles_n) * kBN;
  return w;
}

// The staged epilogue of rows m0..m0+63 of a whole tile, whose products are
// in acc (the accumulator of one m64n128 wgmma of warpgroup wg). wgmma's
// accumulator layout: thread t holds, for each 8-column group j, columns
// 8j + 2(t%4) + {0, 1} of row 16(t/32) + (t%32)/4 (acc[4j], acc[4j+1]) and
// of the row 8 below (acc[4j+2], acc[4j+3]). They go through the staging
// tile; then thread t finishes columns 4(t%32)..+3 of rows t/32 + 4i (a warp
// a whole row: 512 contiguous bytes of fp32), 4 rows at a time, their reads
// issued before their arithmetic (the first batch's before the staging).
// b: the bias of the thread's columns.
__device__ __forceinline__ void epilogue_rows(const float (&acc)[64], float* stage_tile,
                                              const Unit& w, int m0, int t, int wg,
                                              const float (&b)[4], const GemmArgs& g) {
  constexpr int kRows = 4;  // a batch
  const int c = 4 * (t % 32), gn = w.n0 + c;
  const bool col_ok = gn < g.N;  // N % 8 == 0: 4 columns all in or all out
  float x[kRows][4];
  int gm[kRows];
  bool ok[kRows];
  auto rows = [&](int batch) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      gm[i] = m0 + t / 32 + 4 * (kRows * batch + i);
      ok[i] = col_ok && gm[i] < g.M;
    }
    load_rows<kRows, 4>(x, gm, ok, gn, g.N, g.ep);
  };
  rows(0);
  {
    const int r = (t / 32) * 16 + (t % 32) / 4, cc = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(stage_tile + (r + 8 * h) * kEpiPitch + cc + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  warpgroup_sync(wg);
#pragma unroll 1
  for (int batch = 0; batch < 64 / (4 * kRows); ++batch) {
    if (batch > 0) rows(batch);
    float v[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(
          stage_tile + (gm[i] - m0) * kEpiPitch + c);
      v[i][0] = p.x;
      v[i][1] = p.y;
      v[i][2] = p.z;
      v[i][3] = p.w;
    }
    apply_rows<kRows, 4>(v, x, b, gm, ok, gn, g.N, g.ep);
  }
  warpgroup_sync(wg);  // the staging tile is rewritten next
}

// Whether a unit's epilogue reads nothing per element and computes nothing
// but the bias (the forward's qkv, the dgrads, the wgrads and the split
// partials): then its tile goes out by TMA store, as 64-row halves staged
// in the output type with the 128-byte swizzle of the store's boxes (bf16:
// two boxes of 64 columns, fp32: four of 32). That halves the staging's
// shared-memory traffic against the staged epilogue (which the other
// warpgroup's products keep busy) and leaves the stores to the TMA unit.
__device__ __forceinline__ bool tma_epilogue(const Unit& w, const GemmArgs& g) {
  return w.slot >= 0 || g.store_out;
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// The TMA-store epilogue of rows blk*64..+63 of a unit (acc: that
// accumulator), by warpgroup wg's 128 threads; thread t holds the pairs of
// wgmma's accumulator layout (see epilogue_rows). The staging tile's last
// stores must have read it: the thread that issued them (t = 0) waits, then
// the warpgroup meets.
__device__ __forceinline__ void epilogue_tma(const float (&acc)[64], int blk,
                                             unsigned char* stage_tile, const Unit& w,
                                             int t, int wg, const CUtensorMap* map_out,
                                             const CUtensorMap* map_part,
                                             const GemmArgs& g) {
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  warpgroup_sync(wg);
  const bool part = w.slot >= 0, bf16_out = !part && g.ep.out_bf16;
  const bool bias = !part && g.ep.bias != nullptr;
  const int r = (t / 32) * 16 + (t % 32) / 4, cq = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + cq;
    float2 bj = make_float2(0.f, 0.f);
    if (bias && w.n0 + c < g.N) bj = __ldg(reinterpret_cast<const float2*>(g.ep.bias + w.n0 + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (bias) {
        v0 = v0 + bj.x;
        v1 = v1 + bj.y;
      }
      // Box c / 64 (bf16) or c / 32 (fp32), 128-byte rows, the 16-byte chunk
      // index XOR the row's index mod 8.
      if (bf16_out) {
        const int cc = c % 64, off = (c / 64) * kBox + row * 128 +
                                     (((cc / 8) ^ (row % 8)) * 16) + (cc % 8) * 2;
        *reinterpret_cast<uint32_t*>(stage_tile + off) = pack_bf16x2(v0, v1);
      } else {
        const int cc = c % 32, off = (c / 32) * kBox + row * 128 +
                                     (((cc / 4) ^ (row % 8)) * 16) + (cc % 4) * 4;
        *reinterpret_cast<float2*>(stage_tile + off) = make_float2(v0, v1);
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  if (t == 0) {
    const uint32_t src = smem_u32(stage_tile);
    if (part) {
      const int row0 = w.slot * kBM + blk * 64;
#pragma unroll
      for (int box = 0; box < 4; ++box) tma_store(map_part, src + box * kBox, box * 32, row0);
    } else if (bf16_out) {
#pragma unroll
      for (int box = 0; box < 2; ++box)
        tma_store(map_out, src + box * kBox, w.n0 + box * 64, w.m0 + blk * 64);
    } else {
#pragma unroll
      for (int box = 0; box < 4; ++box)
        tma_store(map_out, src + box * kBox, w.n0 + box * 32, w.m0 + blk * 64);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

template <bool kAMN, bool kBMN>
__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out,
                 const __grid_constant__ CUtensorMap map_part, const GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + kStages * kStageBytes + kEpiBytes;
  const uint32_t empty = full + kStages * 8;
  const uint32_t turns = empty + kStages * 8;
  const int units = g.full + (g.tiles_m * g.tiles_n - g.full) * g.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty + 8 * s, 128);   // every thread of the consuming warpgroup
    }
    mbar_init(turns, 128);  // warpgroup 1 hands warpgroup 0 the ring
    mbar_init(turns + 8, 128);  // and 0 hands it to 1
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full, unit after unit.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, g);
        for (int kt = w.k_begin; kt < w.k_end; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kStageBytes);  // zero-filled boxes count whole
          const uint32_t a = ring + stage * kStageBytes, b = a + kATile;
          const int k0 = kt * kBK;
          if (kAMN) {
            tma_load(a, &map_a, w.m0, k0, bar);
            tma_load(a + kBox, &map_a, w.m0 + 64, k0, bar);
          } else {
            tma_load(a, &map_a, k0, w.m0, bar);
          }
          if (kBMN) {
            tma_load(b, &map_b, w.n0, k0, bar);
            tma_load(b + kBox, &map_b, w.n0 + 64, k0, bar);
          } else {
            tma_load(b, &map_b, k0, w.n0, bar);
          }
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    // Consumer warpgroup wg: this block's units wg, wg + 2, ... in turn.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    // Rows 64..127 of A sit 8 KiB in, in both layouts; a 16-deep step moves
    // 32 bytes along a K-major row, or 16 rows of 128 bytes in an MN-major box.
    constexpr uint32_t kAStep = kAMN ? 2048 : 32, kBStep = kBMN ? 2048 : 32;
    constexpr uint32_t kALbo = kAMN ? kBox : 16, kBLbo = kBMN ? kBox : 16;
    float* stage_tile = reinterpret_cast<float*>(smem + kStages * kStageBytes) +
                        wg * 64 * kEpiPitch;
    int stage = 0;
    uint32_t phase = 0;
    // The turns: a warpgroup starts a unit's products only once the other
    // has waited for every slice of the unit before (the first unit of
    // warpgroup 0 excepted). That keeps each barrier of the ring at most
    // one phase ahead of a waiter, which a parity wait needs, and the two
    // warpgroups' products in turns.
    uint32_t turn_phase = 0;
    bool first = wg == 0;
    int turn = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, turn ^= 1) {
      const Unit w = unit_of(u, g);
      if (turn != wg) {  // the other warpgroup's unit: step over its stages
        const int s = stage + (w.k_end - w.k_begin);
        phase ^= (s / kStages) & 1;
        stage = s % kStages;
        continue;
      }
      if (!first) {
        mbar_wait(turns + 8 * wg, turn_phase);
        turn_phase ^= 1;
      }
      first = false;
      float acc[2][64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
      int prev = -1;
      for (int kt = w.k_begin; kt < w.k_end; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring + stage * kStageBytes;
        const uint32_t b = a + kATile;
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t db = smem_desc(b + kk * kBStep, kBLbo, 1024);
          wgmma_m64n128k16<kAMN, kBMN>(acc[0], smem_desc(a + kk * kAStep, kALbo, 1024), db);
          wgmma_m64n128k16<kAMN, kBMN>(
              acc[1], smem_desc(a + kATile / 2 + kk * kAStep, kALbo, 1024), db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (prev >= 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      mbar_arrive(turns + 8 * (1 - wg));  // the other's turn
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (prev >= 0) mbar_arrive(empty + 8 * prev);
      if (tma_epilogue(w, g)) {
        unsigned char* tile = reinterpret_cast<unsigned char*>(stage_tile);
        epilogue_tma(acc[0], 0, tile, w, t, wg, &map_out, &map_part, g);
        epilogue_tma(acc[1], 1, tile, w, t, wg, &map_out, &map_part, g);
        continue;
      }
      // The staged epilogue, 64 rows (one accumulator) at a time.
      float b[4];
      if (w.n0 + 4 * (t % 32) < g.N) load_bias<4>(b, w.n0 + 4 * (t % 32), g.ep);
      epilogue_rows(acc[0], stage_tile, w, w.m0, t, wg, b, g);
      epilogue_rows(acc[1], stage_tile, w, w.m0 + 64, t, wg, b, g);
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Host side: the launch.
// ---------------------------------------------------------------------------

// The calling thread's device: its SM count, and whether this form's kernel
// may take kSmemBytes yet (both asked once per device).
struct DeviceInfo {
  int sms = 0;
  bool smem_set[4] = {false, false, false, false};
};
inline DeviceInfo* device_info() {
  constexpr int kMaxDevices = 64;
  static DeviceInfo info[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return nullptr;
  DeviceInfo* d = &info[dev];
  if (d->sms == 0 && (d->sms = sm_count()) == 0) return nullptr;
  return d;
}

// out [M, N] = epi(A . B): A is [M, K] row-major, or (kAMN) stored [K, M];
// B is [K, N] with N contiguous (kBMN), or stored [N, K]. With splits > 1
// the tiles from `full` on run in `splits` runs of `chunk` slices each into
// `partial` ([splits][tiles - full][kBM][kBN] fp32, no epilogue), which the
// caller then sums. Every contiguous axis must be a multiple of 8 (16-byte
// TMA row pitches), and N too (the epilogue's 4-column groups).
template <bool kAMN, bool kBMN>
cudaError_t launch_gemm(const void* a, const void* b, int M, int N, int K, int full,
                        int splits, int chunk, float* partial, const Epilogue& ep,
                        cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  DeviceInfo* dev = device_info();
  if (dev == nullptr) return cudaErrorInvalidDevice;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int k_tiles = (K + kBK - 1) / kBK;
  if (splits > 1 && (full < 0 || full >= tiles || chunk <= 0 ||
                     static_cast<long long>(splits - 1) * chunk >= k_tiles ||
                     static_cast<long long>(splits) * chunk < k_tiles || partial == nullptr))
    return cudaErrorInvalidValue;
  // Whole tiles whose epilogue is the bias at most go out by TMA store.
  const bool store_out = ep.residual_kind == kNoResidual && ep.gelu_grad_of == nullptr &&
                         !ep.gelu && ep.out2 == nullptr;
  CUtensorMap map_a, map_b, map_out = {}, map_part = {};
  const bool ok =
      (kAMN ? encode_map(&map_a, encode, a, false, M, K, 64)
            : encode_map(&map_a, encode, a, false, K, M, kBM)) &&
      (kBMN ? encode_map(&map_b, encode, b, false, N, K, 64)
            : encode_map(&map_b, encode, b, false, K, N, kBN)) &&
      (!store_out || encode_map(&map_out, encode, ep.out, !ep.out_bf16, N, M, 64)) &&
      (splits == 1 ||
       encode_map(&map_part, encode, partial, true, kBN,
                  static_cast<long long>(splits) * (tiles - full) * kBM, 64));
  if (!ok) return cudaErrorInvalidValue;
  constexpr int form = (kAMN ? 2 : 0) + (kBMN ? 1 : 0);
  if (!dev->smem_set[form]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_sm90_kernel<kAMN, kBMN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    dev->smem_set[form] = true;
  }
  GemmArgs g;
  g.M = M;
  g.N = N;
  g.tiles_m = (M + kBM - 1) / kBM;
  g.tiles_n = (N + kBN - 1) / kBN;
  g.k_tiles = (K + kBK - 1) / kBK;
  g.full = splits > 1 ? full : tiles;
  g.splits = splits > 1 ? splits : 1;
  g.chunk = splits > 1 ? chunk : g.k_tiles;
  g.partial = partial;
  g.store_out = store_out;
  g.ep = ep;
  const long long units = g.full + static_cast<long long>(tiles - g.full) * g.splits;
  const int grid = static_cast<int>(units < dev->sms ? units : dev->sms);
  gemm_sm90_kernel<kAMN, kBMN><<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_b, map_out,
                                                                       map_part, g);
  return cudaGetLastError();
}

}  // namespace sm90
}  // namespace vit

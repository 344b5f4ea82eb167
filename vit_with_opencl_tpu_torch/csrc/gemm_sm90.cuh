// The GEMM core for Hopper (sm_90a): out[M, N] = epi(A[M, K] . B[K, N]) with
// TMA loads and wgmma, in bf16 (fp32 sums) and in int8 (int32 sums).
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
//     read MN-major; the contraction is the ragged token axis);
//   * the int8-weight matmuls of ops/fused_block.py:_block_kernel (_mm with
//     w8a8=False, :121-125): acc = x . bf16(w_int8) in fp32, then
//     acc * w_scale[n] before the epilogue (kInt8W below);
//   * the W8A8 matmuls of _block_kernel (_mm with w8a8=True, :92-120, and
//     _mm_ctx_masked, :128-152): acc = xq . wq in int32 (exact: 3072 * 127^2
//     < 2^31), then (fp32(acc) * sx[m]) * sw[n] (kW8A8), and with the
//     outlier groups' bf16 side product x_hi . w_hi (its hi_ref split,
//     :104-111, and the masked per-head tails) added after the scales
//     (kW8A8Side).
// The bf16 operand layouts are wgmma's transpose bits (kAMN, kBMN), not
// separate staging code: a K-major operand is one TMA box of 64 x 128 (K
// inner), an MN-major one two boxes of 64 x 64 (MN inner), both with the
// 128-byte swizzle, which the shared-memory descriptors below describe.
// int8 wgmma reads both operands K-major only, so the W8A8 forms take w
// stored K-major ([N, K] rows: models/quant.k_major, done once where the
// weights reach the card) and xq as it comes ([M, K] rows). A 128-deep int8
// slice of either is one TMA box of 128 x 128 bytes: the bf16 form's 64-deep
// slices in bytes, swizzle and descriptors, so the ring, the barriers and
// the persistent grid carry over unchanged.
//
// Bound on the card: operations at the encoder's shapes (K = 768 or 3072
// against M = B*197 rows, far above ~295 bf16 and ~590 int8 operations per
// byte); bytes for out-proj and fc2 with their fp32 residual and output at
// small K/N (and for the int8 forms, whose products cost half).
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
// wgrad, N or K = 192 at ViT-Ti, K = 672 or K_hi = 96 of the outlier
// groups) and clips them on store; the staged epilogue masks its stores.
// Split-K (the weight gradients, few tiles over many tokens): the first
// `full` tiles (whole waves of SMs) run whole; the rest run in `splits` runs
// of `chunk` slices, each unit storing its fp32 partial tile into a slot of
// `partial`, which gemm_sm90.cu's second kernel sums in a fixed order: no
// atomics, the same bits from run to run.
//
// The int8-weight form (kInt8W) keeps the consumers' products and epilogues
// as the bf16 form's: only the way B reaches the stage's bf16 slot differs.
// The producer's one thread loads each [64 K x 128 N] int8 slice of w by
// TMA (8 KiB, half the bytes of a bf16 slice) into a ring of kI8Stages
// slots of its own, beside the A tile into the stage as before. The
// consuming warpgroup widens each slice, exactly (|q| <= 127), into the
// stage's B slot in the swizzled MN-major layout that the two bf16 TMA boxes
// would have written, fences it for the async proxy and meets at its named
// barrier; it widens slice n + 1 while slice n's products run, so the
// widening takes the issue slots it would spend waiting. (Measured slower
// on the card, PERF.md §6: the widening in the producer warpgroup, at its
// 40 registers, and the consumers loading their int8 chunks from global
// memory into registers a slice ahead, which spilled.) The epilogue
// multiplies the accumulator by the column's scale (__fmul_rn, never
// contracted into the bias or residual add that follows) before the bias:
// the plain version's order.
//
// The W8A8 form (kW8A8) is the bf16 form with m64n128k32 s8 products into
// int32 accumulators (the same 2 x 64 registers a tile); before the
// epilogue each sum becomes fp32 (__int2float_rn) times its row's and then
// its column's scale (__fmul_rn each). The side form (kW8A8Side) needs a
// second accumulator for the bf16 side product, 64 int32 + 64 fp32 for a
// 64-row half tile, so its two consumer warpgroups share each tile, 64 rows
// each (no turns): the unit's int8 slices, then its 64-deep bf16 slices of
// x_hi (K-major) and w_hi (MN-major, two boxes) through the same ring, each
// into its own accumulator; the side sum is added after the scales, as the
// plain version's acc * sx * sw + hi.
#pragma once

#include <type_traits>

#include "epilogue.cuh"
#include "sm90.cuh"

namespace vit {
namespace sm90 {

// The core's forms: bf16 operands (every layout), the int8 weight widened
// to bf16, W8A8, and W8A8 with the bf16 side product.
enum Form : int { kBf16 = 0, kInt8W = 1, kW8A8 = 2, kW8A8Side = 3 };

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kBK8 = 128;  // the int8 forms' slices: 128 bytes deep, as kBK's
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
// The int8-weight form: a ring of int8 w slices (1024-byte aligned: the
// staging tiles end on a multiple of 1024) before the barriers, and its full
// and empty barriers after them. Two slots or three fit beside the bf16
// form's 197 KiB; four would not (ops/linear.py int8w_kernel_smem_bytes).
constexpr int kI8Stages = 3;
constexpr int kI8Tile = kBK * kBN;  // [64 K, 128 N] int8: 8 KiB
constexpr int kSmemBytesI8 = kSmemBytes + kI8Stages * kI8Tile + 2 * kI8Stages * 8;
static_assert((kStages * kStageBytes + kEpiBytes) % 1024 == 0,
              "the int8 ring's slots must be 1024-byte aligned for the swizzle");

struct GemmArgs {
  int M, N;
  int tiles_m, tiles_n;
  int k_tiles;      // 64-deep slices of K
  int full;         // tiles 0..full-1 run whole, with the epilogue
  int splits;       // the other tiles run in `splits` runs of `chunk` slices
  int chunk;
  float* partial;   // their fp32 slots [splits][tiles - full][kBM][kBN]
  int store_out;    // whole tiles' epilogue: the bias at most, TMA stores
  const float* col_scale;  // the int8 forms' [N] scale, else null
  const float* row_scale;  // the W8A8 forms' [M] scale, else null
  int hi_tiles;            // the side form: 64-deep bf16 slices after the int8 ones
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
// b: the bias of the thread's columns. kScale: the int8-weight form's
// column scales multiply the products first.
template <bool kScale>
__device__ __forceinline__ void epilogue_rows(const float (&acc)[64], float* stage_tile,
                                              const Unit& w, int m0, int t, int wg,
                                              const float (&b)[4], const GemmArgs& g) {
  constexpr int kRows = 4;  // a batch
  const int c = 4 * (t % 32), gn = w.n0 + c;
  const bool col_ok = gn < g.N;  // N % 8 == 0: 4 columns all in or all out
  float sc[4];
  if (kScale && col_ok) load_f32<4>(sc, g.col_scale + gn);
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
      if constexpr (kScale) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][e] = __fmul_rn(v[i][e], sc[e]);
      }
    }
    apply_rows<kRows, 4>(v, x, b, gm, ok, gn, g.N, g.ep);
  }
  warpgroup_sync(wg);  // the staging tile is rewritten next
}

// The W8A8 forms' fp32 products of rows m0..m0+63 of a tile at column n0,
// from the int32 sums in acc (wgmma's accumulator layout, see
// epilogue_rows): (fp32(acc) * sx[m]) * sw[n], each step rounded once
// (__fmul_rn is never contracted), the plain version's order; then, with a
// side accumulator, + side (__fadd_rn). Rows past M and columns past N
// read no scale (the epilogues store nothing there).
__device__ __forceinline__ void w8a8_products(float (&v)[64], const int32_t (&acc)[64],
                                              int m0, int n0, int t, const GemmArgs& g) {
  const int r = (t / 32) * 16 + (t % 32) / 4, cq = 2 * (t % 4);
  float sx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + r + 8 * h;
    sx[h] = gm < g.M ? __ldg(g.row_scale + gm) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int gn = n0 + 8 * j + cq;  // even, and N % 8 == 0: both columns in or out
    const float2 sw = gn < g.N ? __ldg(reinterpret_cast<const float2*>(g.col_scale + gn))
                               : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      v[i] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), sx[h]), sw.x);
      v[i + 1] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i + 1]), sx[h]), sw.y);
    }
  }
}

__device__ __forceinline__ void w8a8_products(float (&v)[64], const int32_t (&acc)[64],
                                              const float (&side)[64], int m0, int n0,
                                              int t, const GemmArgs& g) {
  w8a8_products(v, acc, m0, n0, t, g);
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] = __fadd_rn(v[i], side[i]);
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
// the warpgroup meets. kScale: the int8-weight form's column scales multiply
// the products before the bias.
template <bool kScale>
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
    float2 bj = make_float2(0.f, 0.f), sj = make_float2(1.f, 1.f);
    if (bias && w.n0 + c < g.N) bj = __ldg(reinterpret_cast<const float2*>(g.ep.bias + w.n0 + c));
    if (kScale && w.n0 + c < g.N)
      sj = __ldg(reinterpret_cast<const float2*>(g.col_scale + w.n0 + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (kScale) {
        v0 = __fmul_rn(v0, sj.x);
        v1 = __fmul_rn(v1, sj.y);
      }
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

// Four int8 values (a word) as four bf16 values, exactly (two words, in
// order): the byte q + 128 under the fp32 exponent of 2^23 is 2^23 + q +
// 128, less 2^23 + 128 is q, and q's top 16 bits are bf16(q) (|q| <= 128
// needs 8 significant bits).
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Thread t (0..127) of a warpgroup widens the 16-byte chunks t, t + 128, ...
// of an int8 slice (64 K rows of 128 N bytes, TMA's 128-byte swizzle: chunk j
// of row r at r * 128 + (j ^ r % 8) * 16) into a stage's bf16 B slot, laid
// out as the two 64 x 64 MN-major TMA boxes of a bf16 w would be (box n /
// 64, row r, 16-byte chunk (n % 64) / 8 at (chunk ^ r % 8) * 16). A
// quarter-warp widens one row; its box-1 threads store their odd chunk
// first, so that each store's 8 chunks fall in 8 distinct bank groups.
__device__ __forceinline__ void widen_slice(const unsigned char* src, unsigned char* dst,
                                            int t) {
  const int j = t % 8, box = j / 4, cj = 2 * (j % 4);
  const bool odd_first = box == 1;
#pragma unroll
  for (int i = 0; i < kI8Tile / 16 / 128; ++i) {
    const int r = t / 8 + 16 * i, sw = r % 8;
    const uint4 q = *reinterpret_cast<const uint4*>(src + r * 128 + ((j ^ sw) * 16));
    uint4 a, b;  // bf16 columns 16j..16j+7, 16j+8..16j+15
    widen4(q.x, a.x, a.y);
    widen4(q.y, a.z, a.w);
    widen4(q.z, b.x, b.y);
    widen4(q.w, b.z, b.w);
    unsigned char* row = dst + box * kBox + r * 128;
    const int c0 = odd_first ? cj + 1 : cj, c1 = odd_first ? cj : cj + 1;
    *reinterpret_cast<uint4*>(row + ((c0 ^ sw) * 16)) = odd_first ? b : a;
    *reinterpret_cast<uint4*>(row + ((c1 ^ sw) * 16)) = odd_first ? a : b;
  }
}

// The W8A8 forms' staged epilogue of rows blk*64..+63 of unit w from their
// fp32 products v, by warpgroup wg, with the bias of the thread's columns.
__device__ __forceinline__ void staged_rows(const float (&v)[64], int blk, const Unit& w,
                                            float* stage_tile, int t, int wg,
                                            const GemmArgs& g) {
  float b[4];
  if (w.n0 + 4 * (t % 32) < g.N) load_bias<4>(b, w.n0 + 4 * (t % 32), g.ep);
  epilogue_rows<false>(v, stage_tile, w, w.m0 + 64 * blk, t, wg, b, g);
}

// Form kForm of the core; kAMN / kBMN: A / B is read MN-major (the bf16
// form; the others read A K-major). kInt8W: B is an int8 w [K, N] (kBMN's
// layout), map_b its int8 map of [64 K, 128 N] boxes, widened by the
// consumers (the note at the top); the epilogue scales by g.col_scale.
// kW8A8, kW8A8Side: map_a and map_b are xq's and the K-major w's maps of
// 128 x 128 int8 boxes; the side form's map_ahi and map_bhi are x_hi's (64
// x 128 boxes, K-major) and w_hi's (two 64 x 64 boxes a slice, MN-major).
template <bool kAMN, bool kBMN, int kForm>
__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out,
                 const __grid_constant__ CUtensorMap map_part,
                 const __grid_constant__ CUtensorMap map_ahi,
                 const __grid_constant__ CUtensorMap map_bhi, const GemmArgs g) {
  constexpr bool kI8 = kForm == kInt8W;
  constexpr bool kW8 = kForm == kW8A8 || kForm == kW8A8Side;
  constexpr bool kSide = kForm == kW8A8Side;
  static_assert(!kI8 || (!kAMN && kBMN), "the int8 weight is the forward's B");
  static_assert(!kW8 || (!kAMN && !kBMN), "int8 wgmma reads K-major operands");
  constexpr int kDepth = kW8 ? kBK8 : kBK;  // elements a slice
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  const uint32_t ring8 = ring + kStages * kStageBytes + kEpiBytes;  // kI8's int8 slices
  const uint32_t full = ring8 + (kI8 ? kI8Stages * kI8Tile : 0);
  const uint32_t empty = full + kStages * 8;
  const uint32_t turns = empty + kStages * 8;
  const uint32_t full8 = turns + 16, empty8 = full8 + kI8Stages * 8;  // kI8 only
  const int units = g.full + (g.tiles_m * g.tiles_n - g.full) * g.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's expect_tx
      // Every thread of the consuming warpgroup (the side form: of both).
      mbar_init(empty + 8 * s, kSide ? 256 : 128);
    }
    mbar_init(turns, 128);  // warpgroup 1 hands warpgroup 0 the ring
    mbar_init(turns + 8, 128);  // and 0 hands it to 1
    if (kI8)
      for (int s = 0; s < kI8Stages; ++s) {
        mbar_init(full8 + 8 * s, 1);
        mbar_init(empty8 + 8 * s, 1);  // the widening warpgroup, once it has met
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full, unit after unit.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (kI8) {
      // The int8 form never splits K: slice n of this block is slice n %
      // k_tiles of its unit n / k_tiles, and takes stage n % kStages and
      // int8 slot n % kI8Stages.
      if (threadIdx.x == 0) {
        const int k_tiles = g.k_tiles;
        const int slices = (units - blockIdx.x + gridDim.x - 1) / gridDim.x * k_tiles;
        for (int n = 0; n < slices; ++n) {
          const int stage = n % kStages, slot = n % kI8Stages;
          const int tile = blockIdx.x + n / k_tiles * gridDim.x, k0 = n % k_tiles * kBK;
          mbar_wait(empty + 8 * stage, ((n / kStages) & 1) ^ 1);  // the first round passes
          mbar_expect_tx(full + 8 * stage, kATile);  // zero-filled boxes count whole
          tma_load(ring + stage * kStageBytes, &map_a, k0, tile / g.tiles_n * kBM,
                   full + 8 * stage);
          mbar_wait(empty8 + 8 * slot, ((n / kI8Stages) & 1) ^ 1);
          mbar_expect_tx(full8 + 8 * slot, kI8Tile);
          tma_load(ring8 + slot * kI8Tile, &map_b, tile % g.tiles_n * kBN, k0, full8 + 8 * slot);
        }
      }
    } else if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, g);
        // The side form: the unit's bf16 slices follow its int8 ones.
        const int k_end = w.k_end + (kSide ? g.hi_tiles : 0);
        for (int kt = w.k_begin; kt < k_end; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kStageBytes);  // zero-filled boxes count whole
          const uint32_t a = ring + stage * kStageBytes, b = a + kATile;
          if (kSide && kt >= w.k_end) {
            const int k0 = (kt - w.k_end) * kBK;
            tma_load(a, &map_ahi, k0, w.m0, bar);
            tma_load(b, &map_bhi, w.n0, k0, bar);
            tma_load(b + kBox, &map_bhi, w.n0 + 64, k0, bar);
          } else {
            const int k0 = kt * kDepth;
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
          }
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    // Rows 64..127 of A sit 8 KiB in, in both layouts; a 16-deep bf16 step
    // (a 32-deep int8 one) moves 32 bytes along a K-major row, or 16 rows of
    // 128 bytes in an MN-major box.
    constexpr uint32_t kAStep = kAMN ? 2048 : 32, kBStep = kBMN ? 2048 : 32;
    constexpr uint32_t kALbo = kAMN ? kBox : 16, kBLbo = kBMN ? kBox : 16;
    float* stage_tile = reinterpret_cast<float*>(smem + kStages * kStageBytes) +
                        wg * 64 * kEpiPitch;
    int stage = 0;
    uint32_t phase = 0;
    if constexpr (kSide) {
      // The side form: both warpgroups on every unit, warpgroup wg on rows
      // 64wg..64wg+63; the int8 slices into acc, then the bf16 ones (x_hi
      // K-major, w_hi MN-major) into side.
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, g);
        int32_t acc[64];
        float side[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          acc[i] = 0;
          side[i] = 0.f;
        }
        const int k8 = w.k_end - w.k_begin, slices = k8 + g.hi_tiles;
        int prev = -1;
        for (int s = 0; s < slices; ++s) {
          mbar_wait(full + 8 * stage, phase);
          const uint32_t a = ring + stage * kStageBytes + wg * (kATile / 2);
          const uint32_t b = ring + stage * kStageBytes + kATile;
          fence_acc(acc);
          fence_acc(side);
          wgmma_fence();
          if (s < k8) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_m64n128k32_s8(acc, smem_desc(a + kk * 32, 16, 1024),
                                  smem_desc(b + kk * 32, 16, 1024));
          } else {
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
              wgmma_m64n128k16<false, true>(side, smem_desc(a + kk * 32, 16, 1024),
                                            smem_desc(b + kk * 2048, kBox, 1024));
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous slice's products are done
          fence_acc(acc);
          fence_acc(side);
          if (prev >= 0) mbar_arrive(empty + 8 * prev);
          prev = stage;
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        fence_acc(side);
        if (prev >= 0) mbar_arrive(empty + 8 * prev);
        float v[64];
        w8a8_products(v, acc, side, w.m0 + 64 * wg, w.n0, t, g);
        if (tma_epilogue(w, g))
          epilogue_tma<false>(v, wg, reinterpret_cast<unsigned char*>(stage_tile), w, t, wg,
                              &map_out, &map_part, g);
        else
          staged_rows(v, wg, w, stage_tile, t, wg, g);
      }
    } else {
      // Consumer warpgroup wg: this block's units wg, wg + 2, ... in turn.
      using Acc = std::conditional_t<kW8, int32_t, float>;
      // The turns: a warpgroup starts a unit's products only once the other
      // has waited for every slice of the unit before (the first unit of
      // warpgroup 0 excepted). That keeps each barrier of the ring at most
      // one phase ahead of a waiter, which a parity wait needs, and the two
      // warpgroups' products in turns.
      uint32_t turn_phase = 0;
      bool first = wg == 0;
      int turn = 0;
      // kI8: the block's slices so far (slice n8's int8 slot n8 % kI8Stages),
      // and the widening of one into the B slot of stage st (in phase ph).
      int n8 = 0;
      auto widen = [&](int st, uint32_t ph) {
        const int slot = n8 % kI8Stages;
        mbar_wait(full + 8 * st, ph);  // the stage's earlier products are done
        mbar_wait(full8 + 8 * slot, (n8 / kI8Stages) & 1);
        widen_slice(smem + (ring8 - ring) + slot * kI8Tile, smem + st * kStageBytes + kATile, t);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warpgroup_sync(wg);
        if (t == 0) mbar_arrive(empty8 + 8 * slot);
        ++n8;
      };
      for (int u = blockIdx.x; u < units; u += gridDim.x, turn ^= 1) {
        const Unit w = unit_of(u, g);
        if (turn != wg) {  // the other warpgroup's unit: step over its stages
          const int s = stage + (w.k_end - w.k_begin);
          phase ^= (s / kStages) & 1;
          stage = s % kStages;
          n8 += w.k_end - w.k_begin;
          continue;
        }
        if (!first) {
          mbar_wait(turns + 8 * wg, turn_phase);
          turn_phase ^= 1;
        }
        first = false;
        Acc acc[2][64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;
        int prev = -1;
        if constexpr (kI8) widen(stage, phase);
        for (int kt = w.k_begin; kt < w.k_end; ++kt) {
          mbar_wait(full + 8 * stage, phase);
          const uint32_t a = ring + stage * kStageBytes;
          const uint32_t b = a + kATile;
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t db = smem_desc(b + kk * kBStep, kBLbo, 1024);
            const uint64_t da0 = smem_desc(a + kk * kAStep, kALbo, 1024);
            const uint64_t da1 = smem_desc(a + kATile / 2 + kk * kAStep, kALbo, 1024);
            if constexpr (kW8) {
              wgmma_m64n128k32_s8(acc[0], da0, db);
              wgmma_m64n128k32_s8(acc[1], da1, db);
            } else {
              wgmma_m64n128k16<kAMN, kBMN>(acc[0], da0, db);
              wgmma_m64n128k16<kAMN, kBMN>(acc[1], da1, db);
            }
          }
          wgmma_commit();
          if constexpr (kI8) {  // the next slice's B, under this slice's products
            if (kt + 1 < w.k_end)
              widen(stage + 1 == kStages ? 0 : stage + 1, stage + 1 == kStages ? phase ^ 1 : phase);
          }
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
        // The epilogue, 64 rows (one accumulator) at a time: by TMA store
        // where the unit takes it, else staged.
        unsigned char* tile = reinterpret_cast<unsigned char*>(stage_tile);
        const bool by_tma = tma_epilogue(w, g);
        if constexpr (kW8) {
          float v[64];
          w8a8_products(v, acc[0], w.m0, w.n0, t, g);
          if (by_tma)
            epilogue_tma<false>(v, 0, tile, w, t, wg, &map_out, &map_part, g);
          else
            staged_rows(v, 0, w, stage_tile, t, wg, g);
          w8a8_products(v, acc[1], w.m0 + 64, w.n0, t, g);
          if (by_tma)
            epilogue_tma<false>(v, 1, tile, w, t, wg, &map_out, &map_part, g);
          else
            staged_rows(v, 1, w, stage_tile, t, wg, g);
        } else if (by_tma) {
          epilogue_tma<kI8>(acc[0], 0, tile, w, t, wg, &map_out, &map_part, g);
          epilogue_tma<kI8>(acc[1], 1, tile, w, t, wg, &map_out, &map_part, g);
        } else {
          float b[4];
          if (w.n0 + 4 * (t % 32) < g.N) load_bias<4>(b, w.n0 + 4 * (t % 32), g.ep);
          epilogue_rows<kI8>(acc[0], stage_tile, w, w.m0, t, wg, b, g);
          epilogue_rows<kI8>(acc[1], stage_tile, w, w.m0 + 64, t, wg, b, g);
        }
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Host side: the launches.
// ---------------------------------------------------------------------------

// The calling thread's device: its SM count, and whether each form's kernel
// may take its shared memory yet (both asked once per device).
struct DeviceInfo {
  int sms = 0;
  bool smem_set[8] = {};
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

// Whole tiles whose epilogue is the bias at most go out by TMA store.
inline bool stores_by_tma(const Epilogue& ep) {
  return ep.residual_kind == kNoResidual && ep.gelu_grad_of == nullptr && !ep.gelu &&
         ep.out2 == nullptr;
}

// Launch form (kAMN, kBMN, kForm) over g's units, a block an SM at most.
template <bool kAMN, bool kBMN, int kForm>
cudaError_t run_gemm(DeviceInfo* dev, const CUtensorMap& map_a, const CUtensorMap& map_b,
                     const CUtensorMap& map_out, const CUtensorMap& map_part,
                     const CUtensorMap& map_ahi, const CUtensorMap& map_bhi, const GemmArgs& g,
                     cudaStream_t stream) {
  constexpr int form = kForm == kBf16 ? (kAMN ? 2 : 0) + (kBMN ? 1 : 0) : 3 + kForm;
  constexpr int smem = kForm == kInt8W ? kSmemBytesI8 : kSmemBytes;
  if (!dev->smem_set[form]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_sm90_kernel<kAMN, kBMN, kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    dev->smem_set[form] = true;
  }
  const long long units =
      g.full + static_cast<long long>(g.tiles_m * g.tiles_n - g.full) * g.splits;
  const int grid = static_cast<int>(units < dev->sms ? units : dev->sms);
  gemm_sm90_kernel<kAMN, kBMN, kForm><<<grid, kThreads, smem, stream>>>(
      map_a, map_b, map_out, map_part, map_ahi, map_bhi, g);
  return cudaGetLastError();
}

// out [M, N] = epi(A . B): A is [M, K] row-major, or (kAMN) stored [K, M];
// B is [K, N] with N contiguous (kBMN), or stored [N, K]. With splits > 1
// the tiles from `full` on run in `splits` runs of `chunk` slices each into
// `partial` ([splits][tiles - full][kBM][kBN] fp32, no epilogue), which the
// caller then sums. Every contiguous axis must be a multiple of 8 (16-byte
// TMA row pitches), and N too (the epilogue's 4-column groups). kI8: B is
// an int8 w [K, N] (kBMN, no split; N a multiple of 16), col_scale its [N]
// fp32 scale.
template <bool kAMN, bool kBMN, bool kI8 = false>
cudaError_t launch_gemm(const void* a, const void* b, int M, int N, int K, int full,
                        int splits, int chunk, float* partial, const Epilogue& ep,
                        cudaStream_t stream, const float* col_scale = nullptr) {
  static_assert(!kI8 || (!kAMN && kBMN), "the int8 weight is the forward's B");
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  DeviceInfo* dev = device_info();
  if (dev == nullptr) return cudaErrorInvalidDevice;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int k_tiles = (K + kBK - 1) / kBK;
  if (kI8 && (splits > 1 || col_scale == nullptr || N % 16 != 0)) return cudaErrorInvalidValue;
  if (splits > 1 && (full < 0 || full >= tiles || chunk <= 0 ||
                     static_cast<long long>(splits - 1) * chunk >= k_tiles ||
                     static_cast<long long>(splits) * chunk < k_tiles || partial == nullptr))
    return cudaErrorInvalidValue;
  const bool store_out = stores_by_tma(ep);
  CUtensorMap map_a, map_b, map_out = {}, map_part = {}, none = {};
  const bool ok =
      (kAMN ? encode_map(&map_a, encode, a, 2, M, K, 64)
            : encode_map(&map_a, encode, a, 2, K, M, kBM)) &&
      (kI8    ? encode_map(&map_b, encode, b, 1, N, K, kBK)  // [64 K, 128 N] int8
       : kBMN ? encode_map(&map_b, encode, b, 2, N, K, 64)
              : encode_map(&map_b, encode, b, 2, K, N, kBN)) &&
      (!store_out || encode_map(&map_out, encode, ep.out, ep.out_bf16 ? 2 : 4, N, M, 64)) &&
      (splits == 1 ||
       encode_map(&map_part, encode, partial, 4, kBN,
                  static_cast<long long>(splits) * (tiles - full) * kBM, 64));
  if (!ok) return cudaErrorInvalidValue;
  GemmArgs g{};
  g.M = M;
  g.N = N;
  g.tiles_m = (M + kBM - 1) / kBM;
  g.tiles_n = (N + kBN - 1) / kBN;
  g.k_tiles = k_tiles;
  g.full = splits > 1 ? full : tiles;
  g.splits = splits > 1 ? splits : 1;
  g.chunk = splits > 1 ? chunk : k_tiles;
  g.partial = partial;
  g.store_out = store_out;
  g.col_scale = col_scale;
  g.ep = ep;
  return run_gemm<kAMN, kBMN, kI8 ? kInt8W : kBf16>(dev, map_a, map_b, map_out, map_part,
                                                    none, none, g, stream);
}

// out [M, N] = epi((fp32(xq . w) * sx[m]) * sw[n] [+ x_hi . w_hi]): xq [M, K]
// int8 row-major with its [M] scale sx; w [K, N] int8 stored K-major (N rows
// of K bytes, ldw bytes apart) with its [N] scale sw; with x_hi [M, K_hi]
// and w_hi [K_hi, N] bf16 row-major (x_hi null: no side product). K, ldw
// and N multiples of 16, K_hi of 8 (16-byte TMA row pitches); the caller
// checks them.
inline cudaError_t launch_w8a8(const void* xq, const float* sx, const void* w, int ldw,
                               const float* sw, const void* x_hi, const void* w_hi,
                               int K_hi, int M, int N, int K, const Epilogue& ep,
                               cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  DeviceInfo* dev = device_info();
  if (dev == nullptr) return cudaErrorInvalidDevice;
  const bool side = x_hi != nullptr, store_out = stores_by_tma(ep);
  CUtensorMap map_a, map_b, map_out = {}, map_ahi = {}, map_bhi = {}, none = {};
  const bool ok =
      encode_map(&map_a, encode, xq, 1, K, M, kBM) &&
      encode_map(&map_b, encode, w, 1, K, N, kBN, ldw) &&
      (!store_out || encode_map(&map_out, encode, ep.out, ep.out_bf16 ? 2 : 4, N, M, 64)) &&
      (!side || (encode_map(&map_ahi, encode, x_hi, 2, K_hi, M, kBM) &&
                 encode_map(&map_bhi, encode, w_hi, 2, N, K_hi, 64)));
  if (!ok) return cudaErrorInvalidValue;
  GemmArgs g{};
  g.M = M;
  g.N = N;
  g.tiles_m = (M + kBM - 1) / kBM;
  g.tiles_n = (N + kBN - 1) / kBN;
  g.k_tiles = (K + kBK8 - 1) / kBK8;
  g.full = g.tiles_m * g.tiles_n;
  g.splits = 1;
  g.chunk = g.k_tiles;
  g.store_out = store_out;
  g.col_scale = sw;
  g.row_scale = sx;
  g.hi_tiles = side ? (K_hi + kBK - 1) / kBK : 0;
  g.ep = ep;
  return side ? run_gemm<false, false, kW8A8Side>(dev, map_a, map_b, map_out, none, map_ahi,
                                                  map_bhi, g, stream)
              : run_gemm<false, false, kW8A8>(dev, map_a, map_b, map_out, none, none, none, g,
                                              stream);
}

}  // namespace sm90
}  // namespace vit

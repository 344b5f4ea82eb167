// Tile helpers of the attention kernels that stream their K/V or q/dO
// tiles (attention_bwd.cu, attention_flash.cu, attention_single.cu):
// mma.sync m16n8k16 (bf16 in, fp32 out) on fragments in registers, cp.async
// copies of row-major tiles into a shared-memory ring (rows padded to
// HDP + 8 against bank conflicts), ldmatrix.trans reads of a tile as the B
// operand of a product that contracts over its rows, and strided [B, H, T,
// hd] views of q, k, v and the output. A block is 4 warps; each warp owns
// 16 rows (queries or keys) of the block's 64. HDP is the head dim padded
// to a multiple of 16.
#pragma once

#include <float.h>

#include "common.cuh"

namespace vit {
namespace tiles {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // a block's own queries or keys
constexpr int kStages = 2;          // a ring: one tile in use, one loading
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void quad_max(float& v) {  // the 4 lanes of a row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ void quad_sum(float& v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values times `s`, rounded to bf16 again (q_scale applied to q).
__device__ __forceinline__ uint32_t scale2(uint32_t v, float s) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16x2(__bfloat162float(h.x) * s, __bfloat162float(h.y) * s);
}

// Four 8x8 bf16 matrices from shared memory, transposed: lanes 8i..8i+7
// give the row addresses of matrix i, and register i of lane (g, t) holds
// its elements [2t][g] and [2t + 1][g] (mma.sync's B fragment).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [r0, r0 + ROWS) x columns [off, off + hd) of a
// row-major bf16 matrix (row pitch `pitch`) into a tile of pitch HDP + 8;
// rows past T and columns past hd are filled with zeros.
template <int HDP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int pitch,
                                          int off, int r0, int T, int hd) {
  constexpr int kChunks = HDP / 8;  // 16 bytes each
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r0 + r < T && c < hd;
    const bf16* src = ok ? base + static_cast<size_t>(r0 + r) * pitch + off + c : base;
    cp_async16(dst + r * (HDP + 8) + c, src, ok);
  }
}

// c = A . B^T over the head dim for this warp's 16 rows (A fragments `a`)
// and the 8 rows [8 * sub, 8 * sub + 8) of the tile `rows` (pitch HDP + 8),
// those rounded to bf16 after a multiply by `scale` if kScale: c[0..1] are
// row g, columns 2t and 2t+1; c[2..3] row g + 8.
template <int HDP, bool kScale>
__device__ __forceinline__ void dot_tile(float c[4], const uint32_t (&a)[HDP / 16][4],
                                         const bf16* rows, int sub, float scale,
                                         int g, int t) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const bf16* r = rows + (sub * 8 + g) * (HDP + 8) + 2 * t;
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s) {
    uint32_t b0 = ld32(r + s * 16), b1 = ld32(r + s * 16 + 8);
    if (kScale) {
      b0 = scale2(b0, scale);
      b1 = scale2(b1, scale);
    }
    mma_16816(c, a[s], b0, b1);
  }
}

// acc[d] += A . M for rows [16 * chunk, 16 * chunk + 16) of the row-major
// tile M (pitch HDP + 8), the contraction, where A (this warp's 16 rows) is
// `a` in the A layout. acc[d] holds columns [8d, 8d + 8) of the result.
template <int HDP>
__device__ __forceinline__ void accumulate(float (&acc)[HDP / 8][4],
                                           const uint32_t (&a)[4], const bf16* m,
                                           int chunk, int lane) {
  // Lane l addresses row l % 8 of matrix l / 8: matrices 0 and 1 are rows
  // [16 chunk, +8) and [+8, +16) of columns [16p, 16p + 8), matrices 2 and 3
  // the same rows of columns [16p + 8, 16p + 16).
  const bf16* base = m + (chunk * 16 + (lane & 15)) * (HDP + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int p = 0; p < HDP / 16; ++p) {
    uint32_t b[4];
    ldsm_x4_trans(b, base + p * 16);
    mma_16816(acc[2 * p], a, b[0], b[1]);
    mma_16816(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// A fragments of 16 rows [r0, r0 + 16) x HDP columns of a row-major bf16
// matrix (row pitch `pitch`, column offset `off`), optionally scaled and
// rounded to bf16 again; rows past T and columns past hd are zero.
template <int HDP>
__device__ __forceinline__ void load_a(uint32_t (&a)[HDP / 16][4], const bf16* base,
                                       int pitch, int off, int r0, int T, int hd,
                                       float scale, int g, int t) {
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int row = r0 + g + (reg & 1) * 8;
      const int col = s * 16 + 2 * t + (reg >> 1) * 8;
      float lo = 0.f, hi = 0.f;
      if (row < T && col < hd) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            base + static_cast<size_t>(row) * pitch + off + col);
        lo = __bfloat162float(v.x) * scale;
        hi = __bfloat162float(v.y) * scale;
      }
      a[s][reg] = pack_bf16x2(lo, hi);
    }
  }
}

template <typename TOut>
__device__ __forceinline__ void store2(TOut* p, float lo, float hi);
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(lo, hi);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// The [16, hd] result of a warp (accumulator layout) into rows r0.. of a
// [B, T, 3D] output at column offset `off`.
template <int HDP, typename TOut>
__device__ __forceinline__ void store_rows(TOut* img, int pitch, int off,
                                           const float (&acc)[HDP / 8][4], int r0,
                                           int T, int hd, int g, int t) {
  const int row0 = r0 + g, row1 = r0 + g + 8;
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (col >= hd) continue;
    if (row0 < T)
      store2<TOut>(img + static_cast<size_t>(row0) * pitch + off + col, acc[d][0],
                   acc[d][1]);
    if (row1 < T)
      store2<TOut>(img + static_cast<size_t>(row1) * pitch + off + col, acc[d][2],
                   acc[d][3]);
  }
}

template <int HDP, int ROWS>
__host__ __device__ constexpr int tile_elems() {
  return ROWS * (HDP + 8);
}

// Element strides (image, head, row) of a [B, H, T, hd] view whose last
// axis is contiguous: split-head tensors, their permuted views of a [B, T,
// 3D] GEMM output, or a head's columns of the packed slabs.
struct Strides {
  long long batch, head, row;
};
struct HeadViews {
  Strides q, k, v, o;
};

// Views from the 12 strides q, k, v, o (batch, head, row each) in order.
__host__ inline HeadViews head_views(const long long* s) {
  return HeadViews{{s[0], s[1], s[2]}, {s[3], s[4], s[5]},
                   {s[6], s[7], s[8]}, {s[9], s[10], s[11]}};
}

// The slab-packed qkv [B, T, 3D] and the head-major context [B, T, D] as
// views: q, k and v start at columns 0, D and 2D of each row.
__host__ inline HeadViews slab_views(int T, int num_heads, int hd) {
  const long long D = static_cast<long long>(num_heads) * hd;
  return HeadViews{{T * 3 * D, hd, 3 * D}, {T * 3 * D, hd, 3 * D},
                   {T * 3 * D, hd, 3 * D}, {T * D, hd, D}};
}

template <typename T>
__device__ __forceinline__ T* head_base(T* p, Strides s, int b, int h) {
  return p + b * s.batch + h * s.head;
}

}  // namespace tiles
}  // namespace vit

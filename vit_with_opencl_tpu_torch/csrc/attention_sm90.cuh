// What the Hopper attention kernels share: the packed forward and the
// single-pass attention (attention.cu, one body), the blockwise forward
// (attention_flash.cu), the packed backward (attention_bwd.cu) and the ring
// step (attention_ring.cu): the head maps, the tile geometry and its wgmma
// descriptors, the A fragments of a row-major matrix in registers, the
// conversion of a score accumulator into the A operand of the next product,
// the row reductions of the accumulator layout, and the stores of a
// warpgroup's rows.
//
// Tiles. Each image's q, k and v of one head (and dO's) are read by TMA
// from a 4-D map over a [B, H, T, hd] view: the packed [B, T, 3D] buffer as
// 3H heads ({hd, 3H, T, B} innermost first), dO [B, T, D] ({hd, H, T, B}),
// or any strided view of split heads, its outer dimensions ordered by
// stride (contiguous split heads: {hd, T, H, B}). A box of 64 columns by 64
// rows of one head is 128-byte swizzled, and the map's bounds zero-fill the
// columns past hd (the next head's, or past the row) and the rows past T
// (the next image's). A tile is 64 rows by 64 columns (hd <= 64) or two
// such boxes 8 KiB apart (hd <= 128). Read with its rows as M or N and hd
// as the contraction it is a K-major operand; read with its rows as the
// contraction it is an MN-major B operand through wgmma's transpose bit, so
// V, dO, q and K serve both products with no transposing copy.
#pragma once

#include <float.h>

#include "sm90.cuh"

namespace vit {
namespace attn90 {

using namespace sm90;

constexpr int kRows = 64;  // a warpgroup's queries or keys; a tile's rows
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);  // a producer warpgroup first
constexpr int kBox = kRows * 64 * 2;               // 8 KiB
constexpr float kMaskValue = -0.7f * FLT_MAX;

template <int HDP>
__host__ __device__ constexpr int boxes() {
  return HDP > 64 ? 2 : 1;
}
template <int HDP>
__host__ __device__ constexpr int tile_bytes() {
  return boxes<HDP>() * kBox;
}

// The dynamic shared memory's base, aligned to 1024 bytes for the swizzle.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// A tile as a K-major operand, 16-deep step kk over hd: 32 bytes along the
// swizzled rows, box kk / 4.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
}
// A tile as an MN-major B operand: step kk over its rows (16 rows of 128
// bytes), hd columns 64j..64j+63.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int j, int kk) {
  return smem_desc(tile + j * kBox + kk * 2048, kBox, 1024);
}

// The 4-D map of `heads` heads of hd columns over a [B, T, heads * hd] bf16
// buffer.
inline bool encode_head_map(CUtensorMap* map, EncodeTiledFn encode, const void* base,
                            int hd, int heads, int T, int B) {
  const long long row = 2LL * hd * heads;
  MapKey key{base, 4, 2, {hd, heads, T, B}, {2LL * hd, row, row * T}, {64, 1, kRows, 1}};
  return encode_map(map, encode, key);
}

// Work unit u: a block's queries (block qb of nqb) of head h of image b; a
// head's units are neighbours, so the blocks running at once share its K/V
// in L2.
struct FwdUnit {
  int b, h, qb;
};
__device__ __forceinline__ FwdUnit fwd_unit(int u, int nqb, int num_heads) {
  const int bh = u / nqb;
  return FwdUnit{bh / num_heads, bh % num_heads, u % nqb};
}

// Where the head, the row and the image of a view's map sit among its
// coordinates 1..3 (coordinate 0 is the column).
struct MapOrder {
  int h, r, b;
};

// A 4-D map of 64-row boxes over a [B, H, T, hd] bf16 view at `base` with
// element strides sb, sh, sr (image, head, row; the columns contiguous,
// every stride a multiple of 8 elements): its outer dimensions ordered by
// stride, a dimension of one element (whose stride is arbitrary) outermost
// with a stride past the view's extent. `order` says where each landed. A
// map is a pure function of these, so it goes through the cache.
inline bool encode_view_map(CUtensorMap* map, MapOrder* order, EncodeTiledFn encode,
                            const void* base, int hd, int B, int H, int T, long long sb,
                            long long sh, long long sr) {
  struct Dim {
    long long size, stride;  // stride in bytes
    int which;               // 0 head, 1 row, 2 image
  };
  Dim d[3] = {{H, 2 * sh, 0}, {T, 2 * sr, 1}, {B, 2 * sb, 2}};
  long long extent = 2LL * hd;
  for (const Dim& x : d)
    if (x.size > 1 && x.stride * x.size > extent) extent = x.stride * x.size;
  for (Dim& x : d)
    if (x.size == 1) x.stride = extent;
  for (int i = 1; i < 3; ++i)  // stable: a size-1 dimension keeps its place among equals
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim tmp = d[j];
      d[j] = d[j - 1];
      d[j - 1] = tmp;
    }
  int* pos[3] = {&order->h, &order->r, &order->b};
  MapKey key{base, 4, 2, {hd, 0, 0, 0}, {0, 0, 0}, {64, 1, 1, 1}};
  for (int i = 0; i < 3; ++i) {
    *pos[d[i].which] = i + 1;
    key.dims[i + 1] = d[i].size;
    key.strides[i] = d[i].stride;
    key.box[i + 1] = d[i].which == 1 ? kRows : 1;
  }
  return encode_map(map, encode, key);
}

// One 64-row box of a view's map: columns col.., head h, rows row.., image b.
__device__ __forceinline__ void tma_load_view(uint32_t dst, const CUtensorMap* map,
                                              MapOrder o, int col, int h, int row, int b,
                                              uint32_t bar) {
  auto at = [&](int i) { return o.h == i ? h : o.r == i ? row : b; };
  tma_load_4d(dst, map, col, at(1), at(2), at(3), bar);
}

// Two bf16 values times `s`, rounded to bf16 again (a scale applied to q).
__device__ __forceinline__ uint32_t scale2(uint32_t v, float s) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16x2(__bfloat162float(h.x) * s, __bfloat162float(h.y) * s);
}

// A fragments (mma.sync's m16n8k16 A layout, wgmma_rs's A operand) of 16
// rows [r0, r0 + 16) x HDP columns of a row-major bf16 matrix (row pitch
// `pitch`, column offset `off`), each value times `scale` and rounded to
// bf16 again; rows past T and columns past hd are zero.
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

// The raw words of load_a's fragments (load_a without the scale):
// rows past T and columns past hd are zero. Loads in flight until used.
template <int HDP>
__device__ __forceinline__ void load_a_raw(uint32_t (&a)[HDP / 16][4], const bf16* base,
                                           int pitch, int off, int r0, int T, int hd, int g,
                                           int t) {
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s)
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int row = r0 + g + (reg & 1) * 8;
      const int col = s * 16 + 2 * t + (reg >> 1) * 8;
      a[s][reg] = row < T && col < hd
                      ? __ldg(reinterpret_cast<const unsigned int*>(
                            base + static_cast<size_t>(row) * pitch + off + col))
                      : 0u;
    }
}

// Columns 16kk..16kk+15 of a 64 x 64 accumulator (c: its 32 registers),
// rounded to bf16, as the A operand of a product that contracts over them.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[32], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16x2(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

// A thread's sums of rows g (c[4j], c[4j+1]) and g + 8 (c[4j+2], c[4j+3])
// of a 64-column accumulator, pairwise: a tree of depth 4, whose fp32
// rounding error is a few ulps where a running sum over a row's chunks
// gathers one per term.
__device__ __forceinline__ void row_sums(const float (&c)[32], float& r0, float& r1) {
  float a[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = c[4 * j] + c[4 * j + 1];
    b[j] = c[4 * j + 2] + c[4 * j + 3];
  }
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) {
      a[j] += a[j + w];
      b[j] += b[j + w];
    }
  r0 = a[0];
  r1 = b[0];
}

// The two consumer warpgroups take turns issuing their products
// (FlashAttention-3's ping-pong): warpgroup wg issues once the other has
// issued its own, so that one's softmax runs under the other's products.
// Named barriers 3 and 4 (both warpgroups' 256 threads); warpgroup 1 hands
// warpgroup 0 the first turn (turns_begin), and warpgroup 0 takes the last
// hand-over (turns_end), so every arrival is waited for.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
}
__device__ __forceinline__ void turns_begin(int wg) {
  if (wg == 1) turn_pass(1);
}
__device__ __forceinline__ void turns_end(int wg) {
  if (wg == 0) turn_wait(0);
}

// The max and the sum over the 4 lanes that hold a row.
__device__ __forceinline__ void quad_max(float& v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ void quad_sum(float& v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
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

// Rows r0 + g and r0 + g + 8 of a warp (accumulator layout, acc[j]: columns
// 64j..64j+63) times (s0, s1), into row-major [T, pitch] at column `off`,
// columns past hd and rows past T left alone.
template <int NB, typename TOut>
__device__ __forceinline__ void store_rows(TOut* img, int pitch, int off,
                                           const float (&acc)[NB][32], float s0, float s1,
                                           int r0, int T, int hd, int g, int t) {
  const int row0 = r0 + g, row1 = r0 + g + 8;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int col = 64 * j + 8 * d + 2 * t;
      if (col >= hd) continue;
      if (row0 < T)
        store2<TOut>(img + static_cast<size_t>(row0) * pitch + off + col,
                            acc[j][4 * d] * s0, acc[j][4 * d + 1] * s0);
      if (row1 < T)
        store2<TOut>(img + static_cast<size_t>(row1) * pitch + off + col,
                            acc[j][4 * d + 2] * s1, acc[j][4 * d + 3] * s1);
    }
}

}  // namespace attn90
}  // namespace vit

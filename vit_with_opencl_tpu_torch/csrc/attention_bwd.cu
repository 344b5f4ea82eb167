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
//   ds = bf16((p * (dp - rowsum(dp * p))) * ds_scale)
//   dq = ds . k,  dk = ds^T . q (the unscaled q),  dv = bf16(p)^T . dO
// dqkv is written in bf16 or in fp32: the fused layer's backward keeps it in
// fp32 for the bias gradient and rounds it for its GEMMs. rowsum(dp * p) is
// taken from the recomputed p, not as FlashAttention's rowsum(dO * O) from
// the forward's rounded output: the two differ by the output's rounding.
//
// Bound on the card: bytes at ViT-B's T = 197 (qkv and dO read, dqkv
// written: 136 MB at B = 64, about 0.04 ms; the products are about a
// quarter of that at the bf16 peak), operations at ViT-L/16@384's T = 577
// (10 T^2 hd a head: 109 GFLOP a layer at B = 32, about 0.11 ms), though
// the recomputation makes this simple form compute-heavy everywhere (22 T^2
// hd a head). Design: two kernels, in FlashAttention-2's split, so that no
// block sums into another's output and the result is the same from run to
// run. Neither holds a whole head: the other side of each product streams
// through a double-buffered ring of 64-row tiles (cp.async), so a block's
// shared memory depends on the head dim only, never on T (at most 71,168 B,
// at hd = 128):
//   dq kernel   one block of 4 warps per (image, head, 64-query tile); each
//               warp owns 16 query rows (q and dO fragments in registers)
//               and walks the key tiles four times, reading K (and, in the
//               last two passes, V) again each pass: the row max, the row
//               sum, the rowsum(dp * p) term, then ds and dq = ds . K
//               accumulated in registers; it writes each row's (m, inv,
//               delta) to a small fp32 buffer;
//   dkv kernel  one block of 4 warps per (image, head, 64-key tile); each
//               warp owns 16 keys (k and v fragments in registers), streams
//               the q and dO tiles with the rows' statistics, rebuilds p^T
//               and dp^T for its keys from the statistics, and accumulates
//               dv = bf16(p)^T . dO and dk = ds^T . q in registers.
// Every tile keeps the keys (or queries) in the order of the resident form
// it replaces, so each sum takes its terms in the same order. Products use
// mma.sync m16n8k16 (bf16 in, fp32 out) with the operand layouts of the
// forward kernel: an accumulator tile rounded to bf16 is the A operand of
// the next product, and ldmatrix.trans reads the B operand of dq, dk and dv
// from a row-major tile. Head dims that are a multiple of 8 are zero-padded
// to the next of the compiled widths (16..128). Not yet used: wgmma, TMA,
// and keeping the scores between passes.
#include <float.h>

#include "common.cuh"

namespace vit {
namespace attn_bwd {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // a block's own queries or keys
constexpr int kTile = 64;           // rows of one streamed tile
constexpr int kStages = 2;          // the ring: one tile in use, one loading
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Start copying rows [r0, r0 + kTile) x columns [off, off + hd) of a
// row-major bf16 matrix (row pitch `pitch`) into a tile of pitch HDP + 8;
// rows past T and columns past hd are filled with zeros.
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int pitch,
                                          int off, int r0, int T, int hd) {
  constexpr int kChunks = HDP / 8;  // 16 bytes each
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
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

template <int HDP>
__host__ __device__ constexpr int tile_elems() {
  return kTile * (HDP + 8);
}

// One ring stage of the dq kernel: a K tile and a V tile.
template <int HDP>
__host__ __device__ constexpr size_t dq_stage_bytes() {
  return 2 * tile_elems<HDP>() * sizeof(bf16);
}
// One ring stage of the dkv kernel: a q tile, a dO tile and their rows'
// (m, inv, delta).
template <int HDP>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  return 2 * tile_elems<HDP>() * sizeof(bf16) + kTile * 3 * sizeof(float);
}

template <int HDP, typename TOut>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                        TOut* __restrict__ dqkv, float* __restrict__ stats, int T,
                        int num_heads, int hd, float q_scale, float ds_scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int D = num_heads * hd, pitch = 3 * D;
  const int Tp = (T + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* img = qkv + static_cast<size_t>(b) * T * pitch;
  const bf16* dimg = dout + static_cast<size_t>(b) * T * D;
  // Step s of the walk is pass s / ntiles over key tile s % ntiles.
  const int ntiles = (T + kTile - 1) / kTile, steps = 4 * ntiles;
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (s % kStages) * dq_stage_bytes<HDP>());
  };
  auto fetch = [&](int s) {  // K, and V in passes 3 and 4
    const int k0 = (s % ntiles) * kTile;
    load_tile<HDP>(stage(s), img, pitch, D + h * hd, k0, T, hd);
    if (s / ntiles >= 2)
      load_tile<HDP>(stage(s) + tile_elems<HDP>(), img, pitch, 2 * D + h * hd, k0, T,
                     hd);
    cp_async_commit();
  };
  fetch(0);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // Warps whose rows lie past T compute on zero rows and store nothing: they
  // must stay for the block's barriers.
  const int r0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;
  uint32_t qa[HDP / 16][4], da[HDP / 16][4];
  load_a<HDP>(qa, img, pitch, h * hd, r0, T, hd, q_scale, g, t);
  load_a<HDP>(da, dimg, D, h * hd, r0, T, hd, 1.f, g, t);

  auto quad_max = [](float& v) {  // the 4 lanes that share a row
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  auto quad_sum = [](float& v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
  };
  float mx0 = -FLT_MAX, mx1 = -FLT_MAX, l0 = 0.f, l1 = 0.f, inv0 = 0.f, inv1 = 0.f;
  float dl0 = 0.f, dl1 = 0.f;
  float dq[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = stage(s);
    const bf16* vs = ks + tile_elems<HDP>();
    const int pass = s / ntiles, k0 = (s % ntiles) * kTile;
    const int nsub = min(kTile, Tp - k0) / 8;  // 8-key sub-tiles up to Tp

    // Scores of keys k0 + [8 * sub, 8 * sub + 8), keys past T masked.
    auto scores = [&](float c[4], int sub) {
      dot_tile<HDP, false>(c, qa, ks, sub, 1.f, g, t);
      const int key = k0 + sub * 8 + 2 * t;
      if (key >= T) c[0] = c[2] = kMaskValue;
      if (key + 1 >= T) c[1] = c[3] = kMaskValue;
    };
    // p and dp of the same keys (V rows past T are zero).
    auto probs = [&](float p[4], float dp[4], int sub) {
      scores(p, sub);
      p[0] = expf(p[0] - mx0) * inv0;
      p[1] = expf(p[1] - mx0) * inv0;
      p[2] = expf(p[2] - mx1) * inv1;
      p[3] = expf(p[3] - mx1) * inv1;
      dot_tile<HDP, false>(dp, da, vs, sub, 1.f, g, t);
    };

    if (pass == 0) {  // the exact row max
      for (int sub = 0; sub < nsub; ++sub) {
        float c[4];
        scores(c, sub);
        mx0 = fmaxf(mx0, fmaxf(c[0], c[1]));
        mx1 = fmaxf(mx1, fmaxf(c[2], c[3]));
      }
    } else if (pass == 1) {  // the row sum of e
      for (int sub = 0; sub < nsub; ++sub) {
        float c[4];
        scores(c, sub);
        l0 += expf(c[0] - mx0) + expf(c[1] - mx0);
        l1 += expf(c[2] - mx1) + expf(c[3] - mx1);
      }
    } else if (pass == 2) {  // delta = rowsum(dp * p)
      for (int sub = 0; sub < nsub; ++sub) {
        float p[4], dp[4];
        probs(p, dp, sub);
        dl0 += dp[0] * p[0] + dp[1] * p[1];
        dl1 += dp[2] * p[2] + dp[3] * p[3];
      }
    } else {  // ds, rounded to bf16 as the A operand of dq += ds . K
      for (int chunk = 0; chunk < nsub / 2; ++chunk) {
        float p0[4], dp0[4], p1[4], dp1[4];
        probs(p0, dp0, 2 * chunk);
        probs(p1, dp1, 2 * chunk + 1);
        const uint32_t dsa[4] = {
            pack_bf16x2((p0[0] * (dp0[0] - dl0)) * ds_scale,
                        (p0[1] * (dp0[1] - dl0)) * ds_scale),
            pack_bf16x2((p0[2] * (dp0[2] - dl1)) * ds_scale,
                        (p0[3] * (dp0[3] - dl1)) * ds_scale),
            pack_bf16x2((p1[0] * (dp1[0] - dl0)) * ds_scale,
                        (p1[1] * (dp1[1] - dl0)) * ds_scale),
            pack_bf16x2((p1[2] * (dp1[2] - dl1)) * ds_scale,
                        (p1[3] * (dp1[3] - dl1)) * ds_scale)};
        accumulate<HDP>(dq, dsa, ks, chunk, lane);
      }
    }
    if (s % ntiles == ntiles - 1) {  // a pass ends: combine the row's lanes
      if (pass == 0) {
        quad_max(mx0);
        quad_max(mx1);
      } else if (pass == 1) {
        quad_sum(l0);
        quad_sum(l1);
        inv0 = 1.f / l0;
        inv1 = 1.f / l1;
      } else if (pass == 2) {
        quad_sum(dl0);
        quad_sum(dl1);
      }
    }
    __syncthreads();  // the stage is refilled two steps on
  }
  store_rows<HDP, TOut>(dqkv + static_cast<size_t>(b) * T * pitch, pitch, h * hd, dq,
                        r0, T, hd, g, t);

  if (t == 0) {  // one lane per row: (max, inv, delta)
    float* st = stats + (static_cast<size_t>(b) * num_heads + h) * T * 3;
    if (r0 + g < T) {
      st[(r0 + g) * 3 + 0] = mx0;
      st[(r0 + g) * 3 + 1] = inv0;
      st[(r0 + g) * 3 + 2] = dl0;
    }
    if (r0 + g + 8 < T) {
      st[(r0 + g + 8) * 3 + 0] = mx1;
      st[(r0 + g + 8) * 3 + 1] = inv1;
      st[(r0 + g + 8) * 3 + 2] = dl1;
    }
  }
}

template <int HDP, typename TOut>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                         const float* __restrict__ stats, TOut* __restrict__ dqkv,
                         int T, int num_heads, int hd, float q_scale, float ds_scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int D = num_heads * hd, pitch = 3 * D;
  const int Tp = (T + 15) & ~15;
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* img = qkv + static_cast<size_t>(b) * T * pitch;
  const bf16* dimg = dout + static_cast<size_t>(b) * T * D;
  const float* gst = stats + (static_cast<size_t>(b) * num_heads + h) * T * 3;
  const int ntiles = (T + kTile - 1) / kTile;  // query tiles
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (s % kStages) * dkv_stage_bytes<HDP>());
  };
  auto fetch = [&](int s) {  // q (unscaled), dO and the rows' statistics
    const int q0 = s * kTile;
    bf16* buf = stage(s);
    load_tile<HDP>(buf, img, pitch, h * hd, q0, T, hd);
    load_tile<HDP>(buf + tile_elems<HDP>(), dimg, D, h * hd, q0, T, hd);
    float* st = reinterpret_cast<float*>(buf + 2 * tile_elems<HDP>());
    for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
      const bool ok = q0 * 3 + i < T * 3;
      cp_async4(st + i, ok ? gst + q0 * 3 + i : gst, ok);
    }
    cp_async_commit();
  };
  fetch(0);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kRows + (threadIdx.x / 32) * 16;  // keys
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
    const bf16* dt = qt + tile_elems<HDP>();
    const float* st = reinterpret_cast<const float*>(qt + 2 * tile_elems<HDP>());
    const int q0 = s * kTile;
    const int nsub = min(kTile, Tp - q0) / 8;
    // p^T and ds^T of this warp's 16 keys against queries q0 + [8 * sub, +8):
    // element e is key row g (e < 2) or g + 8, query 8 * sub + 2t + (e & 1).
    auto grads = [&](float p[4], float ds[4], int sub) {
      float dp[4];
      dot_tile<HDP, true>(p, ka, qt, sub, q_scale, g, t);  // s^T = k . bf16(q * scale)^T
      dot_tile<HDP, false>(dp, va, dt, sub, 1.f, g, t);    // dp^T = v . dO^T
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = sub * 8 + 2 * t + (e & 1);
        if (q0 + q < T) {
          const float* sq = st + q * 3;
          p[e] = expf(p[e] - sq[0]) * sq[1];
          ds[e] = (p[e] * (dp[e] - sq[2])) * ds_scale;
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
  TOut* out = dqkv + static_cast<size_t>(b) * T * pitch;
  store_rows<HDP, TOut>(out, pitch, D + h * hd, dk, r0, T, hd, g, t);
  store_rows<HDP, TOut>(out, pitch, 2 * D + h * hd, dv, r0, T, hd, g, t);
}

template <int HDP, typename TOut>
cudaError_t launch(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                   int T, int num_heads, int hd, float q_scale, float ds_scale,
                   cudaStream_t stream) {
  constexpr size_t s_dq = kStages * dq_stage_bytes<HDP>();
  constexpr size_t s_dkv = kStages * dkv_stage_bytes<HDP>();
  cudaError_t err = allow_dynamic_smem(attention_bwd_dq_kernel<HDP, TOut>, s_dq);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(attention_bwd_dkv_kernel<HDP, TOut>, s_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kRows - 1) / kRows, num_heads, B);
  attention_bwd_dq_kernel<HDP, TOut><<<grid, kThreads, s_dq, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<TOut*>(dqkv), stats, T, num_heads, hd, q_scale, ds_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<HDP, TOut><<<grid, kThreads, s_dkv, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), stats,
      static_cast<TOut*>(dqkv), T, num_heads, hd, q_scale, ds_scale);
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

}  // namespace attn_bwd
}  // namespace vit

// qkv [B, T, 3D] and dout [B, T, D] bf16; dqkv [B, T, 3D] in fp32 (0) or
// bf16 (1); stats: fp32 scratch of B * num_heads * T * 3. head_dim must be a
// multiple of 8 up to 128 (ops/attention.py checks it before calling); any
// T.
VIT_EXPORT int vit_packed_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                        int dqkv_dtype, float* stats, int B, int T,
                                        int num_heads, int head_dim, float q_scale,
                                        float ds_scale, void* stream) {
  using namespace vit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  if (dqkv_dtype == kBF16)
    return attn_bwd::dispatch<bf16>(qkv, dout, dqkv, stats, B, T, num_heads, head_dim,
                                    q_scale, ds_scale, s);
  if (dqkv_dtype == kF32)
    return attn_bwd::dispatch<float>(qkv, dout, dqkv, stats, B, T, num_heads, head_dim,
                                     q_scale, ds_scale, s);
  return cudaErrorInvalidValue;
}

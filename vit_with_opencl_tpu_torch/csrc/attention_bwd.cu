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
// quarter of that at the bf16 peak), though the recomputation makes this
// simple form compute-heavy. Design: two kernels, in FlashAttention-2's
// split, so that no block sums into another's output and the result is the
// same from run to run:
//   dq kernel   one block of 4 warps per (image, head, 64-query tile); K, V
//               and K^T of the head in shared memory; each warp owns 16 query
//               rows and walks the keys four times (row max, row sum, the
//               rowsum(dp * p) term, then ds and dq = ds . K accumulated in
//               registers); it also writes each row's (m, inv, delta) to a
//               small fp32 buffer;
//   dkv kernel  one block of 4 warps per (image, head, 64-key tile); q
//               scaled and unscaled (transposed), dO and dO^T and the rows'
//               statistics in shared memory; each warp owns 16 keys, rebuilds
//               p^T and dp^T for them from the statistics, and accumulates
//               dv = bf16(p)^T . dO and dk = ds^T . q in registers.
// Products use mma.sync m16n8k16 (bf16 in, fp32 out) with the operand
// layouts of the forward kernel: an accumulator tile rounded to bf16 is the
// A operand of the next product. Head dims that are a multiple of 8 are
// zero-padded to the next of the compiled widths (16..128). Not yet used:
// wgmma, TMA, and keeping the scores between passes.
#include <float.h>

#include "common.cuh"

namespace vit {
namespace attn_bwd {

constexpr int kWarps = 4;
constexpr int kTile = kWarps * 16;
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

// c = A . B^T over the head dim for this warp's 16 rows (A fragments `a`)
// and the 8 rows [8 * tile, 8 * tile + 8) of the shared-memory matrix `rows`
// (pitch ld): c[0..1] are row g, columns 2t and 2t+1; c[2..3] row g + 8.
template <int HDP>
__device__ __forceinline__ void dot_tile(float c[4], const uint32_t (&a)[HDP / 16][4],
                                         const bf16* rows, int ld, int tile,
                                         int g, int t) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const bf16* r = rows + (tile * 8 + g) * ld + 2 * t;
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s)
    mma_16816(c, a[s], ld32(r + s * 16), ld32(r + s * 16 + 8));
}

// acc[d] += A . M for the 16-wide slice [16 * chunk, 16 * chunk + 16) of the
// contraction, where A (this warp's 16 rows) is `a` in the A layout and M is
// stored transposed in shared memory as mt[col][k] (pitch ld).
template <int HDP>
__device__ __forceinline__ void accumulate(float (&acc)[HDP / 8][4],
                                           const uint32_t (&a)[4], const bf16* mt,
                                           int ld, int chunk, int g, int t) {
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    const bf16* r = mt + (d * 8 + g) * ld + chunk * 16 + 2 * t;
    mma_16816(acc[d], a, ld32(r), ld32(r + 8));
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

// Stage the [T, hd] column block at `off` of a row-major bf16 matrix into
// shared memory as rows (pitch HDP + 8), optionally scaled and rounded, and
// transposed (pitch Tp + 8), zero-padding rows to Tp and columns to HDP.
template <int HDP>
__device__ __forceinline__ void stage(const bf16* base, int pitch, int off, int T,
                                      int Tp, int hd, float scale, bf16* rows,
                                      bf16* cols) {
  const int ld = HDP + 8, tld = Tp + 8;
  for (int i = threadIdx.x; i < Tp * (HDP / 8); i += blockDim.x) {
    const int r = i / (HDP / 8), c = (i % (HDP / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < T && c < hd)
      raw = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(r) * pitch +
                                            off + c);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
    if (rows != nullptr) {
      if (scale == 1.f) {
        *reinterpret_cast<uint4*>(rows + r * ld + c) = raw;
      } else {
        uint4 scaled;
        scaled.x = pack_bf16x2(__bfloat162float(v[0]) * scale,
                               __bfloat162float(v[1]) * scale);
        scaled.y = pack_bf16x2(__bfloat162float(v[2]) * scale,
                               __bfloat162float(v[3]) * scale);
        scaled.z = pack_bf16x2(__bfloat162float(v[4]) * scale,
                               __bfloat162float(v[5]) * scale);
        scaled.w = pack_bf16x2(__bfloat162float(v[6]) * scale,
                               __bfloat162float(v[7]) * scale);
        *reinterpret_cast<uint4*>(rows + r * ld + c) = scaled;
      }
    }
    if (cols != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) cols[(c + e) * tld + r] = v[e];
    }
  }
}

template <int HDP, typename TOut>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                        TOut* __restrict__ dqkv, float* __restrict__ stats, int T,
                        int num_heads, int hd, float q_scale, float ds_scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int D = num_heads * hd, pitch = 3 * D;
  const int Tp = (T + 15) & ~15;
  const int ld = HDP + 8, tld = Tp + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [Tp][ld]
  bf16* vs = ks + Tp * ld;                   // [Tp][ld]
  bf16* kt = vs + Tp * ld;                   // [HDP][tld], K transposed
  const bf16* img = qkv + static_cast<size_t>(b) * T * pitch;
  const bf16* dimg = dout + static_cast<size_t>(b) * T * D;
  stage<HDP>(img, pitch, D + h * hd, T, Tp, hd, 1.f, ks, kt);
  stage<HDP>(img, pitch, 2 * D + h * hd, T, Tp, hd, 1.f, vs, nullptr);
  __syncthreads();

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kTile + (threadIdx.x / 32) * 16;
  if (r0 >= T) return;  // no barrier follows

  uint32_t qa[HDP / 16][4], da[HDP / 16][4];
  load_a<HDP>(qa, img, pitch, h * hd, r0, T, hd, q_scale, g, t);
  load_a<HDP>(da, dimg, D, h * hd, r0, T, hd, 1.f, g, t);

  // Scores of keys [8 * tile, 8 * tile + 8), keys past T masked.
  auto scores = [&](float c[4], int tile) {
    dot_tile<HDP>(c, qa, ks, ld, tile, g, t);
    const int key = tile * 8 + 2 * t;
    if (key >= T) c[0] = c[2] = kMaskValue;
    if (key + 1 >= T) c[1] = c[3] = kMaskValue;
  };
  auto quad_sum = [](float& v) {  // the 4 lanes that share a row
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
  };

  // Pass 1: the exact row max.
  float mx0 = -FLT_MAX, mx1 = -FLT_MAX;
  for (int tile = 0; tile < Tp / 8; ++tile) {
    float c[4];
    scores(c, tile);
    mx0 = fmaxf(mx0, fmaxf(c[0], c[1]));
    mx1 = fmaxf(mx1, fmaxf(c[2], c[3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

  // Pass 2: the row sum of e.
  float l0 = 0.f, l1 = 0.f;
  for (int tile = 0; tile < Tp / 8; ++tile) {
    float c[4];
    scores(c, tile);
    l0 += expf(c[0] - mx0) + expf(c[1] - mx0);
    l1 += expf(c[2] - mx1) + expf(c[3] - mx1);
  }
  quad_sum(l0);
  quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // p and dp of keys [8 * tile, 8 * tile + 8).
  auto probs = [&](float p[4], float dp[4], int tile) {
    scores(p, tile);
    p[0] = expf(p[0] - mx0) * inv0;
    p[1] = expf(p[1] - mx0) * inv0;
    p[2] = expf(p[2] - mx1) * inv1;
    p[3] = expf(p[3] - mx1) * inv1;
    dot_tile<HDP>(dp, da, vs, ld, tile, g, t);  // V rows past T are zero
  };

  // Pass 3: delta = rowsum(dp * p).
  float dl0 = 0.f, dl1 = 0.f;
  for (int tile = 0; tile < Tp / 8; ++tile) {
    float p[4], dp[4];
    probs(p, dp, tile);
    dl0 += dp[0] * p[0] + dp[1] * p[1];
    dl1 += dp[2] * p[2] + dp[3] * p[3];
  }
  quad_sum(dl0);
  quad_sum(dl1);

  // Pass 4: ds, rounded to bf16 as the A operand of dq += ds . K.
  float dq[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  for (int chunk = 0; chunk < Tp / 16; ++chunk) {
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
    accumulate<HDP>(dq, dsa, kt, tld, chunk, g, t);
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
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                         const float* __restrict__ stats, TOut* __restrict__ dqkv,
                         int T, int num_heads, int hd, float q_scale, float ds_scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int D = num_heads * hd, pitch = 3 * D;
  const int Tp = (T + 15) & ~15;
  const int ld = HDP + 8, tld = Tp + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [Tp][ld], q scaled
  bf16* ds_ = qs + Tp * ld;                  // [Tp][ld], dO
  bf16* qt = ds_ + Tp * ld;                  // [HDP][tld], q transposed
  bf16* dt = qt + HDP * tld;                 // [HDP][tld], dO transposed
  float* st = reinterpret_cast<float*>(dt + HDP * tld);  // [Tp][3]
  const bf16* img = qkv + static_cast<size_t>(b) * T * pitch;
  const bf16* dimg = dout + static_cast<size_t>(b) * T * D;
  stage<HDP>(img, pitch, h * hd, T, Tp, hd, q_scale, qs, nullptr);
  stage<HDP>(img, pitch, h * hd, T, Tp, hd, 1.f, nullptr, qt);
  stage<HDP>(dimg, D, h * hd, T, Tp, hd, 1.f, ds_, dt);
  const float* gst = stats + (static_cast<size_t>(b) * num_heads + h) * T * 3;
  for (int i = threadIdx.x; i < Tp * 3; i += blockDim.x)
    st[i] = i < T * 3 ? gst[i] : 0.f;
  __syncthreads();

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kTile + (threadIdx.x / 32) * 16;  // keys
  if (r0 >= T) return;  // no barrier follows

  uint32_t ka[HDP / 16][4], va[HDP / 16][4];
  load_a<HDP>(ka, img, pitch, D + h * hd, r0, T, hd, 1.f, g, t);
  load_a<HDP>(va, img, pitch, 2 * D + h * hd, r0, T, hd, 1.f, g, t);

  float dk[HDP / 8][4], dv[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }
  // p^T and ds^T of this warp's 16 keys against queries [8 * tile, +8):
  // element e is key row g (e < 2) or g + 8, query 8 * tile + 2t + (e & 1).
  auto grads = [&](float p[4], float ds[4], int tile) {
    float dp[4];
    dot_tile<HDP>(p, ka, qs, ld, tile, g, t);   // s^T = k . qs^T
    dot_tile<HDP>(dp, va, ds_, ld, tile, g, t);  // dp^T = v . dO^T
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = tile * 8 + 2 * t + (e & 1);
      if (q < T) {
        const float* sq = st + q * 3;
        p[e] = expf(p[e] - sq[0]) * sq[1];
        ds[e] = (p[e] * (dp[e] - sq[2])) * ds_scale;
      } else {
        p[e] = ds[e] = 0.f;
      }
    }
  };
  for (int chunk = 0; chunk < Tp / 16; ++chunk) {
    float p0[4], ds0[4], p1[4], ds1[4];
    grads(p0, ds0, 2 * chunk);
    grads(p1, ds1, 2 * chunk + 1);
    const uint32_t pa[4] = {pack_bf16x2(p0[0], p0[1]), pack_bf16x2(p0[2], p0[3]),
                            pack_bf16x2(p1[0], p1[1]), pack_bf16x2(p1[2], p1[3])};
    const uint32_t dsa[4] = {pack_bf16x2(ds0[0], ds0[1]), pack_bf16x2(ds0[2], ds0[3]),
                             pack_bf16x2(ds1[0], ds1[1]), pack_bf16x2(ds1[2], ds1[3])};
    accumulate<HDP>(dv, pa, dt, tld, chunk, g, t);   // dv += bf16(p)^T . dO
    accumulate<HDP>(dk, dsa, qt, tld, chunk, g, t);  // dk += ds^T . q
  }
  TOut* out = dqkv + static_cast<size_t>(b) * T * pitch;
  store_rows<HDP, TOut>(out, pitch, D + h * hd, dk, r0, T, hd, g, t);
  store_rows<HDP, TOut>(out, pitch, 2 * D + h * hd, dv, r0, T, hd, g, t);
}

template <int HDP>
size_t dq_smem(int T) {
  const size_t Tp = (T + 15) & ~15;
  return (2 * Tp * (HDP + 8) + HDP * (Tp + 8)) * sizeof(bf16);
}
template <int HDP>
size_t dkv_smem(int T) {
  const size_t Tp = (T + 15) & ~15;
  return (2 * Tp * (HDP + 8) + 2 * HDP * (Tp + 8)) * sizeof(bf16) +
         Tp * 3 * sizeof(float);
}

template <int HDP, typename TOut>
cudaError_t launch(const void* qkv, const void* dout, void* dqkv, float* stats, int B,
                   int T, int num_heads, int hd, float q_scale, float ds_scale,
                   cudaStream_t stream) {
  const size_t s_dq = dq_smem<HDP>(T), s_dkv = dkv_smem<HDP>(T);
  cudaError_t err = allow_dynamic_smem(attention_bwd_dq_kernel<HDP, TOut>, s_dq);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(attention_bwd_dkv_kernel<HDP, TOut>, s_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, num_heads, B);
  attention_bwd_dq_kernel<HDP, TOut><<<grid, kWarps * 32, s_dq, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<TOut*>(dqkv), stats, T, num_heads, hd, q_scale, ds_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<HDP, TOut><<<grid, kWarps * 32, s_dkv, stream>>>(
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
// multiple of 8 up to 128; ops/attention.py checks that and the shared-memory
// size before calling.
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

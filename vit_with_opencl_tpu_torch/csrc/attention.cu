// Multi-head attention over a packed QKV buffer: [B, T, 3D] -> [B, T, D].
//
// Replaces vit_with_opencl_tpu/ops/attention.py:_packed_kernel
// (packed_fused_attention) and the per-head attention that
// ops/fused_block.py:_block_kernel inlines (_head_attention). "slab" packing:
// for head h, q, k and v are the hd columns at h*hd, D + h*hd and 2D + h*hd
// (attention.py:_packed_offsets). The context is written head-major into
// [B, T, D]. Per head, the numerics of _head_attention:
//   qs = q * scale               rounded to bf16, as the input dtype
//   s  = qs . k^T                fp32 accumulation
//   e  = exp(s - rowmax(s))      fp32, whole row; keys past T are masked to
//                                MASK_VALUE (attention.py:43), not -inf
//   o  = bf16(e) . v             fp32 accumulation
//   o *= 1 / rowsum(e)           normalised after the product, then cast
//
// Bound on the card: bytes at ViT-B's T = 197 (the operations are a third
// of the time the bytes take, at the card's peaks). Design: one block of 4
// warps per (image, head, 64-query tile). The head's K and V (T x hd bf16:
// 25 KB each at T = 197, hd = 64) are staged in shared memory, V transposed,
// so every tensor-core operand is one 32-bit shared-memory load. Each warp
// owns 16 query rows and keeps everything else in registers: its Q
// fragments, the scores of 8 or 16 keys at a time, and the [16, hd] fp32
// output. The softmax takes two passes over the keys instead of an online
// rescaling: pass 1 finds the exact row max, pass 2 recomputes the scores
// (cheap: K is on chip) and accumulates e and e.v with that max, so e is
// rounded to bf16 exactly where the reference rounds it and no [T, T] tile
// is ever stored. Products use mma.sync m16n8k16 (bf16 in, fp32 out). Head
// dims that are a multiple of 8 are zero-padded to the next of the compiled
// widths (16..128). Not yet used: wgmma, TMA, and reuse of K/V across the
// 4 query tiles of one (image, head), which each load them again from L2.
#include <float.h>

#include "common.cuh"

namespace vit {

constexpr int kAttnWarps = 4;
constexpr int kQTile = kAttnWarps * 16;
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

// Scores of this warp's 16 query rows against keys [8 * tile, 8 * tile + 8):
// c[0..1] are row g, keys 2t and 2t+1; c[2..3] are row g + 8 (g = lane / 4,
// t = lane % 4: mma.sync's accumulator layout).
template <int HDP>
__device__ __forceinline__ void score_tile(float c[4],
                                           uint32_t (&qa)[HDP / 16][4],
                                           const bf16* ks, int kld, int tile,
                                           int T, int g, int t) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const bf16* kr = ks + (tile * 8 + g) * kld + 2 * t;
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s)
    mma_16816(c, qa[s], ld32(kr + s * 16), ld32(kr + s * 16 + 8));
  const int key = tile * 8 + 2 * t;
  if (key >= T) c[0] = c[2] = kMaskValue;
  if (key + 1 >= T) c[1] = c[3] = kMaskValue;
}

template <int HDP>
__global__ void __launch_bounds__(kAttnWarps * 32)
packed_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                        int T, int num_heads, int hd, float scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int D = num_heads * hd, pitch = 3 * D;
  const int Tp = (T + 15) & ~15;
  const int kld = HDP + 8, vld = Tp + 8;  // padded against bank conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [Tp][kld]
  bf16* vt = ks + Tp * kld;                  // [HDP][vld], V transposed
  const bf16* img = qkv + static_cast<size_t>(b) * T * pitch;
  const int qoff = h * hd, koff = D + h * hd, voff = 2 * D + h * hd;

  for (int i = threadIdx.x; i < Tp * (HDP / 8); i += blockDim.x) {
    const int t = i / (HDP / 8), c = (i % (HDP / 8)) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (t < T && c < hd) {
      const bf16* row = img + static_cast<size_t>(t) * pitch;
      kv = *reinterpret_cast<const uint4*>(row + koff + c);
      vv = *reinterpret_cast<const uint4*>(row + voff + c);
    }
    *reinterpret_cast<uint4*>(ks + t * kld + c) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt[(c + e) * vld + t] = ve[e];
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kQTile + (threadIdx.x / 32) * 16;
  if (r0 >= T) return;  // no barrier follows

  // Q fragments (mma.sync A layout), scaled and rounded to bf16 as
  // `q * jnp.asarray(scale, q.dtype)` does. `scale` is already bf16-exact.
  uint32_t qa[HDP / 16][4];
#pragma unroll
  for (int s = 0; s < HDP / 16; ++s) {
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int row = r0 + g + (reg & 1) * 8;
      const int col = s * 16 + 2 * t + (reg >> 1) * 8;
      float lo = 0.f, hi = 0.f;
      if (row < T && col < hd) {
        const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(
            img + static_cast<size_t>(row) * pitch + qoff + col);
        lo = __bfloat162float(q.x) * scale;
        hi = __bfloat162float(q.y) * scale;
      }
      qa[s][reg] = pack_bf16x2(lo, hi);
    }
  }

  // Pass 1: the exact max of each row over all keys.
  float mx0 = -FLT_MAX, mx1 = -FLT_MAX;
  for (int tile = 0; tile < Tp / 8; ++tile) {
    float c[4];
    score_tile<HDP>(c, qa, ks, kld, tile, T, g, t);
    mx0 = fmaxf(mx0, fmaxf(c[0], c[1]));
    mx1 = fmaxf(mx1, fmaxf(c[2], c[3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the 4 lanes sharing a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }

  // Pass 2: e = exp(s - max) for 16 keys at a time; the rounded e feeds the
  // PV product directly as the A operand (its accumulator layout is the A
  // layout of the next mma), while the row sums take e in fp32.
  float l0 = 0.f, l1 = 0.f;
  float o[HDP / 8][4];
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  for (int chunk = 0; chunk < Tp / 16; ++chunk) {
    float s0[4], s1[4];
    score_tile<HDP>(s0, qa, ks, kld, 2 * chunk, T, g, t);
    score_tile<HDP>(s1, qa, ks, kld, 2 * chunk + 1, T, g, t);
    const float e00 = expf(s0[0] - mx0), e01 = expf(s0[1] - mx0);
    const float e02 = expf(s0[2] - mx1), e03 = expf(s0[3] - mx1);
    const float e10 = expf(s1[0] - mx0), e11 = expf(s1[1] - mx0);
    const float e12 = expf(s1[2] - mx1), e13 = expf(s1[3] - mx1);
    l0 += e00 + e01 + e10 + e11;
    l1 += e02 + e03 + e12 + e13;
    const uint32_t pa[4] = {pack_bf16x2(e00, e01), pack_bf16x2(e02, e03),
                            pack_bf16x2(e10, e11), pack_bf16x2(e12, e13)};
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d) {
      const bf16* vr = vt + (d * 8 + g) * vld + chunk * 16 + 2 * t;
      mma_16816(o[d], pa, ld32(vr), ld32(vr + 8));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  const int row0 = r0 + g, row1 = r0 + g + 8;
  bf16* out0 = out + (static_cast<size_t>(b) * T + row0) * D + h * hd;
  bf16* out1 = out + (static_cast<size_t>(b) * T + row1) * D + h * hd;
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (col >= hd) continue;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(out0 + col) =
          pack_bf16x2(o[d][0] * inv0, o[d][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(out1 + col) =
          pack_bf16x2(o[d][2] * inv1, o[d][3] * inv1);
  }
}

template <int HDP>
cudaError_t launch_attention(const void* qkv, void* out, int B, int T,
                             int num_heads, int hd, float scale,
                             cudaStream_t stream) {
  const int Tp = (T + 15) & ~15;
  const size_t smem =
      (static_cast<size_t>(Tp) * (HDP + 8) + static_cast<size_t>(HDP) * (Tp + 8)) *
      sizeof(bf16);
  cudaError_t err = allow_dynamic_smem(packed_attention_kernel<HDP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kQTile - 1) / kQTile, num_heads, B);
  packed_attention_kernel<HDP><<<grid, kAttnWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), T, num_heads, hd,
      scale);
  return cudaGetLastError();
}

}  // namespace vit

// head_dim must be a multiple of 8 and at most 128; ops/attention.py checks
// that and the shared-memory size before calling.
VIT_EXPORT int vit_packed_attention_bf16(const void* qkv, void* out, int B,
                                         int T, int num_heads, int head_dim,
                                         float scale, void* stream) {
  using namespace vit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0)
    return cudaErrorInvalidValue;
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return launch_attention<16>(qkv, out, B, T, num_heads, head_dim, scale, s);
    case 32: return launch_attention<32>(qkv, out, B, T, num_heads, head_dim, scale, s);
    case 48: return launch_attention<48>(qkv, out, B, T, num_heads, head_dim, scale, s);
    case 64: return launch_attention<64>(qkv, out, B, T, num_heads, head_dim, scale, s);
    case 80: return launch_attention<80>(qkv, out, B, T, num_heads, head_dim, scale, s);
    case 96: return launch_attention<96>(qkv, out, B, T, num_heads, head_dim, scale, s);
    case 112: return launch_attention<112>(qkv, out, B, T, num_heads, head_dim, scale, s);
    case 128: return launch_attention<128>(qkv, out, B, T, num_heads, head_dim, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// Tiled bf16 GEMM with an fp32 epilogue: out = epi(x @ w).
//
// Replaces vit_with_opencl_tpu/ops/linear.py:_linear_kernel (fused_linear)
// and the four matmuls that ops/fused_block.py:_block_kernel inlines (_mm).
// x is [M, K] bf16, w is [K, N] bf16 (the right-multiply layout of
// models/vit.stack_params), both row-major. Products accumulate in fp32 on
// the tensor cores. The epilogue runs in fp32 in this order:
//   + residual (optional; fp32 or bf16 [M, N]), + bias (optional; fp32 [N]),
//   _gelu_fast (optional), then the cast to the output dtype (bf16 or fp32).
// That is the encoder layer's order: the residual first, then the bias.
//
// Bound on the card: operations at the encoder's shapes (K = 768 or 3072
// against M = B*197 rows: far above the card's ~295 bf16 operations per byte).
// Design, kept simple for a first port: 128x128 output tiles, 8 warps each
// owning a 64x32 sub-tile of 16x16x16 WMMA fragments, and a 3-stage cp.async
// ring of 32-deep K slices so loads of slice k+2 overlap the products of
// slice k. The ragged M edge (M = B*197) and the N edge are zero-filled on
// load and masked on store; K and N must be multiples of 8 (16-byte chunks).
// The epilogue goes through a per-warp 16x16 fp32 staging tile in shared
// memory, because WMMA's accumulator layout is opaque. Not yet used:
// Hopper's wgmma and TMA, which a later tuning pass needs to approach peak.
#include "common.cuh"  // cuda_bf16.h before mma.h: the bf16 fragments

#include <mma.h>

namespace vit {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kALd = kBK + 8;  // padded row pitches (elements) against bank
constexpr int kBLd = kBN + 8;  // conflicts; both keep rows 16-byte aligned
constexpr int kAStage = kBM * kALd;
constexpr int kBStage = kBK * kBLd;
constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;
constexpr int kEpiLd = 20;  // fp32 staging pitch

// Residual kinds (ops/linear.py passes the same codes).
enum Residual : int { kNoResidual = 0, kResidualF32 = 1, kResidualBF16 = 2 };

// vit_with_opencl_tpu_torch/ops/fused_block.py:_GELU_P, highest power first
// in the Horner loop (tests/test_torch_ops.py checks the two agree).
__device__ __forceinline__ float gelu_fast(float x) {
  const float u = x * x;
  float p = 1.1191059256776888e-06f;
  p = p * u + -3.0581402420578764e-05f;
  p = p * u + -0.00012485972711897262f;
  p = p * u + 0.03646878821593782f;
  p = p * u + 0.79782813653302f;
  return 0.5f * x * (1.0f + tanhf(x * p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void load_slice(bf16* as, bf16* bs,
                                           const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int M,
                                           int N, int K, int m0, int n0,
                                           int k0) {
  for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    const bf16* src = ok ? x + static_cast<size_t>(m0 + r) * K + k0 + c : x;
    cp_async16(as + r * kALd + c, src, ok);
  }
  for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const bool ok = k0 + r < K && n0 + c < N;
    const bf16* src = ok ? w + static_cast<size_t>(k0 + r) * N + n0 + c : w;
    cp_async16(bs + r * kBLd + c, src, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
linear_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const void* residual,
                   int residual_kind, void* out, int out_bf16, int gelu, int M,
                   int N, int K) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + kStages * kAStage;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64x32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int slices = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices)
      load_slice(as + s * kAStage, bs + s * kBStage, x, w, M, N, K, m0, n0,
                 s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt-1's stage is free again
    const int next = kt + kStages - 1;
    if (next < slices)
      load_slice(as + (next % kStages) * kAStage,
                 bs + (next % kStages) * kBStage, x, w, M, N, K, m0, n0,
                 next * kBK);
    cp_async_commit();

    const bf16* a_tile = as + (kt % kStages) * kAStage + (wm * 64) * kALd;
    const bf16* b_tile = bs + (kt % kStages) * kBStage + wn * 32;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a_tile + i * 16 * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], b_tile + kk * kBLd + j * 16, kBLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: reuse it as the epilogue staging area

  float* stage = reinterpret_cast<float*>(smem) + warp * 16 * kEpiLd;
  const int r = lane / 2, c = (lane % 2) * 8;  // each lane: 8 columns of a row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], kEpiLd, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + r;
      const int gn = n0 + wn * 32 + j * 16 + c;
      if (gm < M && gn < N) {  // N % 8 == 0: the 8 columns are all in or out
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = stage[r * kEpiLd + c + e];
        const size_t off = static_cast<size_t>(gm) * N + gn;
        if (residual_kind == kResidualF32) {
          const float4* rp = reinterpret_cast<const float4*>(
              static_cast<const float*>(residual) + off);
          const float4 r0 = rp[0], r1 = rp[1];
          v[0] = r0.x + v[0]; v[1] = r0.y + v[1];
          v[2] = r0.z + v[2]; v[3] = r0.w + v[3];
          v[4] = r1.x + v[4]; v[5] = r1.y + v[5];
          v[6] = r1.z + v[6]; v[7] = r1.w + v[7];
        } else if (residual_kind == kResidualBF16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              static_cast<const bf16*>(residual) + off);
          const bf16* rv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(rv[e]) + v[e];
        }
        if (bias != nullptr) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = v[e] + bias[gn + e];
        }
        if (gelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gelu_fast(v[e]);
        }
        if (out_bf16) {
          uint4 packed;
          packed.x = pack_bf16x2(v[0], v[1]);
          packed.y = pack_bf16x2(v[2], v[3]);
          packed.z = pack_bf16x2(v[4], v[5]);
          packed.w = pack_bf16x2(v[6], v[7]);
          *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + off) = packed;
        } else {
          float4* op = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
          op[0] = make_float4(v[0], v[1], v[2], v[3]);
          op[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
      __syncwarp();  // the staging tile is rewritten by the next fragment
    }
  }
}

}  // namespace vit

VIT_EXPORT int vit_linear_bf16(const void* x, const void* w, const float* bias,
                               const void* residual, int residual_kind,
                               void* out, int out_bf16, int gelu, int M, int N,
                               int K, void* stream) {
  using namespace vit;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 ||
      residual_kind < kNoResidual || residual_kind > kResidualBF16)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(linear_bf16_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  linear_bf16_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, residual,
      residual_kind, out, out_bf16, gelu, M, N, K);
  return cudaGetLastError();
}

// The W8A8 GEMMs with an fp32 epilogue: out = epi(xq @ w) (the bf16 forms
// and the weight-only int8 form run on the Hopper core, gemm_sm90.cuh).
//
// Replace the int8 matmuls that vit_with_opencl_tpu/ops/fused_block.py's
// _block_kernel inlines with w8a8=True (_mm, quantized=True):
//   linear_w8a8_kernel   x int8 @ w int8, int32 accumulation
//                        (exact: 3072 * 127^2 < 2^31), then
//                        ((float)acc * x_scale[m]) * w_scale[n]; with a side
//                        product (outlier=True: _mm with hi_ref,
//                        fused_block.py:108-116, and _mm_ctx_masked, :128),
//                        a second K loop over bf16 x_hi [M, K_hi] @ w_hi
//                        [K_hi, N] into an fp32 accumulator of the same
//                        output tile, added after the scales:
//                        t = ((float)acc * x_scale[m]) * w_scale[n] + side.
// w is the right-multiply layout [K, N] of models/vit.stack_params, row-major.
// The epilogue (epilogue.cuh, shared with the Hopper core) then adds the
// residual and the bias, the optional _gelu_fast, and casts. The scale
// products use __fmul_rn, which nvcc never contracts into an FMA with the
// residual or bias add that follows: the plain version rounds after each
// operation, and the W8A8 forms without GELU are bit-identical to it.
//
// Bound on the card: operations at the encoder's shapes (K = 768 or 3072
// against M = B*197 rows: far above the card's ~590 int8 operations per
// byte). Design, kept simple for a first port: 128x128 output tiles, 8 warps
// each owning a 64x32 sub-tile of 16x16x16 WMMA fragments, and a 3-stage
// cp.async ring of K slices so loads of slice k+2 overlap the products of
// slice k. The ragged M edge (M = B*197) and the N edge are zero-filled on
// load and masked on store; K must be a multiple of 16 and N of 16 (16-byte
// chunks), K_hi of 8. The epilogue goes through a per-warp 16x16 staging
// tile in shared memory, because WMMA's accumulator layout is opaque. The
// int8 tiles are kept as 16-byte-wide column chunks ([chunk][row][16]) so
// that every 8-bit WMMA fragment starts on a 32-byte boundary. The side
// product (K_hi = 96 or 128 at ViT-B against an int8 K of 640 to 2944) is
// one kernel, not a second GEMM with an fp32 [M, N] addend: that round trip
// would cost 2 x 620 MB for fc1 at B = 256. Not yet used: Hopper's wgmma and
// TMA (ROADMAP: the W8A8 GEMMs on the Hopper core).
#include "epilogue.cuh"
#include "int8_tiles.cuh"  // common.cuh, mma.h, cp.async, the int8 slices

namespace vit {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kALd = kBK + 8;  // padded row pitches (elements) against bank
constexpr int kBLd = kBN + 8;  // conflicts; both keep rows 16-byte aligned
constexpr int kAStage = kBM * kALd;
constexpr int kBStage = kBK * kBLd;
constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;
constexpr int kEpiLd = 20;  // staging pitch (fp32 or int32 elements)
// linear_w8a8_kernel: 64-deep int8 slices, stored as 16-byte column chunks
// (int8_tiles.cuh, whose tile is this file's).
static_assert(kBM == kI8BM && kBN == kI8BN && kThreads == kI8Threads,
              "the int8 slices of int8_tiles.cuh assume this file's tile");
constexpr int kQBK = kI8BK;
constexpr int kQAStage = kI8AStage;  // bytes: [kQBK/16][kBM][16]
constexpr int kQBStage = kI8BStage;  // bytes: [kBN/16][kQBK][16]
constexpr int kSmemBytesW8A8 = kStages * (kQAStage + kQBStage);
// With the side product the ring is reused for the bf16 slices after the
// int8 loop.
constexpr int kSmemBytesW8A8Side =
    kSmemBytesW8A8 > kSmemBytes ? kSmemBytesW8A8 : kSmemBytes;

// The epilogue of a block: each warp stages its 4x2 accumulator fragments
// one at a time (T: float or int) and each lane finishes 8 columns of a row;
// scale(raw, gm, gn) turns a staged accumulator into the scaled fp32 product.
template <typename T, typename Frag, typename Scale>
__device__ __forceinline__ void write_tiles(Frag (&acc)[4][2],
                                            unsigned char* smem, int m0,
                                            int n0, int M, int N,
                                            const Epilogue& ep, Scale scale) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  T* stage = reinterpret_cast<T*>(smem) + warp * 16 * kEpiLd;
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
        for (int e = 0; e < 8; ++e)
          v[e] = scale(stage[r * kEpiLd + c + e], gm, gn + e);
        finish<8>(v, gm, gn, N, ep);
      }
      __syncwarp();  // the staging tile is rewritten by the next fragment
    }
  }
}

// One [kBM, kBK] bf16 slice of x into a padded stage.
__device__ __forceinline__ void load_a_bf16(bf16* as, const bf16* __restrict__ x,
                                            int M, int K, int m0, int k0) {
  for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    const bf16* src = ok ? x + static_cast<size_t>(m0 + r) * K + k0 + c : x;
    cp_async16(as + r * kALd + c, src, ok);
  }
}

// One [kBK, kBN] bf16 slice of w into a padded stage.
__device__ __forceinline__ void load_b_bf16(bf16* bs, const bf16* __restrict__ w,
                                            int N, int K, int n0, int k0) {
  for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const bool ok = k0 + r < K && n0 + c < N;
    const bf16* src = ok ? w + static_cast<size_t>(k0 + r) * N + n0 + c : w;
    cp_async16(bs + r * kBLd + c, src, ok);
  }
}

// The products of one bf16 slice: each warp's 64x32 sub-tile.
__device__ __forceinline__ void mma_slice_bf16(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (
        &acc)[4][2],
    const bf16* a_stage, const bf16* b_stage) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64x32
  const bf16* a_tile = a_stage + (wm * 64) * kALd;
  const bf16* b_tile = b_stage + wn * 32;
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

// One 64-deep int8 slice of xq ([4 chunks][kBM rows][16]) and of w
// ([8 chunks][kQBK rows][16]).
__device__ __forceinline__ void load_slice_int8(
    int8_t* as, int8_t* bs, const int8_t* __restrict__ xq,
    const int8_t* __restrict__ w, int M, int N, int K, int m0, int n0,
    int k0) {
  load_a_slice_int8(as, xq, M, K, m0, k0);
  load_b_slice_int8(bs, w, N, K, n0, k0);
}

// The epilogue of the W8A8 GEMM with a side product: each fragment's int32
// sums and its fp32 side sums are staged side by side, then
// t = ((float)acc * x_scale[m]) * w_scale[n] + side, in that order (the
// plain version's), before the rest of the epilogue.
__device__ __forceinline__ void write_tiles_side(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, int> (
        &acc)[4][2],
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (
        &side)[4][2],
    unsigned char* smem, int m0, int n0, int M, int N, const Epilogue& ep,
    const float* __restrict__ x_scale, const float* __restrict__ w_scale) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  int* istage = reinterpret_cast<int*>(smem) + warp * 16 * kEpiLd;
  float* fstage = reinterpret_cast<float*>(smem) +
                  (kThreads / 32 + warp) * 16 * kEpiLd;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(istage, acc[i][j], kEpiLd, wmma::mem_row_major);
      wmma::store_matrix_sync(fstage, side[i][j], kEpiLd, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + r;
      const int gn = n0 + wn * 32 + j * 16 + c;
      if (gm < M && gn < N) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(istage[r * kEpiLd + c + e]),
                                  x_scale[gm]),
                        w_scale[gn + e]),
              fstage[r * kEpiLd + c + e]);
        finish<8>(v, gm, gn, N, ep);
      }
      __syncwarp();
    }
  }
}

// kSide: also the bf16 side product x_hi @ w_hi (K_hi deep, a multiple of
// 8), run after the int8 loop in the same ring of shared memory. Both
// accumulators stay in registers (128 of them for a warp's 64x32 sub-tile).
template <bool kSide>
__global__ void __launch_bounds__(kThreads)
linear_w8a8_kernel(const int8_t* __restrict__ xq,
                   const float* __restrict__ x_scale,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale,
                   const bf16* __restrict__ x_hi,
                   const bf16* __restrict__ w_hi, int K_hi, Epilogue ep,
                   int M, int N, int K) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* as = reinterpret_cast<int8_t*>(smem);
  int8_t* bs = as + kStages * kQAStage;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int slices = (K + kQBK - 1) / kQBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices)
      load_slice_int8(as + s * kQAStage, bs + s * kQBStage, xq, w, M, N, K,
                      m0, n0, s * kQBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt-1's stage is free again
    const int next = kt + kStages - 1;
    if (next < slices)
      load_slice_int8(as + (next % kStages) * kQAStage,
                      bs + (next % kStages) * kQBStage, xq, w, M, N, K, m0,
                      n0, next * kQBK);
    cp_async_commit();
    mma_slice_int8(acc, as + (kt % kStages) * kQAStage,
                   bs + (kt % kStages) * kQBStage);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle
  if constexpr (kSide) {
    bf16* as16 = reinterpret_cast<bf16*>(smem);
    bf16* bs16 = as16 + kStages * kAStage;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> side[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(side[i][j], 0.f);
    const int hslices = (K_hi + kBK - 1) / kBK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < hslices) {
        load_a_bf16(as16 + s * kAStage, x_hi, M, K_hi, m0, s * kBK);
        load_b_bf16(bs16 + s * kBStage, w_hi, N, K_hi, n0, s * kBK);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < hslices; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int next = kt + kStages - 1;
      if (next < hslices) {
        load_a_bf16(as16 + (next % kStages) * kAStage, x_hi, M, K_hi, m0,
                    next * kBK);
        load_b_bf16(bs16 + (next % kStages) * kBStage, w_hi, N, K_hi, n0,
                    next * kBK);
      }
      cp_async_commit();
      mma_slice_bf16(side, as16 + (kt % kStages) * kAStage,
                     bs16 + (kt % kStages) * kBStage);
    }
    cp_async_wait<0>();
    __syncthreads();
    write_tiles_side(acc, side, smem, m0, n0, M, N, ep, x_scale, w_scale);
  } else {
    write_tiles<int>(acc, smem, m0, n0, M, N, ep,
                     [x_scale, w_scale](int a, int m, int n) {
                       return __fmul_rn(
                           __fmul_rn(__int2float_rn(a), x_scale[m]), w_scale[n]);
                     });
  }
}


}  // namespace vit

// x_hi and w_hi null (K_hi 0): the plain W8A8 GEMM; else with the bf16
// side product.
VIT_EXPORT int vit_linear_w8a8(const void* xq, const float* x_scale,
                               const void* w, const float* w_scale,
                               const void* x_hi, const void* w_hi, int K_hi,
                               const float* bias, const void* residual,
                               int residual_kind, void* out, int out_bf16,
                               int gelu, int M, int N, int K, void* stream) {
  using namespace vit;
  const bool side = x_hi != nullptr;
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0 ||
      x_scale == nullptr || w_scale == nullptr || bad_epilogue(residual_kind) ||
      side != (w_hi != nullptr) || (side && (K_hi <= 0 || K_hi % 8 != 0)))
    return cudaErrorInvalidValue;
  const Epilogue ep{bias, residual, residual_kind, out, out_bf16, gelu};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  cudaError_t err;
  if (side) {
    err = allow_dynamic_smem(linear_w8a8_kernel<true>, kSmemBytesW8A8Side);
    if (err != cudaSuccess) return err;
    linear_w8a8_kernel<true><<<grid, kThreads, kSmemBytesW8A8Side, s>>>(
        xq8, x_scale, w8, w_scale, static_cast<const bf16*>(x_hi),
        static_cast<const bf16*>(w_hi), K_hi, ep, M, N, K);
  } else {
    err = allow_dynamic_smem(linear_w8a8_kernel<false>, kSmemBytesW8A8);
    if (err != cudaSuccess) return err;
    linear_w8a8_kernel<false><<<grid, kThreads, kSmemBytesW8A8, s>>>(
        xq8, x_scale, w8, w_scale, nullptr, nullptr, 0, ep, M, N, K);
  }
  return cudaGetLastError();
}

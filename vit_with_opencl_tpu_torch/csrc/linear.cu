// Tiled GEMMs with an fp32 epilogue: out = epi(x @ w), in three forms, and
// the training backward's GEMM forms (grad_gemm_kernel, further down).
//
// Replaces vit_with_opencl_tpu/ops/linear.py:_linear_kernel (fused_linear)
// and the four matmuls that ops/fused_block.py:_block_kernel inlines (_mm):
//   linear_bf16_kernel   x bf16 [M, K] @ w bf16 [K, N], fp32 accumulation;
//   linear_int8w_kernel  x bf16 @ w int8 (weight-only int8, quantized=True):
//                        the int8 tile is widened to bf16 in shared memory
//                        (exact: |q| <= 127), then the bf16 path; the fp32
//                        accumulator is multiplied by the per-column scale;
//   linear_w8a8_kernel   x int8 @ w int8 (quantized=True, w8a8=True), int32
//                        accumulation (exact: 3072 * 127^2 < 2^31), then
//                        ((float)acc * x_scale[m]) * w_scale[n]; with a side
//                        product (outlier=True: _mm with hi_ref,
//                        fused_block.py:108-116, and _mm_ctx_masked, :128),
//                        a second K loop over bf16 x_hi [M, K_hi] @ w_hi
//                        [K_hi, N] into an fp32 accumulator of the same
//                        output tile, added after the scales:
//                        t = ((float)acc * x_scale[m]) * w_scale[n] + side.
// w is the right-multiply layout [K, N] of models/vit.stack_params, row-major.
// The epilogue then runs in fp32 in this order:
//   + residual (optional; fp32 or bf16 [M, N]), + bias (optional; fp32 [N]),
//   _gelu_fast (optional), then the cast to the output dtype (bf16 or fp32).
// That is the encoder layer's order: the residual first, then the bias. The
// scale products use __fmul_rn, which nvcc never contracts into an FMA with
// the residual or bias add that follows: the plain version rounds after each
// operation, and the int8 forms without GELU are bit-identical to it.
//
// Bound on the card: operations at the encoder's shapes (K = 768 or 3072
// against M = B*197 rows: far above the card's ~295 bf16 or ~590 int8
// operations per byte). Design, kept simple for a first port: 128x128 output
// tiles, 8 warps each owning a 64x32 sub-tile of 16x16x16 WMMA fragments, and
// a 3-stage cp.async ring of K slices so loads of slice k+2 overlap the
// products of slice k. The ragged M edge (M = B*197) and the N edge are
// zero-filled on load and masked on store; K and N must be multiples of 8
// (bf16) or 16 (int8 operands: 16-byte chunks). The epilogue goes through a
// per-warp 16x16 staging tile in shared memory, because WMMA's accumulator
// layout is opaque. The int8 tiles are kept as 16-byte-wide column chunks
// ([chunk][row][16]) so that every 8-bit WMMA fragment starts on a 32-byte
// boundary. The side product (K_hi = 96 or 128 at ViT-B against an int8 K of
// 640 to 2944) is one kernel, not a second GEMM with an fp32 [M, N] addend:
// that round trip would cost 2 x 620 MB for fc1 at B = 256. Not yet used:
// Hopper's wgmma and TMA, which a later tuning pass needs to approach peak.
#include "int8_tiles.cuh"  // common.cuh, mma.h, cp.async, the int8 slices

#include <type_traits>

namespace vit {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3, kThreads = 256;
constexpr int kALd = kBK + 8;  // padded row pitches (elements) against bank
constexpr int kBLd = kBN + 8;  // conflicts; both keep rows 16-byte aligned
constexpr int kAStage = kBM * kALd;
constexpr int kBStage = kBK * kBLd;
constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;
constexpr int kEpiLd = 20;  // staging pitch (fp32 or int32 elements)
// linear_int8w_kernel: a ring of int8 [kBK, kBN] tiles and one bf16 tile.
constexpr int kB8Stage = kBK * kBN;
constexpr int kSmemBytesInt8W =
    kStages * kAStage * 2 + kStages * kB8Stage + kBStage * 2;
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

// Residual kinds (ops/linear.py passes the same codes).
enum Residual : int { kNoResidual = 0, kResidualF32 = 1, kResidualBF16 = 2 };

// What every GEMM does after the product (see the note at the top).
struct Epilogue {
  const float* bias;      // [N] or null
  const void* residual;   // [M, N] or null
  int residual_kind;
  void* out;              // [M, N]
  int out_bf16;
  int gelu;
};

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

// Residual, bias, GELU and the store for 8 consecutive columns gn..gn+7 of
// row gm, whose products (already scaled) are in v.
__device__ __forceinline__ void finish8(float (&v)[8], int gm, int gn, int N,
                                        const Epilogue& ep) {
  const size_t off = static_cast<size_t>(gm) * N + gn;
  if (ep.residual_kind == kResidualF32) {
    const float4* rp = reinterpret_cast<const float4*>(
        static_cast<const float*>(ep.residual) + off);
    const float4 r0 = rp[0], r1 = rp[1];
    v[0] = r0.x + v[0]; v[1] = r0.y + v[1];
    v[2] = r0.z + v[2]; v[3] = r0.w + v[3];
    v[4] = r1.x + v[4]; v[5] = r1.y + v[5];
    v[6] = r1.z + v[6]; v[7] = r1.w + v[7];
  } else if (ep.residual_kind == kResidualBF16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(ep.residual) + off);
    const bf16* rv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(rv[e]) + v[e];
  }
  if (ep.bias != nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = v[e] + ep.bias[gn + e];
  }
  if (ep.gelu) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gelu_fast(v[e]);
  }
  if (ep.out_bf16) {
    uint4 packed;
    packed.x = pack_bf16x2(v[0], v[1]);
    packed.y = pack_bf16x2(v[2], v[3]);
    packed.z = pack_bf16x2(v[4], v[5]);
    packed.w = pack_bf16x2(v[6], v[7]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(ep.out) + off) = packed;
  } else {
    float4* op = reinterpret_cast<float4*>(static_cast<float*>(ep.out) + off);
    op[0] = make_float4(v[0], v[1], v[2], v[3]);
    op[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

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
        finish8(v, gm, gn, N, ep);
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

// One [kBK, kBN] int8 slice of w, unpadded (widened to bf16 before use).
__device__ __forceinline__ void load_b_int8(int8_t* bs,
                                            const int8_t* __restrict__ w,
                                            int N, int K, int n0, int k0) {
  for (int i = threadIdx.x; i < kBK * (kBN / 16); i += kThreads) {
    const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
    const bool ok = k0 + r < K && n0 + c < N;
    const int8_t* src = ok ? w + static_cast<size_t>(k0 + r) * N + n0 + c : w;
    cp_async16(bs + r * kBN + c, src, ok);
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

__global__ void __launch_bounds__(kThreads)
linear_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   Epilogue ep, int M, int N, int K) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + kStages * kAStage;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int slices = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) {
      load_a_bf16(as + s * kAStage, x, M, K, m0, s * kBK);
      load_b_bf16(bs + s * kBStage, w, N, K, n0, s * kBK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt-1's stage is free again
    const int next = kt + kStages - 1;
    if (next < slices) {
      load_a_bf16(as + (next % kStages) * kAStage, x, M, K, m0, next * kBK);
      load_b_bf16(bs + (next % kStages) * kBStage, w, N, K, n0, next * kBK);
    }
    cp_async_commit();
    mma_slice_bf16(acc, as + (kt % kStages) * kAStage,
                   bs + (kt % kStages) * kBStage);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: reuse it as the epilogue staging area
  write_tiles<float>(acc, smem, m0, n0, M, N, ep,
                     [](float a, int, int) { return a; });
}

__global__ void __launch_bounds__(kThreads)
linear_int8w_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ w_scale, Epilogue ep, int M,
                    int N, int K) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  int8_t* b8 = reinterpret_cast<int8_t*>(as + kStages * kAStage);
  bf16* bs = reinterpret_cast<bf16*>(b8 + kStages * kB8Stage);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int slices = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) {
      load_a_bf16(as + s * kAStage, x, M, K, m0, s * kBK);
      load_b_int8(b8 + s * kB8Stage, w, N, K, n0, s * kBK);
    }
    cp_async_commit();
  }
  // Widening: thread t turns 16 int8 of row t / 8 into 16 bf16.
  const int wr = threadIdx.x / (kBN / 16), wc = (threadIdx.x % (kBN / 16)) * 16;
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; every warp is done with bs
    const int next = kt + kStages - 1;
    if (next < slices) {
      load_a_bf16(as + (next % kStages) * kAStage, x, M, K, m0, next * kBK);
      load_b_int8(b8 + (next % kStages) * kB8Stage, w, N, K, n0, next * kBK);
    }
    cp_async_commit();
    {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          b8 + (kt % kStages) * kB8Stage + wr * kBN + wc);
      const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
      uint4 lo, hi;
      lo.x = pack_bf16x2(q[0], q[1]);   lo.y = pack_bf16x2(q[2], q[3]);
      lo.z = pack_bf16x2(q[4], q[5]);   lo.w = pack_bf16x2(q[6], q[7]);
      hi.x = pack_bf16x2(q[8], q[9]);   hi.y = pack_bf16x2(q[10], q[11]);
      hi.z = pack_bf16x2(q[12], q[13]); hi.w = pack_bf16x2(q[14], q[15]);
      uint4* dst = reinterpret_cast<uint4*>(bs + wr * kBLd + wc);
      dst[0] = lo;
      dst[1] = hi;
    }
    __syncthreads();  // the widened slice is complete
    mma_slice_bf16(acc, as + (kt % kStages) * kAStage, bs);
  }
  cp_async_wait<0>();
  __syncthreads();
  write_tiles<float>(acc, smem, m0, n0, M, N, ep,
                     [w_scale](float a, int, int n) {
                       return __fmul_rn(a, w_scale[n]);
                     });
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
        finish8(v, gm, gn, N, ep);
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

// ---------------------------------------------------------------------------
// The backward's GEMM forms (ops/fused_block.py:_mlp_bwd_kernel and
// _attn_bwd_kernel, and the fc1 recompute they share):
//   dgrad   dY [M, N] . W^T with W stored [K, N]: B is read transposed;
//           optionally times _gelu_fast_grad(pre [M, K]) (fc2's dgrad);
//   wgrad   X^T . dY over the M = B*T tokens (X [M, K], dY [M, N]) into an
//           fp32 [K, N] weight gradient: A is read transposed, and the
//           contraction runs over the ragged token axis;
//   fc1     x . w + bias with two outputs: fp32 hid_pre for the GELU
//           gradient and bf16 _gelu_fast(hid_pre) for dfc2_w.
// One kernel, grad_gemm_kernel<AT, BT>, serves all three: the same 128x128
// tiles, 8 warps and 3-stage cp.async ring as linear_bf16_kernel, with A or
// B staged k-major when it is stored transposed and read through WMMA's
// col_major fragments. Its epilogue: + bias, * _gelu_fast_grad(pre), the
// store in fp32 or bf16, and an optional bf16 second output of the value or
// of its _gelu_fast. On the TPU each weight gradient was a sum carried in
// VMEM over a sequential batch grid; here one block owns an output tile and
// walks the whole token axis itself, so nothing sums across blocks (the
// result is the same from run to run; the order of the sum differs from
// the TPU's, which per image sums 197 tokens and then adds the images).
// Bound: operations. Not yet used: split-K for the wgrad tiles (768 x 768
// has 36 tiles for 132 SMs), wgmma and TMA.
// ---------------------------------------------------------------------------

constexpr int kATLd = kBM + 8;  // A staged k-major: [kBK][kBM + 8]
constexpr int kBTLd = kBK + 8;  // B staged n-major: [kBN][kBK + 8]
constexpr int kGStage = kBM * kALd;  // the larger of the four stage sizes
static_assert(kGStage >= kBK * kATLd && kGStage >= kBStage &&
                  kGStage >= kBN * kBTLd,
              "grad GEMM stage");
constexpr int kSmemBytesGrad = kStages * 2 * kGStage * 2;

struct GradEpilogue {
  const float* bias;          // [N] or null
  const float* gelu_grad_of;  // [M, N] fp32 pre-activation or null
  void* out;                  // [M, N]
  int out_bf16;
  bf16* out2;                 // [M, N] bf16 or null
  int out2_gelu;              // out2 = bf16(_gelu_fast(v)) instead of bf16(v)
};

// d/dx of gelu_fast (ops/fused_block.py:_gelu_fast_grad): with w = x P(x^2),
// g'(x) = 0.5 (1 + t) + 0.5 x (1 - t^2) (P(u) + 2 u P'(u)), t = tanh(w).
__device__ __forceinline__ float gelu_fast_grad(float x) {
  const float u = x * x;
  float p = 1.1191059256776888e-06f;
  p = p * u + -3.0581402420578764e-05f;
  p = p * u + -0.00012485972711897262f;
  p = p * u + 0.03646878821593782f;
  p = p * u + 0.79782813653302f;
  float dp = 4.0f * 1.1191059256776888e-06f;
  dp = dp * u + 3.0f * -3.0581402420578764e-05f;
  dp = dp * u + 2.0f * -0.00012485972711897262f;
  dp = dp * u + 1.0f * 0.03646878821593782f;
  const float t = tanhf(x * p);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * (p + 2.0f * u * dp);
}

__device__ __forceinline__ void store8(void* base, size_t off, int as_bf16,
                                       const float (&v)[8]) {
  if (as_bf16) {
    uint4 packed;
    packed.x = pack_bf16x2(v[0], v[1]);
    packed.y = pack_bf16x2(v[2], v[3]);
    packed.z = pack_bf16x2(v[4], v[5]);
    packed.w = pack_bf16x2(v[6], v[7]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(base) + off) = packed;
  } else {
    float4* op = reinterpret_cast<float4*>(static_cast<float*>(base) + off);
    op[0] = make_float4(v[0], v[1], v[2], v[3]);
    op[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ void finish8_grad(float (&v)[8], int gm, int gn, int N,
                                             const GradEpilogue& ep) {
  const size_t off = static_cast<size_t>(gm) * N + gn;
  if (ep.bias != nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = v[e] + ep.bias[gn + e];
  }
  if (ep.gelu_grad_of != nullptr) {
    const float4* pp = reinterpret_cast<const float4*>(ep.gelu_grad_of + off);
    const float4 p0 = pp[0], p1 = pp[1];
    const float pre[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = v[e] * gelu_fast_grad(pre[e]);
  }
  store8(ep.out, off, ep.out_bf16, v);
  if (ep.out2 != nullptr) {
    float w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e] = ep.out2_gelu ? gelu_fast(v[e]) : v[e];
    store8(ep.out2, off, 1, w);
  }
}

// One [kBK, kBM] slice of A = S^T, S stored [K, M]: staged k-major.
__device__ __forceinline__ void load_a_trans(bf16* as, const bf16* __restrict__ s,
                                             int M, int K, int m0, int k0) {
  for (int i = threadIdx.x; i < kBK * (kBM / 8); i += kThreads) {
    const int r = i / (kBM / 8), c = (i % (kBM / 8)) * 8;
    const bool ok = k0 + r < K && m0 + c < M;
    const bf16* src = ok ? s + static_cast<size_t>(k0 + r) * M + m0 + c : s;
    cp_async16(as + r * kATLd + c, src, ok);
  }
}

// One [kBN, kBK] slice of B = W^T, W stored [N, K]: staged n-major.
__device__ __forceinline__ void load_b_trans(bf16* bs, const bf16* __restrict__ w,
                                             int N, int K, int n0, int k0) {
  for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
    const bool ok = n0 + r < N && k0 + c < K;
    const bf16* src = ok ? w + static_cast<size_t>(n0 + r) * K + k0 + c : w;
    cp_async16(bs + r * kBTLd + c, src, ok);
  }
}

template <bool AT, bool BT>
__device__ __forceinline__ void load_grad_slice(bf16* as, bf16* bs, const bf16* a,
                                                const bf16* b, int M, int N, int K,
                                                int m0, int n0, int k0) {
  if constexpr (AT) load_a_trans(as, a, M, K, m0, k0);
  else load_a_bf16(as, a, M, K, m0, k0);
  if constexpr (BT) load_b_trans(bs, b, N, K, n0, k0);
  else load_b_bf16(bs, b, N, K, n0, k0);
}

template <bool AT, bool BT>
__device__ __forceinline__ void mma_slice_grad(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (
        &acc)[4][2],
    const bf16* a_stage, const bf16* b_stage) {
  using namespace nvcuda;
  using ALayout = typename std::conditional<AT, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64x32
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> af[4];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfr[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wm * 64 + i * 16;
      if constexpr (AT)
        wmma::load_matrix_sync(af[i], a_stage + kk * kATLd + row, kATLd);
      else
        wmma::load_matrix_sync(af[i], a_stage + row * kALd + kk, kALd);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = wn * 32 + j * 16;
      if constexpr (BT)
        wmma::load_matrix_sync(bfr[j], b_stage + col * kBTLd + kk, kBTLd);
      else
        wmma::load_matrix_sync(bfr[j], b_stage + kk * kBLd + col, kBLd);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
  }
}

// out[M, N] = epi(A . B): A is [M, K] row-major, or (AT) stored [K, M];
// B is [K, N] row-major, or (BT) stored [N, K].
template <bool AT, bool BT>
__global__ void __launch_bounds__(kThreads)
grad_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 GradEpilogue ep, int M, int N, int K) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + kStages * kGStage;
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
      load_grad_slice<AT, BT>(as + s * kGStage, bs + s * kGStage, a, b, M, N, K, m0,
                              n0, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt-1's stage is free again
    const int next = kt + kStages - 1;
    if (next < slices)
      load_grad_slice<AT, BT>(as + (next % kStages) * kGStage,
                              bs + (next % kStages) * kGStage, a, b, M, N, K, m0,
                              n0, next * kBK);
    cp_async_commit();
    mma_slice_grad<AT, BT>(acc, as + (kt % kStages) * kGStage,
                           bs + (kt % kStages) * kGStage);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: reuse it as the epilogue staging area

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  float* stage = reinterpret_cast<float*>(smem) + warp * 16 * kEpiLd;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], kEpiLd, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + r;
      const int gn = n0 + wn * 32 + j * 16 + c;
      if (gm < M && gn < N) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = stage[r * kEpiLd + c + e];
        finish8_grad(v, gm, gn, N, ep);
      }
      __syncwarp();
    }
  }
}

template <bool AT, bool BT>
cudaError_t launch_grad_gemm(const void* a, const void* b, const GradEpilogue& ep,
                             int M, int N, int K, cudaStream_t stream) {
  cudaError_t err = allow_dynamic_smem(grad_gemm_kernel<AT, BT>, kSmemBytesGrad);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  grad_gemm_kernel<AT, BT><<<grid, kThreads, kSmemBytesGrad, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), ep, M, N, K);
  return cudaGetLastError();
}

inline bool bad_epilogue(int residual_kind) {
  return residual_kind < kNoResidual || residual_kind > kResidualBF16;
}

}  // namespace vit

VIT_EXPORT int vit_linear_bf16(const void* x, const void* w, const float* bias,
                               const void* residual, int residual_kind,
                               void* out, int out_bf16, int gelu, int M, int N,
                               int K, void* stream) {
  using namespace vit;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 ||
      bad_epilogue(residual_kind))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(linear_bf16_kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  linear_bf16_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      Epilogue{bias, residual, residual_kind, out, out_bf16, gelu}, M, N, K);
  return cudaGetLastError();
}

VIT_EXPORT int vit_linear_int8w(const void* x, const void* w,
                                const float* w_scale, const float* bias,
                                const void* residual, int residual_kind,
                                void* out, int out_bf16, int gelu, int M,
                                int N, int K, void* stream) {
  using namespace vit;
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 8 != 0 ||
      w_scale == nullptr || bad_epilogue(residual_kind))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(linear_int8w_kernel, kSmemBytesInt8W);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  linear_int8w_kernel<<<grid, kThreads, kSmemBytesInt8W,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w), w_scale,
      Epilogue{bias, residual, residual_kind, out, out_bf16, gelu}, M, N, K);
  return cudaGetLastError();
}

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

// out [M, N] = epilogue(A . B) in bf16: A is [M, K] row-major, or (a_trans)
// stored [K, M]; B is [K, N] row-major, or (b_trans) stored [N, K]. The
// dgrad form is (0, 1), the wgrad form (1, 0) with fp32 out, the fc1
// recompute (0, 0) with out2. N and each operand's contiguous axis must be
// multiples of 8; ops/linear.py checks that before calling.
VIT_EXPORT int vit_gemm_grad(const void* a, int a_trans, const void* b, int b_trans,
                             const float* bias, const float* gelu_grad_of, void* out,
                             int out_bf16, void* out2, int out2_gelu, int M, int N,
                             int K, void* stream) {
  using namespace vit;
  // 16-byte loads run along each operand's contiguous axis.
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || (a_trans ? M : K) % 8 != 0 ||
      (b_trans && K % 8 != 0))
    return cudaErrorInvalidValue;
  const GradEpilogue ep{bias, gelu_grad_of, out, out_bf16, static_cast<bf16*>(out2),
                        out2_gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a_trans && !b_trans) return launch_grad_gemm<false, false>(a, b, ep, M, N, K, s);
  if (!a_trans && b_trans) return launch_grad_gemm<false, true>(a, b, ep, M, N, K, s);
  if (a_trans && !b_trans) return launch_grad_gemm<true, false>(a, b, ep, M, N, K, s);
  return launch_grad_gemm<true, true>(a, b, ep, M, N, K, s);
}

// The int8 building blocks of probe_overlap.cu's probe kernels (the W8A8
// GEMMs run on the Hopper core, gemm_sm90.cuh, and use none of them; the
// row quantize's absmax and rounding are common.cuh's):
//   * cp.async copies of 16 bytes, and the ring's commit and wait;
//   * the int8 GEMM's 64-deep slices: an A slice of 128 rows stored as four
//     16-byte column chunks ([4][128][16]), a w slice of 128 columns stored
//     as eight 16-byte column chunks of 64 rows ([8][64][16]), so that every
//     8-bit WMMA fragment starts on a 32-byte boundary; and the products of
//     one slice, each of 8 warps owning a 64x32 sub-tile of int32 16x16x16
//     fragments.
#pragma once

#include "common.cuh"  // cuda_bf16.h before mma.h: the bf16 fragments

#include <mma.h>

namespace vit {

// The int8 GEMM's tile: 128 x 128 outputs, 64-deep slices, 8 warps.
constexpr int kI8BM = 128, kI8BN = 128, kI8BK = 64, kI8Threads = 256;
constexpr int kI8AStage = kI8BM * kI8BK;  // bytes: [kI8BK/16][kI8BM][16]
constexpr int kI8BStage = kI8BK * kI8BN;  // bytes: [kI8BN/16][kI8BK][16]

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

// One 64-deep int8 slice of x [M, K] (rows m0.., columns k0..) into
// [4 chunks][kI8BM rows][16]; the ragged edges are zero-filled.
__device__ __forceinline__ void load_a_slice_int8(int8_t* as,
                                                  const int8_t* __restrict__ x,
                                                  int M, int K, int m0,
                                                  int k0) {
  for (int i = threadIdx.x; i < kI8BM * (kI8BK / 16); i += kI8Threads) {
    const int r = i / (kI8BK / 16), c = i % (kI8BK / 16);
    const bool ok = m0 + r < M && k0 + c * 16 < K;
    const int8_t* src =
        ok ? x + static_cast<size_t>(m0 + r) * K + k0 + c * 16 : x;
    cp_async16(as + (c * kI8BM + r) * 16, src, ok);
  }
}

// One 64-deep int8 slice of w [K, N] (rows k0.., columns n0..) into
// [8 chunks][kI8BK rows][16]; the ragged edges are zero-filled.
__device__ __forceinline__ void load_b_slice_int8(int8_t* bs,
                                                  const int8_t* __restrict__ w,
                                                  int N, int K, int n0,
                                                  int k0) {
  for (int i = threadIdx.x; i < kI8BK * (kI8BN / 16); i += kI8Threads) {
    const int r = i / (kI8BN / 16), c = i % (kI8BN / 16);
    const bool ok = k0 + r < K && n0 + c * 16 < N;
    const int8_t* src =
        ok ? w + static_cast<size_t>(k0 + r) * N + n0 + c * 16 : w;
    cp_async16(bs + (c * kI8BK + r) * 16, src, ok);
  }
}

// The int32 products of one slice: a_stage holds the slice's four column
// chunks of kI8BM rows ([4][kI8BM][16]), b_stage a w slice as loaded above.
// Warp w owns rows (w / 4) * 64 .. +63 and columns (w % 4) * 32 .. +31.
__device__ __forceinline__ void mma_slice_int8(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, int> (
        &acc)[4][2],
    const int8_t* a_stage, const int8_t* b_stage) {
  using namespace nvcuda;
  const int warp = (threadIdx.x / 32) % 8;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64x32
#pragma unroll
  for (int kc = 0; kc < kI8BK / 16; ++kc) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
        af[4];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>
        bfr[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wmma::load_matrix_sync(
          af[i],
          reinterpret_cast<const signed char*>(
              a_stage + (kc * kI8BM + wm * 64 + i * 16) * 16),
          16);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(
          bfr[j],
          reinterpret_cast<const signed char*>(
              b_stage + ((wn * 2 + j) * kI8BK + kc * 16) * 16),
          16);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
  }
}

}  // namespace vit

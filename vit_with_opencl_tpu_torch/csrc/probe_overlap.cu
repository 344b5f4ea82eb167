// The W8A8 overlap probe's kernels: can CUDA-core work (the per-row
// quantize, a LayerNorm) run beside tensor-core int8 GEMM work on one SM?
//
// Replaces the six Pallas kernels of scripts/probe_w8a8_overlap.py (:88-143),
// each with the function it has under main()'s BlockSpecs: a grid of `blocks`
// steps walks M_BLOCK = 1024 rows at a time (8 chunks of 128), and every
// output's index map is constant (_resident), so what remains is the LAST
// block's rows, while every block's work is still done:
//   probe_stream_kernel   _k_stream:    o = x[:8, :128] * 2 of the last block,
//                         after reading every block whole (the TPU's DMA
//                         brings the whole [1024, 768] block in);
//   probe_vpu_kernel      _k_vpu_quant: each row's absmax quantize (int8 q,
//                         fp32 scale = absmax * float(1/127)), or _k_vpu_ln:
//                         LN without affine (mean = E[x], var = E[x^2] -
//                         mean^2, rsqrt(var + 1e-6)), cast to bf16;
//   probe_mxu_kernel      _k_mxu:   bf16(fp32(xq @ w) * sw[n]);
//   probe_fused_kernel    _k_fused: each chunk quantized, then its GEMM:
//                         bf16((fp32(q @ w) * s[m]) * sw[n]);
//   probe_indep_kernel    _k_indep: the quantize (or the LN, with os = the
//                         row's first column) of x_a beside the GEMM of an
//                         unrelated int8 xq_b, with no dependency between
//                         them (vpu_op="quant" or "ln").
// The multiplies are __fmul_rn (never contracted), in the plain version's
// order; |acc| <= 768 * 127 * 127 < 2^24, so fp32(acc) is exact. With the
// same inputs the int8 values, the scales, the stream output and the GEMMs'
// bf16 outputs are bit-identical to the plain versions; the LN's sums run
// in another order and rsqrtf is within 2 ulps, so its bf16 outputs are
// within one bf16 ulp.
//
// Blocks run in parallel here, not in order: one CUDA block takes one
// 128-row chunk (blocks * 8 of them), and only the chunks of the last grid
// step store the outputs. So that no chunk's work can be dropped behind
// that predicate, every warp adds what it computed (the int8 words, the
// bf16 words, the stream's raw words) into a checksum that it writes to
// `scratch` (one word a warp; the wrapper allocates it, it is no output).
//
// Bound on the card at the probe's size (262,144 rows, K = 768, N = 3072):
// the stream, the quantize and the LN read 805 MB of fp32 (bytes, 0.240 ms);
// the GEMMs do 1.237e12 int8 operations (operations, 0.625 ms), above the
// bytes of their inputs. Design, simple first: the row kernels give a warp
// to a row, the 768 values held in registers as 6 float4 a lane (16-byte
// loads, the sums by warp shuffles); the GEMM kernels hold the chunk's int8
// rows in shared memory (96 KiB: quantized there from registers by the fused
// kernel, copied by cp.async otherwise) and stream 64-deep w slices through a
// 3-stage cp.async ring, 8 warps each owning 64x32 of a 128x128 output tile
// of int8 WMMA fragments (int8_tiles.cuh's slices), walking
// the N / 128 tiles of the row chunk. The independent kernel gives the VPU
// work to 4 more warps of the same block, which never wait for the GEMM's 8
// (those synchronise on a named barrier of their own): the card may then
// issue both side by side, as the TPU kernel's interleaving lets Mosaic.
// Not yet done: wgmma, TMA, more than one block an SM (133.6 KB of shared
// memory each).
#include "int8_tiles.cuh"

namespace vit {
namespace probe {

constexpr int kPBlock = 1024;                // M_BLOCK
constexpr int kPChunks = 8;                  // N_CHUNKS
constexpr int kPChunk = kPBlock / kPChunks;  // M_CHUNK: one CUDA block
constexpr int kPK = 768;                     // K
constexpr int kPWarps = 8;
constexpr int kPThreads = kPWarps * 32;
constexpr int kPRowsPerWarp = kPChunk / kPWarps;
constexpr int kVec = kPK / 128;  // float4 loads a lane holds of one row
constexpr int kVpuWarps = 4;     // the independent kernel's extra warps
constexpr int kIndepThreads = kPThreads + kVpuWarps * 32;
constexpr float kEps = 1e-6f;
static_assert(kPChunk == kI8BM && kPThreads == kI8Threads,
              "a chunk is one int8 GEMM tile of rows");
static_assert(kPK % kI8BK == 0, "K is a whole number of slices");

// The GEMM kernels' shared memory: the chunk's int8 rows ([K/16][128][16],
// which is kPK / kI8BK slices of int8_tiles.cuh's A layout), the ring of w
// slices, a 16x20 int32 staging tile a warp for the epilogue, the rows'
// scales (the fused kernel).
constexpr int kSlices = kPK / kI8BK;
constexpr int kRing = 3;
constexpr int kStageLd = 20;
constexpr int kRingOffset = kPChunk * kPK;  // after the chunk's int8 rows
constexpr int kStagingOffset = kRingOffset + kRing * kI8BStage;
constexpr int kScaleOffset = kStagingOffset + kPWarps * 16 * kStageLd * 4;
constexpr int kGemmSmem = kScaleOffset + kPChunk * 4;

// VPU operations of probe_vpu_kernel and probe_indep_kernel.
enum VpuOp : int { kQuant = 0, kLn = 1 };

__device__ __forceinline__ bool in_last_block() {
  return blockIdx.x / kPChunks == gridDim.x / kPChunks - 1;
}
// The chunk's first row within the resident output block.
__device__ __forceinline__ int out_row0() {
  return (blockIdx.x % kPChunks) * kPChunk;
}

// The warp's checksum, one word a warp.
__device__ __forceinline__ void store_fold(unsigned* scratch, unsigned fold) {
  fold = __reduce_add_sync(0xffffffffu, fold);
  if (threadIdx.x % 32 == 0)
    scratch[blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32] = fold;
}

// A row of K fp32 values: lane l holds columns (l + 32 j) * 4 .. + 3.
__device__ __forceinline__ void load_row(const float* __restrict__ xr,
                                         int lane, float4 (&v)[kVec]) {
  const float4* p = reinterpret_cast<const float4*>(xr);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = p[lane + 32 * j];
}

// The row's absmax quantize (models/quant.quantize_act): words[j] packs the
// int8 values of the lane's columns j; returns the row's scale.
__device__ __forceinline__ float quantize_row(const float4 (&v)[kVec],
                                              unsigned (&words)[kVec]) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    amax = fmaxf(fmaxf(fmaxf(amax, fabsf(v[j].x)), fmaxf(fabsf(v[j].y),
                                                          fabsf(v[j].z))),
                 fabsf(v[j].w));
  amax = warp_absmax(amax);
  const float r = 127.0f / amax;  // IEEE division (nvcc's -prec-div=true)
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    char4 c = make_char4(quantize_one(v[j].x, r), quantize_one(v[j].y, r),
                         quantize_one(v[j].z, r), quantize_one(v[j].w, r));
    words[j] = *reinterpret_cast<unsigned*>(&c);
  }
  return __fmul_rn(amax, 1.0f / 127.0f);
}

// LN without affine of the row, in bf16: words[j] holds the lane's
// columns j (E[x^2] - mean^2, as csrc/layernorm.cu).
__device__ __forceinline__ void ln_row(const float4 (&v)[kVec],
                                       uint2 (&words)[kVec]) {
  float sum = 0.f, sum_sq = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    sum += v[j].x + v[j].y + v[j].z + v[j].w;
    sum_sq += v[j].x * v[j].x + v[j].y * v[j].y + v[j].z * v[j].z +
              v[j].w * v[j].w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sum_sq += __shfl_xor_sync(0xffffffffu, sum_sq, off);
  }
  const float mean = sum / kPK;
  const float var = __fsub_rn(sum_sq / kPK, __fmul_rn(mean, mean));
  const float inv = rsqrtf(var + kEps);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    words[j].x = pack_bf16x2(__fmul_rn(__fsub_rn(v[j].x, mean), inv),
                             __fmul_rn(__fsub_rn(v[j].y, mean), inv));
    words[j].y = pack_bf16x2(__fmul_rn(__fsub_rn(v[j].z, mean), inv),
                             __fmul_rn(__fsub_rn(v[j].w, mean), inv));
  }
}

// Row r of this block's chunk through a VPU operation. kQuant: int8 oq and
// os = the scale; kLn: bf16 oq and, where os is given, os = the row's first
// value (_k_indep's os_ref[sl, :] = xa_ref[sl, :1]). Stores only in the last
// grid step; always folds.
template <int kOp>
__device__ __forceinline__ void vpu_row(const float* __restrict__ x, int r,
                                        void* __restrict__ oq,
                                        float* __restrict__ os, bool last,
                                        unsigned& fold) {
  const int lane = threadIdx.x % 32;
  float4 v[kVec];
  load_row(x + (static_cast<size_t>(blockIdx.x) * kPChunk + r) * kPK, lane, v);
  const size_t orow = static_cast<size_t>(out_row0() + r);
  if constexpr (kOp == kQuant) {
    unsigned words[kVec];
    const float scale = quantize_row(v, words);
    unsigned* qr = reinterpret_cast<unsigned*>(static_cast<int8_t*>(oq) +
                                               orow * kPK);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      fold += words[j];
      if (last) qr[lane + 32 * j] = words[j];
    }
    fold += __float_as_uint(scale);
    if (last && lane == 0) os[orow] = scale;
  } else {
    uint2 words[kVec];
    ln_row(v, words);
    uint2* yr = reinterpret_cast<uint2*>(static_cast<bf16*>(oq) + orow * kPK);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      fold += words[j].x + words[j].y;
      if (last) yr[lane + 32 * j] = words[j];
    }
    if (os != nullptr && last && lane == 0) os[orow] = v[0].x;
  }
}

__global__ void __launch_bounds__(kPThreads)
probe_stream_kernel(const float* __restrict__ x, float* __restrict__ o,
                    unsigned* __restrict__ scratch) {
  const float* xc = x + static_cast<size_t>(blockIdx.x) * kPChunk * kPK;
  const uint4* p = reinterpret_cast<const uint4*>(xc);
  unsigned fold = 0;
#pragma unroll 8
  for (int i = threadIdx.x; i < kPChunk * kPK / 4; i += kPThreads) {
    const uint4 u = p[i];
    fold += u.x + u.y + u.z + u.w;
  }
  store_fold(scratch, fold);
  if (in_last_block() && blockIdx.x % kPChunks == 0)
    for (int i = threadIdx.x; i < 8 * 128; i += kPThreads)
      o[i] = __fmul_rn(xc[(i / 128) * kPK + i % 128], 2.0f);
}

template <int kOp>
__global__ void __launch_bounds__(kPThreads)
probe_vpu_kernel(const float* __restrict__ x, void* __restrict__ oq,
                 float* __restrict__ os, unsigned* __restrict__ scratch) {
  const int warp = threadIdx.x / 32;
  const bool last = in_last_block();
  unsigned fold = 0;
  for (int i = 0; i < kPRowsPerWarp; ++i)
    vpu_row<kOp>(x, warp * kPRowsPerWarp + i, oq, os, last, fold);
  store_fold(scratch, fold);
}

// The 8 GEMM warps' barrier (named, so that the independent kernel's VPU
// warps never join it).
__device__ __forceinline__ void gemm_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPThreads) : "memory");
}

// The first kRing - 1 w slices of the tile walk (n tiles of 128 columns, each
// kSlices slices deep), into the ring.
__device__ __forceinline__ void prefetch_w(int8_t* ring,
                                           const int8_t* __restrict__ w,
                                           int n) {
  const int steps = (n / kI8BN) * kSlices;
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < steps)
      load_b_slice_int8(ring + s * kI8BStage, w, n, kPK, (s / kSlices) * kI8BN,
                        (s % kSlices) * kI8BK);
    cp_async_commit();
  }
}

// One output tile's epilogue, a warp at a time: each lane takes 8 columns
// of a row of each staged fragment, o = bf16((fp32(acc) [* s[m]]) * sw[n]).
template <bool kRowScale>
__device__ __forceinline__ void gemm_epilogue(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, int> (
        &acc)[4][2],
    int* stage, const float* row_scale, const float* __restrict__ sw,
    bf16* __restrict__ o, int n0, int n, bool last, unsigned& fold) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], kStageLd, wmma::mem_row_major);
      __syncwarp();
      const int row = wm * 64 + i * 16 + r;  // within the chunk
      const int gn = n0 + wn * 32 + j * 16 + c;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a = __int2float_rn(stage[r * kStageLd + c + e]);
        if constexpr (kRowScale) a = __fmul_rn(a, row_scale[row]);
        v[e] = __fmul_rn(a, sw[gn + e]);
      }
      uint4 packed;
      packed.x = pack_bf16x2(v[0], v[1]);
      packed.y = pack_bf16x2(v[2], v[3]);
      packed.z = pack_bf16x2(v[4], v[5]);
      packed.w = pack_bf16x2(v[6], v[7]);
      fold += packed.x + packed.y + packed.z + packed.w;
      if (last)
        *reinterpret_cast<uint4*>(
            o + static_cast<size_t>(out_row0() + row) * n + gn) = packed;
      __syncwarp();  // the staging tile is rewritten by the next fragment
    }
  }
}

// The chunk's GEMM against w [K, n], tile by tile, by the 8 GEMM warps: the
// int8 rows are in a_tile (or on their way there in the cp.async groups
// committed before prefetch_w), the first w slices in the ring.
template <bool kRowScale>
__device__ __forceinline__ void gemm_chunk(unsigned char* smem,
                                           const int8_t* __restrict__ w,
                                           const float* __restrict__ sw,
                                           bf16* __restrict__ o, int n,
                                           bool last, unsigned& fold) {
  using namespace nvcuda;
  const int8_t* a_tile = reinterpret_cast<const int8_t*>(smem);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + kRingOffset);
  int* stage = reinterpret_cast<int*>(smem + kStagingOffset) +
               (threadIdx.x / 32) * 16 * kStageLd;
  const float* row_scale = reinterpret_cast<const float*>(smem + kScaleOffset);
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
  const int steps = (n / kI8BN) * kSlices;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kRing - 2>();
    gemm_barrier();  // slice t (and the rows) landed; slice t-1's stage is free
    const int next = t + kRing - 1;
    if (next < steps)
      load_b_slice_int8(ring + (next % kRing) * kI8BStage, w, n, kPK,
                        (next / kSlices) * kI8BN, (next % kSlices) * kI8BK);
    cp_async_commit();
    const int ks = t % kSlices;
    mma_slice_int8(acc, a_tile + ks * kI8AStage, ring + (t % kRing) * kI8BStage);
    if (ks == kSlices - 1) {
      gemm_epilogue<kRowScale>(acc, stage, row_scale, sw, o,
                               (t / kSlices) * kI8BN, n, last, fold);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
    }
  }
  cp_async_wait<0>();
}

// The chunk's int8 rows of xq [rows, K] into a_tile, by cp.async (one group).
__device__ __forceinline__ void load_a_chunk(unsigned char* smem,
                                             const int8_t* __restrict__ xq) {
  int8_t* a_tile = reinterpret_cast<int8_t*>(smem);
  const int rows = gridDim.x * kPChunk;
#pragma unroll
  for (int s = 0; s < kSlices; ++s)
    load_a_slice_int8(a_tile + s * kI8AStage, xq, rows, kPK,
                      blockIdx.x * kPChunk, s * kI8BK);
  cp_async_commit();
}

__global__ void __launch_bounds__(kPThreads, 1)
probe_mxu_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                 const float* __restrict__ sw, bf16* __restrict__ o,
                 unsigned* __restrict__ scratch, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned fold = 0;
  load_a_chunk(smem, xq);
  prefetch_w(reinterpret_cast<int8_t*>(smem + kRingOffset), w, n);
  gemm_chunk<false>(smem, w, sw, o, n, in_last_block(), fold);
  store_fold(scratch, fold);
}

__global__ void __launch_bounds__(kPThreads, 1)
probe_fused_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sw, bf16* __restrict__ o,
                   unsigned* __restrict__ scratch, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned fold = 0;
  prefetch_w(reinterpret_cast<int8_t*>(smem + kRingOffset), w, n);
  // Quantize the chunk from registers into a_tile's layout: the lane's word
  // j holds columns col .. col + 3, col = (lane + 32 j) * 4, in 16-byte
  // column chunk col / 16.
  float* row_scale = reinterpret_cast<float*>(smem + kScaleOffset);
  for (int i = 0; i < kPRowsPerWarp; ++i) {
    const int r = warp * kPRowsPerWarp + i;
    float4 v[kVec];
    load_row(x + (static_cast<size_t>(blockIdx.x) * kPChunk + r) * kPK, lane,
             v);
    unsigned words[kVec];
    const float scale = quantize_row(v, words);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int col = (lane + 32 * j) * 4;
      *reinterpret_cast<unsigned*>(smem + ((col / 16) * kPChunk + r) * 16 +
                                   col % 16) = words[j];
    }
    if (lane == 0) row_scale[r] = scale;
  }
  gemm_chunk<true>(smem, w, sw, o, n, in_last_block(), fold);
  store_fold(scratch, fold);
}

// Warps 0-7: the GEMM of xq_b's chunk; warps 8-11: the VPU operation on
// x_a's chunk (32 rows each). No barrier joins the two groups.
template <int kOp>
__global__ void __launch_bounds__(kIndepThreads, 1)
probe_indep_kernel(const float* __restrict__ xa,
                   const int8_t* __restrict__ xqb,
                   const int8_t* __restrict__ w, const float* __restrict__ sw,
                   void* __restrict__ oq, float* __restrict__ os,
                   bf16* __restrict__ o, unsigned* __restrict__ scratch,
                   int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const bool last = in_last_block();
  unsigned fold = 0;
  if (warp < kPWarps) {
    load_a_chunk(smem, xqb);
    prefetch_w(reinterpret_cast<int8_t*>(smem + kRingOffset), w, n);
    gemm_chunk<false>(smem, w, sw, o, n, last, fold);
  } else {
    constexpr int kRows = kPChunk / kVpuWarps;
    for (int i = 0; i < kRows; ++i)
      vpu_row<kOp>(xa, (warp - kPWarps) * kRows + i, oq, os, last, fold);
  }
  store_fold(scratch, fold);
}

bool bad_shape(int blocks, int n) {
  return blocks <= 0 || n <= 0 || n % kI8BN != 0;
}

}  // namespace probe
}  // namespace vit

// x fp32 [blocks * 1024, 768] -> o fp32 [8, 128]; scratch: blocks * 64 words.
VIT_EXPORT int vit_probe_stream(const float* x, float* o, unsigned* scratch,
                                int blocks, void* stream) {
  using namespace vit;
  using namespace vit::probe;
  if (blocks <= 0) return cudaErrorInvalidValue;
  probe_stream_kernel<<<blocks * kPChunks, kPThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, o, scratch);
  return cudaGetLastError();
}

// x fp32 [blocks * 1024, 768] -> ln = 0: q int8 [1024, 768] and scale fp32
// [1024, 1]; ln = 1: y bf16 [1024, 768] (scale unused); scratch: blocks * 64.
VIT_EXPORT int vit_probe_vpu(const float* x, int ln, void* out, float* scale,
                             unsigned* scratch, int blocks, void* stream) {
  using namespace vit;
  using namespace vit::probe;
  if (blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln)
    probe_vpu_kernel<kLn><<<blocks * kPChunks, kPThreads, 0, s>>>(
        x, out, nullptr, scratch);
  else
    probe_vpu_kernel<kQuant><<<blocks * kPChunks, kPThreads, 0, s>>>(
        x, out, scale, scratch);
  return cudaGetLastError();
}

// xq int8 [blocks * 1024, 768], w int8 [768, n], sw fp32 [n] -> o bf16
// [1024, n]; n a multiple of 128; scratch: blocks * 64 words.
VIT_EXPORT int vit_probe_mxu(const void* xq, const void* w, const float* sw,
                             void* o, unsigned* scratch, int blocks, int n,
                             void* stream) {
  using namespace vit;
  using namespace vit::probe;
  if (bad_shape(blocks, n)) return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(probe_mxu_kernel, kGemmSmem);
  if (err != cudaSuccess) return err;
  probe_mxu_kernel<<<blocks * kPChunks, kPThreads, kGemmSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w), sw,
      static_cast<bf16*>(o), scratch, n);
  return cudaGetLastError();
}

// x fp32 [blocks * 1024, 768], w, sw as above -> o bf16 [1024, n].
VIT_EXPORT int vit_probe_fused(const float* x, const void* w, const float* sw,
                               void* o, unsigned* scratch, int blocks, int n,
                               void* stream) {
  using namespace vit;
  using namespace vit::probe;
  if (bad_shape(blocks, n)) return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(probe_fused_kernel, kGemmSmem);
  if (err != cudaSuccess) return err;
  probe_fused_kernel<<<blocks * kPChunks, kPThreads, kGemmSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const int8_t*>(w), sw, static_cast<bf16*>(o), scratch,
      n);
  return cudaGetLastError();
}

// xa fp32 and xqb int8 [blocks * 1024, 768], w, sw as above -> ln = 0: oq
// int8 [1024, 768], os fp32 [1024, 1] (the scales); ln = 1: oq bf16, os the
// rows' first values; and o bf16 [1024, n]; scratch: blocks * 96 words.
VIT_EXPORT int vit_probe_indep(const float* xa, const void* xqb, const void* w,
                               const float* sw, int ln, void* oq, float* os,
                               void* o, unsigned* scratch, int blocks, int n,
                               void* stream) {
  using namespace vit;
  using namespace vit::probe;
  if (bad_shape(blocks, n)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xqb8 = static_cast<const int8_t*>(xqb);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  bf16* o16 = static_cast<bf16*>(o);
  cudaError_t err;
  if (ln) {
    err = allow_dynamic_smem(probe_indep_kernel<kLn>, kGemmSmem);
    if (err != cudaSuccess) return err;
    probe_indep_kernel<kLn><<<blocks * kPChunks, kIndepThreads, kGemmSmem, s>>>(
        xa, xqb8, w8, sw, oq, os, o16, scratch, n);
  } else {
    err = allow_dynamic_smem(probe_indep_kernel<kQuant>, kGemmSmem);
    if (err != cudaSuccess) return err;
    probe_indep_kernel<kQuant><<<blocks * kPChunks, kIndepThreads, kGemmSmem,
                                 s>>>(xa, xqb8, w8, sw, oq, os, o16, scratch,
                                      n);
  }
  return cudaGetLastError();
}

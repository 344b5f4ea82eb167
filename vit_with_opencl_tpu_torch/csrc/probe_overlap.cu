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
// Blocks run in parallel here, not in order, and only the chunks of the
// last grid step store the outputs. So that no chunk's work can be dropped
// behind that predicate, every warp adds what it computed (the int8 words,
// the bf16 words, the stream's raw words) into a checksum that it writes to
// `scratch` (one word a warp of the launched grid; the wrapper allocates it,
// it is no output).
//
// Bound on the card at the probe's size (262,144 rows, K = 768, N = 3072):
// the stream, the quantize and the LN read 805 MB of fp32 (bytes, 0.240 ms);
// the GEMMs do 1.237e12 int8 operations (operations, 0.625 ms), above the
// bytes of their inputs.
//
// Row kernels (stream, vpu): a CUDA block a 128-row chunk (blocks * 8 of
// them), a warp a row, the 768 values held in registers as 6 float4 a lane
// (16-byte loads, the sums by warp shuffles).
//
// GEMM kernels (mxu, fused, indep): Hopper's wgmma and TMA, on the GEMM
// core's int8 layout (gemm_sm90.cuh). A persistent grid (a block an SM at
// most) walks the 128-row chunks, c = blockIdx.x, + gridDim.x, ... A chunk's
// int8 A tile (128 x 768 = 96 KiB) stays in shared memory for all N / 128
// column tiles, as six 128-deep K-major slices in the 128-byte swizzle that
// a 128 x 128-byte TMA box writes; w, stored K-major ([N, K] rows:
// models/quant.k_major, int8 wgmma reads no other layout), streams through
// a ring of kStages 128 x 128-byte slices that one producer thread keeps
// full by TMA. Two consumer warpgroups take the chunk's column tiles in
// turns (a block's tiles numbered across its chunks, even ones to warpgroup
// 0), each a whole 128 x 128 tile as two m64n128k32 s8 products per 32-byte
// step into int32 accumulators, so that one's epilogue (convert, scale,
// bf16, fold, and the last block's stores straight from registers) runs
// under the other's products. setmaxnreg gives the registers to the
// consumers. Walking the core's (m-tile, n-tile) units instead would read
// each A tile once per column tile from L2 (about 4.8 GB a call at the
// probe's size) on top of w's 4.8 GB (2048 chunks x 2.36 MB).
//   mxu:   A comes by TMA, a barrier pair a slice: slice s of the next chunk
//          is loaded as soon as both warpgroups' last products on slice s
//          of this one are done, under the chunk's last tile.
//   fused: the consumers quantize the chunk's fp32 rows (18b's held row, a
//          warp a row, four rows in flight) straight into the swizzled A
//          slices and the row scales into shared memory, fence the writes
//          for the async proxy, meet at a named barrier and run the
//          products; the producer fetches w meanwhile. A is not double
//          buffered: quantizing chunk c + 1 beside chunk c's products is the
//          optimisation this probe exists to judge.
//   indep: mxu's warpgroups plus a fourth, which does the row work on x_a
//          (a warp a row, rows in a fixed stride over the grid's warps,
//          independent of the chunks) and shares no barrier with the GEMM's.
#include "sm90.cuh"

namespace vit {
namespace probe {

constexpr int kPBlock = 1024;                // M_BLOCK
constexpr int kPChunks = 8;                  // N_CHUNKS
constexpr int kPChunk = kPBlock / kPChunks;  // M_CHUNK
constexpr int kPK = 768;                     // K
constexpr int kPWarps = 8;                   // the row kernels' blocks
constexpr int kPThreads = kPWarps * 32;
constexpr int kPRowsPerWarp = kPChunk / kPWarps;
constexpr int kVec = kPK / 128;  // float4 loads a lane holds of one row
constexpr float kEps = 1e-6f;

// The GEMM kernels: a 128-column tile, 128-byte K slices (one TMA box of
// 128 rows, or 128 columns of w, by 128 bytes), the ring's stages.
constexpr int kBN = 128;
constexpr int kSlice = 128;
constexpr int kSlices = kPK / kSlice;
constexpr int kSliceBytes = kPChunk * kSlice;  // 16 KiB
constexpr int kStages = 8;
static_assert(kBN * kSlice == kSliceBytes, "a w slice is an A slice's size");
// Shared memory, from a 1024-byte-aligned base (the swizzle's atoms): the A
// tile, the ring, the chunk's row scales (fused), then the barriers: the
// ring's full and empty, A's full and empty a slice (mxu, indep), the two
// consumers' turns.
constexpr int kRingOff = kSlices * kSliceBytes;
constexpr int kScaleOff = kRingOff + kStages * kSliceBytes;
constexpr int kBarOff = kScaleOff + kPChunk * 4;
constexpr int kBars = 2 * kStages + 2 * kSlices + 2;
constexpr int kGemmSmem = 1024 + kBarOff + kBars * 8;
static_assert(kGemmSmem <= 232448, "an H100 block's shared memory");
// Warpgroups: the producer, two consumers, (indep) the row warpgroup; the
// registers each holds after setmaxnreg (the sums are 168 x 384 and 128 x
// 512, what ptxas gives a thread at those launch bounds).
constexpr int kGemmThreads = 384, kIndepThreads = 512;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kIndepProducerRegs = 24, kIndepConsumerRegs = 208, kRowRegs = 72;
static_assert(kProducerRegs + 2 * kConsumerRegs <= 168 * 3, "384 threads' registers");
static_assert(kIndepProducerRegs + 2 * kIndepConsumerRegs + kRowRegs <= 128 * 4,
              "512 threads' registers");
constexpr int kRowWarps = 4;  // indep's row warpgroup
constexpr int kQuantRows = 4;  // fused: rows a warp holds at once
static_assert((kGemmThreads - 128) / 32 == kPWarps,
              "fused: the consumers' 8 warps quantize kPRowsPerWarp rows each");

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

// Row xr through a VPU operation, by one warp. kQuant: int8 oq and os = the
// scale; kLn: bf16 oq and, where os is given, os = the row's first value
// (_k_indep's os_ref[sl, :] = xa_ref[sl, :1]). Stores at output row orow
// where it is >= 0 (the last grid step's rows); always folds.
template <int kOp>
__device__ __forceinline__ void vpu_row(const float* __restrict__ xr, int orow,
                                        void* __restrict__ oq,
                                        float* __restrict__ os,
                                        unsigned& fold) {
  const int lane = threadIdx.x % 32;
  float4 v[kVec];
  load_row(xr, lane, v);
  const bool last = orow >= 0;
  if constexpr (kOp == kQuant) {
    unsigned words[kVec];
    const float scale = quantize_row(v, words);
    unsigned* qr = reinterpret_cast<unsigned*>(static_cast<int8_t*>(oq) +
                                               static_cast<size_t>(orow) * kPK);
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
    uint2* yr = reinterpret_cast<uint2*>(static_cast<bf16*>(oq) +
                                         static_cast<size_t>(orow) * kPK);
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
  for (int i = 0; i < kPRowsPerWarp; ++i) {
    const int r = warp * kPRowsPerWarp + i;
    vpu_row<kOp>(x + (static_cast<size_t>(blockIdx.x) * kPChunk + r) * kPK,
                 last ? out_row0() + r : -1, oq, os, fold);
  }
  store_fold(scratch, fold);
}

// ---------------------------------------------------------------------------
// The GEMM kernels.
// ---------------------------------------------------------------------------

// The block's shared memory and barriers (shared-space addresses).
struct Smem {
  unsigned char* base;  // the A tile, then the ring
  uint32_t a, ring, full, empty, a_full, a_empty, turns;
  float* row_scale;
};

__device__ __forceinline__ Smem smem_layout(unsigned char* raw) {
  Smem m;
  m.base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  m.a = sm90::smem_u32(m.base);
  m.ring = m.a + kRingOff;
  m.full = m.a + kBarOff;
  m.empty = m.full + 8 * kStages;
  m.a_full = m.empty + 8 * kStages;
  m.a_empty = m.a_full + 8 * kSlices;
  m.turns = m.a_empty + 8 * kSlices;
  m.row_scale = reinterpret_cast<float*>(m.base + kScaleOff);
  return m;
}

// By thread 0, before the block's __syncthreads: the ring's full barriers
// take the producer's expect_tx, its empty ones the consuming warpgroup's
// 128 threads; A's full ones the producer's, its empty ones both consumers'
// 256 threads once a chunk; a turn the other consumer's 128.
__device__ __forceinline__ void init_barriers(const Smem& m) {
  using namespace sm90;
  for (int s = 0; s < kStages; ++s) {
    mbar_init(m.full + 8 * s, 1);
    mbar_init(m.empty + 8 * s, 128);
  }
  for (int s = 0; s < kSlices; ++s) {
    mbar_init(m.a_full + 8 * s, 1);
    mbar_init(m.a_empty + 8 * s, 256);
  }
  mbar_init(m.turns, 128);
  mbar_init(m.turns + 8, 128);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's one thread: for each of the block's chunks, its tiles'
// w slices in the consumers' order into the ring, and (kLoadA) the chunk's
// A slices by TMA, slice s just before the first tile's slice s.
template <bool kLoadA>
__device__ __forceinline__ void produce(const Smem& m, const CUtensorMap* map_x,
                                        const CUtensorMap* map_w, int chunks,
                                        int tiles) {
  using namespace sm90;
  int stage = 0;
  uint32_t phase = 0;
  for (int c = blockIdx.x, cl = 0; c < chunks; c += gridDim.x, ++cl) {
    for (int tile = 0; tile < tiles; ++tile) {
      for (int s = 0; s < kSlices; ++s) {
        if (kLoadA && tile == 0) {
          // The last chunk's reads of slice s are done (the first passes).
          mbar_wait(m.a_empty + 8 * s, (cl & 1) ^ 1);
          mbar_expect_tx(m.a_full + 8 * s, kSliceBytes);
          tma_load(m.a + s * kSliceBytes, map_x, s * kSlice, c * kPChunk,
                   m.a_full + 8 * s);
        }
        mbar_wait(m.empty + 8 * stage, phase ^ 1);  // the first round passes
        mbar_expect_tx(m.full + 8 * stage, kSliceBytes);
        tma_load(m.ring + stage * kSliceBytes, map_w, s * kSlice, tile * kBN,
                 m.full + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

// The named barrier of the two consumer warpgroups (fused).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// fused: the chunk's 128 fp32 rows at xc quantized by the consumers' 8
// warps (16 rows each, kQuantRows at a time) into the A slices, each
// lane's word j (columns 4 * lane + 128 j ..+3) into slice j at row r's
// 16-byte chunk lane / 4, swizzled as TMA would (chunk ^ r % 8); the scales
// into m.row_scale.
__device__ __forceinline__ void quantize_chunk(const Smem& m,
                                               const float* __restrict__ xc,
                                               int ct) {
  const int warp = ct / 32, lane = ct % 32;
#pragma unroll 1
  for (int i0 = 0; i0 < kPRowsPerWarp; i0 += kQuantRows) {
    float4 v[kQuantRows][kVec];
#pragma unroll
    for (int b = 0; b < kQuantRows; ++b)
      load_row(xc + static_cast<size_t>(warp * kPRowsPerWarp + i0 + b) * kPK, lane,
               v[b]);
#pragma unroll
    for (int b = 0; b < kQuantRows; ++b) {
      const int r = warp * kPRowsPerWarp + i0 + b;
      unsigned words[kVec];
      const float scale = quantize_row(v[b], words);
      unsigned char* row = m.base + r * kSlice + (lane % 4) * 4;
      const int chunk = ((lane / 4) ^ (r % 8)) * 16;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        *reinterpret_cast<unsigned*>(row + j * kSliceBytes + chunk) = words[j];
      if (lane == 0) m.row_scale[r] = scale;
    }
  }
}

// One tile's epilogue by consumer thread t (0..127) from its accumulators
// (acc[h]: rows 64h.. of the tile in wgmma's layout: for each 8-column
// group j, columns 8j + 2(t%4) + {0, 1} of row 16(t/32) + (t%32)/4, then of
// the row 8 below): o = bf16((fp32(acc) [* s[m]]) * sw[n]), each pair
// packed, folded, and stored at output row orow0 + row where orow0 >= 0.
template <bool kRowScale>
__device__ __forceinline__ void tile_epilogue(const int32_t (&acc)[2][64],
                                              const float* row_scale,
                                              const float* __restrict__ sw,
                                              bf16* __restrict__ o, int orow0,
                                              int n0, int n, int t,
                                              unsigned& fold) {
  const int r = (t / 32) * 16 + (t % 32) / 4, cq = 2 * (t % 4);
  float sx[2][2];
  if constexpr (kRowScale) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) sx[h][e] = row_scale[64 * h + r + 8 * e];
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + cq;
    const float2 s = __ldg(reinterpret_cast<const float2*>(sw + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * e;
        float v0 = __int2float_rn(acc[h][i]), v1 = __int2float_rn(acc[h][i + 1]);
        if constexpr (kRowScale) {
          v0 = __fmul_rn(v0, sx[h][e]);
          v1 = __fmul_rn(v1, sx[h][e]);
        }
        const uint32_t p = pack_bf16x2(__fmul_rn(v0, s.x), __fmul_rn(v1, s.y));
        fold += p;
        if (orow0 >= 0)
          *reinterpret_cast<uint32_t*>(
              o + static_cast<size_t>(orow0 + 64 * h + r + 8 * e) * n + col) = p;
      }
    }
  }
}

// A consumer warpgroup (wg 0 or 1; threads 128 (wg + 1) ..) over the
// block's chunks: its column tiles (the block's u-th tile to warpgroup u %
// 2), each through the ring's kSlices w slices against the chunk's A, then
// the epilogue. kFused: the two warpgroups first quantize the chunk into A.
// Else A's slices arrive by TMA; each warpgroup releases slice s once its
// last products of the chunk on it are done (at once where it has no tile
// in the chunk: one tile a chunk, n = 128).
template <bool kFused>
__device__ __forceinline__ void consume(const Smem& m, const float* __restrict__ xf,
                                        const float* __restrict__ sw,
                                        bf16* __restrict__ o, int chunks, int n,
                                        unsigned& fold) {
  using namespace sm90;
  const int wg = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
  const int tiles = n / kBN;
  int stage = 0, u = 0;
  uint32_t phase = 0, turn_phase = 0;
  bool first = wg == 0;
  for (int c = blockIdx.x, cl = 0; c < chunks; c += gridDim.x, ++cl) {
    const int orow0 = c >= chunks - kPChunks ? (c % kPChunks) * kPChunk : -1;
    if constexpr (kFused) {
      consumers_sync();  // the last chunk's products are done (waited below)
      quantize_chunk(m, xf + static_cast<size_t>(c) * kPChunk * kPK, threadIdx.x - 128);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync();
    }
    bool had_tile = false;
    for (int tile = 0; tile < tiles; ++tile, ++u) {
      if ((u & 1) != wg) {  // the other warpgroup's tile: step over its stages
        const int s = stage + kSlices;
        phase ^= (s / kStages) & 1;
        stage = s % kStages;
        continue;
      }
      had_tile = true;
      const bool release_a = !kFused && tile + 2 >= tiles;  // its last of the chunk
      if (!first) {
        mbar_wait(m.turns + 8 * wg, turn_phase);
        turn_phase ^= 1;
      }
      first = false;
      int32_t acc[2][64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;
      int prev = -1;
#pragma unroll 1
      for (int s = 0; s < kSlices; ++s) {
        if constexpr (!kFused) mbar_wait(m.a_full + 8 * s, cl & 1);
        mbar_wait(m.full + 8 * stage, phase);
        const uint32_t a = m.a + s * kSliceBytes, b = m.ring + stage * kSliceBytes;
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlice / 32; ++kk) {
          const uint64_t db = smem_desc(b + kk * 32, 16, 1024);
          wgmma_m64n128k32_s8(acc[0], smem_desc(a + kk * 32, 16, 1024), db);
          wgmma_m64n128k32_s8(acc[1], smem_desc(a + kSliceBytes / 2 + kk * 32, 16, 1024),
                              db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's products are done
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (prev >= 0) {
          mbar_arrive(m.empty + 8 * prev);
          if (release_a) mbar_arrive(m.a_empty + 8 * (s - 1));
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_arrive(m.turns + 8 * (1 - wg));  // the other's turn
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      mbar_arrive(m.empty + 8 * prev);
      if (release_a) mbar_arrive(m.a_empty + 8 * (kSlices - 1));
      tile_epilogue<kFused>(acc, m.row_scale, sw, o, orow0, tile * kBN, n, t, fold);
    }
    if (!kFused && !had_tile) {
      for (int s = 0; s < kSlices; ++s) {
        mbar_wait(m.a_full + 8 * s, cl & 1);
        mbar_arrive(m.a_empty + 8 * s);
      }
    }
  }
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// map_x: xq's map ([rows, 768] int8, 128 x 128-byte boxes); map_w: w's
// ([n, 768] K-major rows, the same boxes).
__global__ void __launch_bounds__(kGemmThreads, 1)
probe_mxu_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const float* __restrict__ sw, bf16* __restrict__ o,
                 unsigned* __restrict__ scratch, int chunks, int n) {
  extern __shared__ unsigned char smem_raw[];
  const Smem m = smem_layout(smem_raw);
  if (threadIdx.x == 0) init_barriers(m);
  __syncthreads();
  if (threadIdx.x < 128) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce<true>(m, &map_x, &map_w, chunks, n / kBN);
  } else {
    regs_inc<kConsumerRegs>();
    unsigned fold = 0;
    consume<false>(m, nullptr, sw, o, chunks, n, fold);
    store_fold(scratch, fold);
  }
}

__global__ void __launch_bounds__(kGemmThreads, 1)
probe_fused_kernel(const float* __restrict__ x,
                   const __grid_constant__ CUtensorMap map_w,
                   const float* __restrict__ sw, bf16* __restrict__ o,
                   unsigned* __restrict__ scratch, int chunks, int n) {
  extern __shared__ unsigned char smem_raw[];
  const Smem m = smem_layout(smem_raw);
  if (threadIdx.x == 0) init_barriers(m);
  __syncthreads();
  if (threadIdx.x < 128) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce<false>(m, nullptr, &map_w, chunks, n / kBN);
  } else {
    regs_inc<kConsumerRegs>();
    unsigned fold = 0;
    consume<true>(m, x, sw, o, chunks, n, fold);
    store_fold(scratch, fold);
  }
}

// Warpgroups 0-2: the GEMM of xq_b's chunks, as probe_mxu_kernel; warpgroup
// 3: the VPU operation on x_a's rows gw, gw + G, ... (gw this warp's index
// among the grid's G row warps). No barrier joins the two.
template <int kOp>
__global__ void __launch_bounds__(kIndepThreads, 1)
probe_indep_kernel(const float* __restrict__ xa,
                   const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const float* __restrict__ sw, void* __restrict__ oq,
                   float* __restrict__ os, bf16* __restrict__ o,
                   unsigned* __restrict__ scratch, int chunks, int n) {
  extern __shared__ unsigned char smem_raw[];
  const Smem m = smem_layout(smem_raw);
  if (threadIdx.x == 0) init_barriers(m);
  __syncthreads();
  if (threadIdx.x < 128) {
    regs_dec<kIndepProducerRegs>();
    if (threadIdx.x == 0) produce<true>(m, &map_x, &map_w, chunks, n / kBN);
  } else if (threadIdx.x < 3 * 128) {
    regs_inc<kIndepConsumerRegs>();
    unsigned fold = 0;
    consume<false>(m, nullptr, sw, o, chunks, n, fold);
    store_fold(scratch, fold);
  } else {
    regs_dec<kRowRegs>();
    const int rows = chunks * kPChunk, first_out = rows - kPBlock;
    const int stride = gridDim.x * kRowWarps;
    unsigned fold = 0;
#pragma unroll 1
    for (int r = blockIdx.x * kRowWarps + (threadIdx.x - 3 * 128) / 32; r < rows;
         r += stride)
      vpu_row<kOp>(xa + static_cast<size_t>(r) * kPK, r >= first_out ? r - first_out : -1,
                   oq, os, fold);
    store_fold(scratch, fold);
  }
}

// The GEMM kernels' checks and tensor maps: blocks of 1024 rows, n a
// multiple of 128, w K-major with rows ldw bytes apart (ldw >= 768, a
// multiple of 16), a grid of 1 to blocks * 8 blocks. xq null: no map_x.
cudaError_t gemm_maps(const void* xq, const void* w, int ldw, int blocks, int n,
                      int grid, CUtensorMap* map_x, CUtensorMap* map_w) {
  using namespace sm90;
  if (blocks <= 0 || n <= 0 || n % kBN != 0 || ldw < kPK || ldw % 16 != 0 ||
      grid <= 0 || grid > blocks * kPChunks)
    return cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  *map_x = {};
  const bool ok =
      (xq == nullptr ||
       encode_map(map_x, encode, xq, 1, kPK, static_cast<long long>(blocks) * kPBlock,
                  kPChunk)) &&
      encode_map(map_w, encode, w, 1, kPK, n, kBN, ldw);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
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

// xq int8 [blocks * 1024, 768], w int8 [768, n] stored K-major (n rows of
// 768 bytes, ldw bytes apart), sw fp32 [n] -> o bf16 [1024, n]; n a
// multiple of 128; `grid` persistent blocks (at most blocks * 8); scratch:
// grid * 12 words.
VIT_EXPORT int vit_probe_mxu(const void* xq, const void* w, int ldw, const float* sw,
                             void* o, unsigned* scratch, int blocks, int n, int grid,
                             void* stream) {
  using namespace vit;
  using namespace vit::probe;
  CUtensorMap map_x, map_w;
  cudaError_t err = gemm_maps(xq, w, ldw, blocks, n, grid, &map_x, &map_w);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(probe_mxu_kernel, kGemmSmem);
  if (err != cudaSuccess) return err;
  probe_mxu_kernel<<<grid, kGemmThreads, kGemmSmem, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, sw, static_cast<bf16*>(o), scratch, blocks * kPChunks, n);
  return cudaGetLastError();
}

// x fp32 [blocks * 1024, 768], w, sw, grid as above -> o bf16 [1024, n];
// scratch: grid * 12 words.
VIT_EXPORT int vit_probe_fused(const float* x, const void* w, int ldw, const float* sw,
                               void* o, unsigned* scratch, int blocks, int n, int grid,
                               void* stream) {
  using namespace vit;
  using namespace vit::probe;
  CUtensorMap map_x, map_w;
  cudaError_t err = gemm_maps(nullptr, w, ldw, blocks, n, grid, &map_x, &map_w);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(probe_fused_kernel, kGemmSmem);
  if (err != cudaSuccess) return err;
  probe_fused_kernel<<<grid, kGemmThreads, kGemmSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, map_w, sw, static_cast<bf16*>(o), scratch, blocks * kPChunks, n);
  return cudaGetLastError();
}

// xa fp32 and xqb int8 [blocks * 1024, 768], w, sw, grid as above -> ln = 0:
// oq int8 [1024, 768], os fp32 [1024, 1] (the scales); ln = 1: oq bf16, os
// the rows' first values; and o bf16 [1024, n]; scratch: grid * 16 words.
VIT_EXPORT int vit_probe_indep(const float* xa, const void* xqb, const void* w, int ldw,
                               const float* sw, int ln, void* oq, float* os, void* o,
                               unsigned* scratch, int blocks, int n, int grid,
                               void* stream) {
  using namespace vit;
  using namespace vit::probe;
  CUtensorMap map_x, map_w;
  cudaError_t err = gemm_maps(xqb, w, ldw, blocks, n, grid, &map_x, &map_w);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = blocks * kPChunks;
  bf16* o16 = static_cast<bf16*>(o);
  if (ln) {
    err = allow_dynamic_smem(probe_indep_kernel<kLn>, kGemmSmem);
    if (err != cudaSuccess) return err;
    probe_indep_kernel<kLn><<<grid, kIndepThreads, kGemmSmem, s>>>(
        xa, map_x, map_w, sw, oq, os, o16, scratch, chunks, n);
  } else {
    err = allow_dynamic_smem(probe_indep_kernel<kQuant>, kGemmSmem);
    if (err != cudaSuccess) return err;
    probe_indep_kernel<kQuant><<<grid, kIndepThreads, kGemmSmem, s>>>(
        xa, map_x, map_w, sw, oq, os, o16, scratch, chunks, n);
  }
  return cudaGetLastError();
}

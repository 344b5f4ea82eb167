// Per-row symmetric int8 quantization with a dynamic absmax scale.
//
// Replaces the per-token quantize that ops/fused_block.py:_block_kernel runs
// in front of each of its four int8 GEMMs when w8a8=True (_quantize_rows,
// which is models/quant.py:quantize_act). Contract, for each row of K values:
//   absmax = max(max_k |x_k|, 2^-93)       the floor keeps a zero row finite
//   r      = 127 / absmax                  one IEEE divide per row
//   q_k    = round_half_even(x_k * r)      as int8; no clip is needed, since
//                                          |x_k * r| <= 127 * (1 + 2^-23)
//   scale  = absmax * float(1/127)         a multiply, not a divide
// The input is fp32 (the LN outputs and the GELU'd hidden of the encoder
// chain) or bf16 (the attention context), upcast exactly. Build without
// --use_fast_math: it would turn the divide into an approximate one.
//
// Bound on the card: bytes, M*K*(in + 1) + 4*M. Design: a row is read once,
// in 16-byte vectors (4 fp32 or 8 bf16 values a lane an instruction), and
// held in registers as the raw words it was loaded as, from its load to its
// int8 write. At the widths of the presets' chains (D = 192, 384, 768,
// 1024, 1280, 1664; their MLP widths 768, 1536, 3072, 4096, 5120, 8192)
// the vectors a lane are a compile-time count (common.cuh's RowShape), so
// every load of a lane is issued before the absmax reduction starts: a
// group of 4-32 lanes takes a row, and reduces its absmax with xor shuffles;
// a row whose share would pass 16 vectors a lane takes two warps (3072 and
// 4096 fp32, 5120 and 8192 bf16) or four (5120 and 8192 fp32), which cross
// their absmax through shared memory. The codes
// leave as one 4- or 8-byte store a vector, coalesced across the lanes;
// the scale once a row. A block holds 1 to 4 warps, fewer where the rows
// are few (row_launch). Any other width takes the general form: a warp a
// row, lanes striding over it four values at a time, the row read twice
// (the absmax, then the codes; the second read from L1/L2).
// Not yet done: fusing this pass into the LN kernel or the producing GEMM's
// epilogue, which would save a round trip of the activation.
//
// Two forms for the calibrated outlier-aware W8A8 layer (_block_kernel with
// outlier=True), with the same exactness rules:
//   quantize_rows_split_kernel   _mm with hi_ref (fused_block.py:108-116):
//     the fp32 LN output or GELU'd hidden; the leading m of each row's K
//     values are quantized as above (the absmax over those m only; q has
//     row stride m), and the trailing K - m are rounded to bf16 for the side
//     GEMM from the same registers (__float2bfloat16_rn: round to nearest
//     even, as XLA's convert). The row is read once and held as above at
//     the same widths (m stays a run-time value: m is a multiple of 4, so
//     no vector straddles it); other widths take the general form's loop;
//   quantize_rows_masked_row_kernel  _mm_ctx_masked (fused_block.py:128-152):
//     the bf16 attention context, whose per-head tails (the last kh of each
//     head's head_dim columns) are left out of the absmax and clipped to
//     +-127 before the int8 cast (they can exceed the kept absmax; their
//     weight rows are zero), and copied out in head order for the side GEMM.
//     The row is read once and held as above at the presets' (num_heads *
//     head_dim, head_dim) pairs, head_dim a compile-time value and kh a
//     run-time one; the tails are staged in shared memory and leave in
//     coalesced stores. Other pairs take the general form
//     (quantize_rows_masked_kernel: a warp a row, the row read twice).
// Bound: bytes, M*(4*K + m + 2*(K - m) + 4) (split), M*(3*K + 2*nh*kh + 4)
// (masked).
#include <type_traits>

#include "common.cuh"

namespace vit {

constexpr int kQuantWarps = 8;  // the masked kernel's block

// The preset chains' widths: each has a compile-time form.
using QuantWidths = Widths<192, 384, 768, 1024, 1280, 1536, 1664, 3072, 4096, 5120, 8192>;

// 16 bytes as they were loaded, and element i of them as fp32 (bf16: the
// high half of a word is the element with the odd index; widening is exact).
struct Raw16 {
  uint32_t w[4];
};

__device__ __forceinline__ Raw16 load16(const void* p) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  return {{r.x, r.y, r.z, r.w}};
}

template <typename T>
__device__ __forceinline__ float elem(const Raw16& v, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(v.w[i]);
  } else {
    return __uint_as_float(i % 2 ? v.w[i / 2] & 0xffff0000u : v.w[i / 2] << 16);
  }
}

__device__ __forceinline__ uint32_t pack_codes(float a, float b, float c, float d,
                                               float r) {
  const auto u = [r](float v) {
    return static_cast<uint32_t>(static_cast<uint8_t>(quantize_one(v, r)));
  };
  return u(a) | u(b) << 8 | u(c) << 16 | u(d) << 24;
}

// The V codes of vector v of T at q (4- or 8-byte aligned): one store.
template <typename T>
__device__ __forceinline__ void store_codes(int8_t* q, const Raw16& v, float r) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint32_t*>(q) =
        pack_codes(elem<T>(v, 0), elem<T>(v, 1), elem<T>(v, 2), elem<T>(v, 3), r);
  } else {
    uint2 out;
    out.x = pack_codes(elem<T>(v, 0), elem<T>(v, 1), elem<T>(v, 2), elem<T>(v, 3), r);
    out.y = pack_codes(elem<T>(v, 4), elem<T>(v, 5), elem<T>(v, 6), elem<T>(v, 7), r);
    *reinterpret_cast<uint2*>(q) = out;
  }
}

// A row's vectors in registers: N vectors a lane of the row's kThreads
// threads; a lane past the last row, or past a ragged row's end, holds
// zeros (they leave the absmax as it is).
template <typename TIn, int kCols>
struct HeldRow {
  using S = RowShape<TIn, kCols>;
  Raw16 v[S::kPerLane];

  __device__ __forceinline__ static int col(int j, int sub) {
    return (j * S::kThreads + sub) * S::V;
  }
  __device__ __forceinline__ static bool in_row(int c) {
    return !S::kRagged || c < kCols;
  }
  __device__ __forceinline__ void load(const TIn* xr, int sub, bool live) {
#pragma unroll
    for (int j = 0; j < S::kPerLane; ++j) {
      const int c = col(j, sub);
      v[j] = {};
      if (live && in_row(c)) v[j] = load16(xr + c);
    }
  }
  // The absmax of the columns below `m`, across the row's lanes and warps,
  // floored (every thread of the row gets it). Every thread of the block
  // calls it: with several warps a row it holds a barrier.
  __device__ __forceinline__ float absmax(int sub, int m) const {
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < S::kPerLane; ++j)
      if (col(j, sub) < m)
#pragma unroll
        for (int i = 0; i < S::V; ++i) amax = fmaxf(amax, fabsf(elem<TIn>(v[j], i)));
    amax = warp_absmax<S::kLanes>(amax);
    if constexpr (S::kWarps > 1) {
      __shared__ float part[kRowMaxWarps];
      const int warp = threadIdx.x / 32, first = warp - warp % S::kWarps;
      if (threadIdx.x % 32 == 0) part[warp] = amax;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < S::kWarps; ++w) amax = fmaxf(amax, part[first + w]);
    }
    return amax;
  }
};

template <typename TIn, int kCols>
__global__ void __launch_bounds__(kRowMaxWarps * 32)
quantize_rows_kernel(const TIn* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int rows) {
  using Row = HeldRow<TIn, kCols>;
  constexpr int T = Row::S::kThreads;
  const int sub = threadIdx.x % T;
  const int row = blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  const bool live = row < rows;
  Row held;
  held.load(x + static_cast<size_t>(row) * kCols, sub, live);
  const float amax = held.absmax(sub, kCols);
  if (!live) return;
  const float r = 127.0f / amax;  // IEEE division (nvcc's -prec-div=true)
  int8_t* qr = q + static_cast<size_t>(row) * kCols;
#pragma unroll
  for (int j = 0; j < Row::S::kPerLane; ++j) {
    const int c = Row::col(j, sub);
    if (Row::in_row(c)) store_codes<TIn>(qr + c, held.v[j], r);
  }
  if (sub == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

// Row stride kCols in x, m in q, kCols - m in hi; m a multiple of 4.
template <int kCols>
__global__ void __launch_bounds__(kRowMaxWarps * 32)
quantize_rows_split_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                           float* __restrict__ scale, bf16* __restrict__ hi,
                           int rows, int m) {
  using Row = HeldRow<float, kCols>;
  constexpr int T = Row::S::kThreads;
  const int sub = threadIdx.x % T;
  const int row = blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  const bool live = row < rows;
  Row held;
  held.load(x + static_cast<size_t>(row) * kCols, sub, live);
  const float amax = held.absmax(sub, m);
  if (!live) return;
  const float r = 127.0f / amax;
  int8_t* qr = q + static_cast<size_t>(row) * m;
  bf16* hr = hi + static_cast<size_t>(row) * (kCols - m);
#pragma unroll
  for (int j = 0; j < Row::S::kPerLane; ++j) {
    const int c = Row::col(j, sub);
    const Raw16& v = held.v[j];
    if (c < m) {
      store_codes<float>(qr + c, v, r);
    } else if (Row::in_row(c)) {
      uint2 out;
      out.x = pack_bf16x2(elem<float>(v, 0), elem<float>(v, 1));
      out.y = pack_bf16x2(elem<float>(v, 2), elem<float>(v, 3));
      *reinterpret_cast<uint2*>(hr + (c - m)) = out;
    }
  }
  if (sub == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

// The general forms, for any width that is a multiple of 4: a warp a row.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(b[e]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 raw;
  raw.x = pack_bf16x2(v[0], v[1]);
  raw.y = pack_bf16x2(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The absmax over columns [0, m) of row xr, then their codes at qr.
template <typename TIn>
__device__ __forceinline__ float quantize_row_any_width(const TIn* xr, int8_t* qr,
                                                        int m, int lane) {
  float amax = 0.f;
  for (int c = lane * 4; c < m; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = warp_absmax(amax);
  const float r = 127.0f / amax;
  for (int c = lane * 4; c < m; c += 128) {
    float v[4];
    load4(xr + c, v);
    *reinterpret_cast<char4*>(qr + c) =
        make_char4(quantize_one(v[0], r), quantize_one(v[1], r),
                   quantize_one(v[2], r), quantize_one(v[3], r));
  }
  return amax;
}

template <typename TIn>
__global__ void __launch_bounds__(kRowMaxWarps * 32)
quantize_rows_any_width_kernel(const TIn* __restrict__ x, int8_t* __restrict__ q,
                               float* __restrict__ scale, int rows, int cols) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * cols;
  const float amax = quantize_row_any_width(x + base, q + base, cols, lane);
  if (lane == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

__global__ void __launch_bounds__(kRowMaxWarps * 32)
quantize_rows_split_any_width_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scale,
                                     bf16* __restrict__ hi, int rows, int cols,
                                     int m) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * cols;
  const float amax =
      quantize_row_any_width(xr, q + static_cast<size_t>(row) * m, m, lane);
  bf16* hr = hi + static_cast<size_t>(row) * (cols - m);
  for (int c = m + lane * 4; c < cols; c += 128) {
    float v[4];
    load4(xr + c, v);
    store4(hr + (c - m), v);
  }
  if (lane == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

// Clip, then cast: a tail value may be many times the kept absmax
// (__float2int_rn saturates, so even a huge product clips right). A kept
// value's code is within +-127 already, so the clip leaves it as it is.
__device__ __forceinline__ uint32_t clipped_code(float v, float r) {
  const int qi = max(-127, min(127, __float2int_rn(__fmul_rn(v, r))));
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<signed char>(qi)));
}

// The masked quantize at the presets' (cols = num_heads * kHeadDim,
// kHeadDim) pairs: row 5a's held row of bf16. kHeadDim is a compile-time
// multiple of 8, so each 16-byte vector lies in one head and its place there
// costs one division by a constant a vector; kh is a run-time value. The
// absmax spans the kept columns ((c mod kHeadDim) < kHeadDim - kh); every
// vector's 8 codes, clipped, leave as one 8-byte store; the tails go in
// head order into the row's slot of shared memory, then out to hi in
// 16-byte (else 4- or 2-byte) stores, coalesced across the row's lanes.
template <int kCols, int kHeadDim>
__global__ void __launch_bounds__(kRowMaxWarps * 32)
quantize_rows_masked_row_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                                float* __restrict__ scale, bf16* __restrict__ hi,
                                int rows, int kh) {
  using Row = HeldRow<bf16, kCols>;
  using S = typename Row::S;
  static_assert(kHeadDim % S::V == 0 && kCols % kHeadDim == 0, "a vector within a head");
  static_assert(S::kWarps == 1, "a row within one warp");
  constexpr int T = S::kThreads;
  __shared__ __align__(16) uint16_t tails[kRowMaxWarps * 32 / T][kCols];
  const int sub = threadIdx.x % T, slot = threadIdx.x / T;
  const int row = blockIdx.x * (blockDim.x / T) + slot;
  const bool live = row < rows;
  const int keep = kHeadDim - kh;
  Row held;
  held.load(x + static_cast<size_t>(row) * kCols, sub, live);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < S::kPerLane; ++j) {
    const int in_head = Row::col(j, sub) % kHeadDim;
#pragma unroll
    for (int i = 0; i < S::V; ++i)
      if (in_head + i < keep) amax = fmaxf(amax, fabsf(elem<bf16>(held.v[j], i)));
  }
  amax = warp_absmax<S::kLanes>(amax);  // a group past the last row joins too
  if (!live) return;
  const float r = 127.0f / amax;
  int8_t* qr = q + static_cast<size_t>(row) * kCols;
  uint16_t* st = tails[slot];
#pragma unroll
  for (int j = 0; j < S::kPerLane; ++j) {
    const int c = Row::col(j, sub);
    if (!Row::in_row(c)) continue;
    const Raw16& v = held.v[j];
    uint2 codes;
    codes.x = clipped_code(elem<bf16>(v, 0), r) | clipped_code(elem<bf16>(v, 1), r) << 8 |
              clipped_code(elem<bf16>(v, 2), r) << 16 | clipped_code(elem<bf16>(v, 3), r) << 24;
    codes.y = clipped_code(elem<bf16>(v, 4), r) | clipped_code(elem<bf16>(v, 5), r) << 8 |
              clipped_code(elem<bf16>(v, 6), r) << 16 | clipped_code(elem<bf16>(v, 7), r) << 24;
    *reinterpret_cast<uint2*>(qr + c) = codes;
    const int head = c / kHeadDim, in_head = c - head * kHeadDim;
    if (in_head + S::V > keep) {
#pragma unroll
      for (int i = 0; i < S::V; ++i)
        if (in_head + i >= keep)  // the raw bf16: exact
          st[head * kh + in_head + i - keep] =
              static_cast<uint16_t>(i % 2 ? v.w[i / 2] >> 16 : v.w[i / 2] & 0xffffu);
    }
  }
  // The row's lanes (one group of a warp) have staged every tail.
  __syncwarp(T == 32 ? 0xffffffffu : ((1u << T) - 1) << (threadIdx.x % 32 / T * T));
  const int n = (kCols / kHeadDim) * kh;
  uint16_t* hr = reinterpret_cast<uint16_t*>(hi) + static_cast<size_t>(row) * n;
  if (n % 8 == 0) {
    for (int k = sub; k < n / 8; k += T)
      reinterpret_cast<uint4*>(hr)[k] = reinterpret_cast<const uint4*>(st)[k];
  } else if (n % 2 == 0) {
    for (int k = sub; k < n / 2; k += T)
      reinterpret_cast<uint32_t*>(hr)[k] = reinterpret_cast<const uint32_t*>(st)[k];
  } else {
    for (int k = sub; k < n; k += T) hr[k] = st[k];
  }
  if (sub == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

// The general form, for any other (cols, head_dim): a warp a row, the row
// read twice. The tail columns of head h are h*head_dim + [head_dim - kh,
// head_dim); hi has row stride num_heads * kh.
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_masked_kernel(const bf16* __restrict__ x, int8_t* __restrict__ q,
                            float* __restrict__ scale, bf16* __restrict__ hi,
                            int rows, int cols, int head_dim, int kh) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int keep = head_dim - kh;
  const bf16* xr = x + static_cast<size_t>(row) * cols;
  float amax = 0.f;
  for (int c = lane * 4; c < cols; c += 128) {
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((c + e) % head_dim < keep) amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = warp_absmax(amax);
  const float r = 127.0f / amax;
  int8_t* qr = q + static_cast<size_t>(row) * cols;
  bf16* hr = hi + static_cast<size_t>(row) * (cols / head_dim) * kh;
  for (int c = lane * 4; c < cols; c += 128) {
    float v[4];
    load4(xr + c, v);
    uint32_t out = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int in_head = (c + e) % head_dim;
      out |= clipped_code(v[e], r) << (8 * e);
      if (in_head >= keep)  // exact: v[e] was read from bf16
        hr[((c + e) / head_dim) * kh + in_head - keep] = __float2bfloat16_rn(v[e]);
    }
    *reinterpret_cast<uint32_t*>(qr + c) = out;
  }
  if (lane == 0) scale[row] = __fmul_rn(amax, 1.0f / 127.0f);
}

template <typename TIn>
cudaError_t launch_quantize(const void* x, void* q, float* scale, int rows,
                            int cols, cudaStream_t stream) {
  const TIn* xt = static_cast<const TIn*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  dim3 grid, block;
  const bool has_form = with_width(QuantWidths{}, cols, [&](auto width) {
    constexpr int kCols = decltype(width)::value;
    row_launch(rows, RowShape<TIn, kCols>::kThreads, grid, block);
    quantize_rows_kernel<TIn, kCols><<<grid, block, 0, stream>>>(xt, qt, scale, rows);
  });
  if (!has_form) {
    row_launch(rows, 32, grid, block);
    quantize_rows_any_width_kernel<TIn><<<grid, block, 0, stream>>>(xt, qt, scale,
                                                                     rows, cols);
  }
  return cudaGetLastError();
}

cudaError_t launch_quantize_split(const float* x, void* q, float* scale, void* hi,
                                  int rows, int cols, int m, cudaStream_t stream) {
  int8_t* qt = static_cast<int8_t*>(q);
  bf16* ht = static_cast<bf16*>(hi);
  dim3 grid, block;
  const bool has_form = with_width(QuantWidths{}, cols, [&](auto width) {
    constexpr int kCols = decltype(width)::value;
    row_launch(rows, RowShape<float, kCols>::kThreads, grid, block);
    quantize_rows_split_kernel<kCols><<<grid, block, 0, stream>>>(x, qt, scale, ht,
                                                                  rows, m);
  });
  if (!has_form) {
    row_launch(rows, 32, grid, block);
    quantize_rows_split_any_width_kernel<<<grid, block, 0, stream>>>(x, qt, scale, ht,
                                                                     rows, cols, m);
  }
  return cudaGetLastError();
}

template <int kCols, int kHeadDim>
void launch_quantize_masked_form(const bf16* x, int8_t* q, float* scale, bf16* hi,
                                 int rows, int kh, cudaStream_t stream) {
  dim3 grid, block;
  row_launch(rows, RowShape<bf16, kCols>::kThreads, grid, block);
  quantize_rows_masked_row_kernel<kCols, kHeadDim><<<grid, block, 0, stream>>>(
      x, q, scale, hi, rows, kh);
}

cudaError_t launch_quantize_masked(const bf16* x, int8_t* q, float* scale, bf16* hi,
                                   int rows, int cols, int head_dim, int kh,
                                   cudaStream_t stream) {
  // The presets' (num_heads * head_dim, head_dim): ViT-Ti, S, B, L, H, G.
  if (head_dim == 64 && cols == 192)
    launch_quantize_masked_form<192, 64>(x, q, scale, hi, rows, kh, stream);
  else if (head_dim == 64 && cols == 384)
    launch_quantize_masked_form<384, 64>(x, q, scale, hi, rows, kh, stream);
  else if (head_dim == 64 && cols == 768)
    launch_quantize_masked_form<768, 64>(x, q, scale, hi, rows, kh, stream);
  else if (head_dim == 64 && cols == 1024)
    launch_quantize_masked_form<1024, 64>(x, q, scale, hi, rows, kh, stream);
  else if (head_dim == 80 && cols == 1280)
    launch_quantize_masked_form<1280, 80>(x, q, scale, hi, rows, kh, stream);
  else if (head_dim == 104 && cols == 1664)
    launch_quantize_masked_form<1664, 104>(x, q, scale, hi, rows, kh, stream);
  else
    quantize_rows_masked_kernel<<<(rows + kQuantWarps - 1) / kQuantWarps,
                                  kQuantWarps * 32, 0, stream>>>(x, q, scale, hi, rows,
                                                                 cols, head_dim, kh);
  return cudaGetLastError();
}

}  // namespace vit

VIT_EXPORT int vit_quantize_rows(const void* x, int x_dtype, void* q,
                                 float* scale, int rows, int cols,
                                 void* stream) {
  using namespace vit;
  if (rows <= 0 || cols <= 0 || cols % 4 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) return launch_quantize<float>(x, q, scale, rows, cols, s);
  if (x_dtype == kBF16) return launch_quantize<bf16>(x, q, scale, rows, cols, s);
  return cudaErrorInvalidValue;
}

// x fp32 [rows, cols]; q int8 [rows, m]; hi bf16 [rows, cols - m]. m and
// cols multiples of 4: no 16-byte vector of x straddles m.
VIT_EXPORT int vit_quantize_rows_split(const float* x, void* q, float* scale,
                                       void* hi, int rows, int cols, int m,
                                       void* stream) {
  using namespace vit;
  if (rows <= 0 || cols <= 0 || m <= 0 || m >= cols || cols % 4 != 0 ||
      m % 4 != 0)
    return cudaErrorInvalidValue;
  return launch_quantize_split(x, q, scale, hi, rows, cols, m,
                               static_cast<cudaStream_t>(stream));
}

// x bf16 [rows, cols = num_heads * head_dim]; q int8 [rows, cols];
// hi bf16 [rows, num_heads * kh].
VIT_EXPORT int vit_quantize_rows_masked(const void* x, void* q, float* scale,
                                        void* hi, int rows, int cols,
                                        int head_dim, int kh, void* stream) {
  using namespace vit;
  if (rows <= 0 || cols <= 0 || cols % 4 != 0 || head_dim <= 0 ||
      cols % head_dim != 0 || kh <= 0 || kh >= head_dim)
    return cudaErrorInvalidValue;
  return launch_quantize_masked(static_cast<const bf16*>(x), static_cast<int8_t*>(q),
                                scale, static_cast<bf16*>(hi), rows, cols, head_dim, kh,
                                static_cast<cudaStream_t>(stream));
}

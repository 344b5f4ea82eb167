// Shared helpers for the port's CUDA kernels (built for sm_90a by
// ops/_build.py, bound to Python with ctypes).
//
// Every entry point has a plain C signature: tensors arrive as raw device
// pointers, the stream as a pointer-sized handle, and the return value is
// the cudaError_t of the launch (checked with cudaGetLastError() right after
// it), which the Python wrapper turns into an exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define VIT_EXPORT extern "C" __attribute__((visibility("default")))

namespace vit {

typedef __nv_bfloat16 bf16;

// dtype codes shared with the Python wrappers (ops/_build.DTYPE_CODES).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two floats rounded to bf16 (round to nearest even, as XLA's convert) in one
// 32-bit word; `lo` lands in the low half, the element with the lower index.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// V consecutive elements as one aligned access (V = 4 or 8; an offset of a
// multiple of V elements keeps the alignment where the base is 16-byte
// aligned and the rows are whole vectors). 16 bytes is the widest access, so
// 8 floats are two.
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Vec {
  T v[V];
};

// The kernels' inputs are read-only while they run (the wrappers allocate
// every output), so they take the non-coherent path, which also lets the
// compiler issue them ahead of earlier stores.
template <int V>
__device__ __forceinline__ void load_f32(float (&v)[V], const float* p) {
  static_assert(V % 4 == 0, "16-byte loads");
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p + e));
    v[e] = r.x;
    v[e + 1] = r.y;
    v[e + 2] = r.z;
    v[e + 3] = r.w;
  }
}

template <int V>
__device__ __forceinline__ void load_bf16(float (&v)[V], const bf16* p) {
  static_assert(V == 4 || V == 8, "8- or 16-byte loads");
  uint32_t w[V / 2];
  if constexpr (V == 8) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  } else {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = r.x; w[1] = r.y;
  }
#pragma unroll
  for (int e = 0; e < V / 2; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(void* base, size_t off, int as_bf16,
                                          const float (&v)[V]) {
  if (as_bf16) {
    Vec<uint32_t, V / 2> p;
#pragma unroll
    for (int e = 0; e < V / 2; ++e) p.v[e] = pack_bf16x2(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<Vec<uint32_t, V / 2>*>(static_cast<bf16*>(base) + off) = p;
  } else {
    Vec<float, V> p;
#pragma unroll
    for (int e = 0; e < V; ++e) p.v[e] = v[e];
    *reinterpret_cast<Vec<float, V>*>(static_cast<float*>(base) + off) = p;
  }
}

// The elements of a 16-byte vector of T, and V consecutive elements of T at
// p as fp32: one aligned access, or (V = 1) one element.
template <typename T> constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));

template <int V>
__device__ __forceinline__ void load_floats(float (&v)[V], const float* p) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
    load_f32<V>(v, p);
  }
}

template <int V>
__device__ __forceinline__ void load_floats(float (&v)[V], const bf16* p) {
  if constexpr (V == 1) {
    v[0] = __bfloat162float(*p);
  } else {
    load_bf16<V>(v, p);
  }
}

// Row kernels (the LN, the int8 quantize): a row of kCols elements of T in
// 16-byte vectors, held in registers from its load to its write. kThreads
// threads take a row: a group of kLanes lanes of one warp (32 from 96
// vectors a row up, 16 from 48, 8 from 24, else 4), or kWarps whole warps
// (2 or 4) where one warp's share would pass kRowMaxPerLane vectors a lane
// (64 registers of data; at 32 the int8 quantize's 8192-wide bf16 form
// spilled). kPerLane vectors a lane; with kRagged,
// the last lanes' last vector lies past the row and is left out. Vector j
// of lane `sub` starts at column (j * kThreads + sub) * V, so each
// instruction of the row's lanes reads or writes one contiguous run.
constexpr int kRowMaxPerLane = 16;
constexpr int kRowMaxWarps = 4;  // a block: 1, 2 or 4 warps
constexpr int kRowTargetBlocks = 4 * 132;  // 4 blocks an SM of an H100

template <typename T, int kCols>
struct RowShape {
  static constexpr int V = kVec16<T>;
  static_assert(kCols % V == 0, "a row of whole vectors");
  static constexpr int kVecs = kCols / V;
  static constexpr int kLanes = kVecs >= 96 ? 32 : kVecs >= 48 ? 16 : kVecs >= 24 ? 8 : 4;
  static constexpr int kWarps = kVecs <= 32 * kRowMaxPerLane   ? 1
                                : kVecs <= 64 * kRowMaxPerLane ? 2
                                                               : 4;
  static_assert(kVecs <= 32 * kRowMaxWarps * kRowMaxPerLane, "a row of at most a block");
  static constexpr int kThreads = kLanes * kWarps;
  static constexpr int kPerLane = (kVecs + kThreads - 1) / kThreads;
  static constexpr bool kRagged = kVecs % kThreads != 0;
};

// The grid and block of a row kernel whose rows take `row_threads` threads
// (a divisor or a multiple of 32): blocks of kRowMaxWarps warps (at least a
// row's), halved while the grid would fall short of kRowTargetBlocks.
inline void row_launch(int rows, int row_threads, dim3& grid, dim3& block) {
  const int row_min = (row_threads + 31) / 32;
  int warps = row_min > kRowMaxWarps ? row_min : kRowMaxWarps;
  auto blocks = [&](int w) {
    const int per_block = w * 32 / row_threads;
    return (rows + per_block - 1) / per_block;
  };
  while (warps > row_min && blocks(warps) < kRowTargetBlocks) warps /= 2;
  grid = dim3(blocks(warps));
  block = dim3(warps * 32);
}

// A list of widths that have compile-time forms, and a call of
// launch(std::integral_constant<int, W>) for the W equal to cols; false
// where cols has no form.
template <int... kWidths>
struct Widths {};

template <typename Launch, int... kWidths>
bool with_width(Widths<kWidths...>, int cols, Launch&& launch) {
  return ((cols == kWidths &&
           (launch(std::integral_constant<int, kWidths>{}), true)) || ...);
}

// The absmax of a group of kLanes lanes (every lane of the group gets it),
// floored at 2^-93, so that a zero row keeps a finite 127 / absmax. fmaxf
// returns the other operand where one is NaN, so a NaN is left out of the
// max in any order of the reduction.
template <int kLanes = 32>
__device__ __forceinline__ float warp_absmax(float amax) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return fmaxf(amax, 0x1p-93f);
}

// An int8 code: __float2int_rn rounds half to even, as jnp.round and
// torch.round; roundf would not. No clip: |v| <= absmax gives |v * r| <=
// 127 * (1 + 2^-23) < 127.5.
__device__ __forceinline__ signed char quantize_one(float v, float r) {
  return static_cast<signed char>(__float2int_rn(__fmul_rn(v, r)));
}

// Opt a kernel into more than 48 KB of dynamic shared memory (Hopper allows
// up to 227 KB per block).
template <typename Kernel>
__host__ inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Element strides (image, head, row) of a [B, H, T, hd] view whose last
// axis is contiguous: split-head tensors, their permuted views of a [B, T,
// 3D] GEMM output, or a head's columns of the packed slabs.
struct Strides {
  long long batch, head, row;
};
struct HeadViews {
  Strides q, k, v, o;
};

// Views from the 12 strides q, k, v, o (batch, head, row each) in order.
__host__ inline HeadViews head_views(const long long* s) {
  return HeadViews{{s[0], s[1], s[2]}, {s[3], s[4], s[5]},
                   {s[6], s[7], s[8]}, {s[9], s[10], s[11]}};
}

template <typename T>
__device__ __forceinline__ T* head_base(T* p, Strides s, int b, int h) {
  return p + b * s.batch + h * s.head;
}

}  // namespace vit

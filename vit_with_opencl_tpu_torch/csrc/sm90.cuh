// Hopper (sm_90a) parts shared by the GEMM core (gemm_sm90.cuh) and the
// attention kernels (attention.cu, attention_bwd.cu, attention_flash.cu's
// forward) and the overlap probe (probe_overlap.cu): mbarriers, TMA loads,
// wgmma's shared-memory descriptors, fence, commit and wait, the m64n64k16,
// m64n128k16 and m64n8k16 products the attention kernels take, the int8
// m64n128k32 product of the W8A8 GEMMs and the probe, and the tensor maps'
// encoding with a host-side cache.
#pragma once

#include <cuda.h>  // CUtensorMap and the encode's enums (types only: no -lcuda)

#include <mutex>

#include "common.cuh"

namespace vit {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D TMA load of one box at (c0 inner, c1 outer), completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The same for a 4-D map, coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units. K-major: the stride byte
// offset is the 1024 bytes between 8-row groups (the leading one unused).
// MN-major: the leading offset is the 8 KiB between the two 64-wide boxes,
// the stride offset the 1024 bytes between groups of 8 K rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// The 128 threads of one consumer warpgroup (named barriers 1 and 2).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// And A fragments in registers, which a product reads until it completes.
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define VIT_WGMMA_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define VIT_WGMMA_D32_OUT(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),        \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),     \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64] with A in registers: warp w of the
// warpgroup holds rows 16w..16w+15 in mma.sync's m16n8k16 A layout (a[0]:
// row g, columns 2t and 2t+1; a[1]: row g + 8; a[2], a[3]: columns + 8; g =
// lane / 4, t = lane % 4). B from shared memory, MN-major if kTB. d: the
// accumulator layout (d[4j], d[4j+1]: row g, columns 8j + 2t, +1; d[4j+2],
// d[4j+3]: row g + 8). accumulate == 0 overwrites d.
template <int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VIT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : VIT_WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTB));
}

// The same with A from shared memory, both operands K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VIT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : VIT_WGMMA_D32_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 8] (+)= A[64 x 16] . B[16 x 8], both from shared memory, K-major:
// the accumulator layout of the first 8 columns of the m64n64k16 products
// (d[0], d[1]: row g, columns 2t, 2t + 1; d[2], d[3]: row g + 8).
__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d0|d1[64 x 128] (+)= A[64 x 16] . B[16 x 128], both from shared memory,
// K-major: d0 holds columns 0..63 and d1 columns 64..127, each in the
// accumulator layout of the m64n64k16 products above.
__device__ __forceinline__ void wgmma_ss_n128(float (&d0)[32], float (&d1)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]),
        "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef VIT_WGMMA_D32
#undef VIT_WGMMA_D32_OUT

// d[64 x 128] += A[64 x 32] . B[32 x 128] in int8 with int32 sums, both
// from shared memory, K-major (int8 wgmma has no transposed form).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int32_t (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// Host side: the tensor maps.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda; null if the driver has none.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                       12000, cudaEnableDefault, &q);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// An int8, bf16 or fp32 tensor (esize 1, 2 or 4 bytes an element) of
// `rank` (2 to 4) dimensions, innermost first, with the byte strides of
// dimensions 1.. (multiples of 16), read as boxes whose inner extent is 128
// bytes, 128-byte swizzled; loads zero-fill past its edges and stores clip
// there.
struct MapKey {
  const void* base;
  int rank;
  int esize;
  long long dims[4];
  long long strides[3];
  int box[4];
  bool operator==(const MapKey& o) const {
    if (base != o.base || rank != o.rank || esize != o.esize) return false;
    for (int i = 0; i < 4; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i]) return false;
    for (int i = 0; i < 3; ++i)
      if (strides[i] != o.strides[i]) return false;
    return true;
  }
};

inline bool encode_map_uncached(CUtensorMap* map, EncodeTiledFn encode, const MapKey& k) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < k.rank; ++i) {
    dims[i] = static_cast<cuuint64_t>(k.dims[i]);
    box[i] = static_cast<cuuint32_t>(k.box[i]);
    if (i > 0) strides[i - 1] = static_cast<cuuint64_t>(k.strides[i - 1]);
  }
  const CUtensorMapDataType type = k.esize == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : k.esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return encode(map, type, k.rank, const_cast<void*>(k.base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same, through a cache of recent maps: a map is a pure function of
// its base, shape, box and type, and the launches of a forward recur with
// the same weights and (from PyTorch's caching allocator) the same
// activation buffers. Encoding is host work on every launch, which the
// host-bound small configs feel (the ViT-Ti stack at B = 16: 84 launches).
inline bool encode_map(CUtensorMap* map, EncodeTiledFn encode, const MapKey& key) {
  constexpr int kSets = 256, kWays = 4;  // a set-associative cache of 1024 maps
  struct Slot {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  static Slot slots[kSets][kWays];
  static int next_way[kSets];
  static std::mutex lock;
  // A 64-bit mix of the key's fields (splitmix64's finaliser after each).
  uint64_t h = reinterpret_cast<uintptr_t>(key.base) ^ static_cast<uint64_t>(key.rank) << 56 ^
               static_cast<uint64_t>(key.esize);
  auto mix = [&h](uint64_t v) {
    h ^= v + 0x9e3779b97f4a7c15ull;
    h = (h ^ (h >> 30)) * 0xbf58476d1ce4e5b9ull;
    h = (h ^ (h >> 27)) * 0x94d049bb133111ebull;
    h ^= h >> 31;
  };
  for (int i = 0; i < key.rank; ++i) {
    mix(static_cast<uint64_t>(key.dims[i]));
    mix(static_cast<uint64_t>(key.box[i]));
    if (i > 0) mix(static_cast<uint64_t>(key.strides[i - 1]));
  }
  const int set = static_cast<int>(h % kSets);
  {
    std::lock_guard<std::mutex> guard(lock);
    for (const Slot& slot : slots[set]) {
      if (slot.used && slot.key == key) {
        *map = slot.map;
        return true;
      }
    }
  }
  if (!encode_map_uncached(map, encode, key)) return false;
  std::lock_guard<std::mutex> guard(lock);
  Slot& slot = slots[set][next_way[set]];
  next_way[set] = (next_way[set] + 1) % kWays;
  slot.key = key;
  slot.map = *map;
  slot.used = true;
  return true;
}

// The calling thread's device's SM count (asked once per device), or 0.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms[dev];
}

// A row-major [outer, inner] matrix of esize-byte elements (inner
// contiguous, rows `pitch` bytes apart, a multiple of 16; 0: inner * esize)
// as boxes of [box_outer, 128 bytes].
inline bool encode_map(CUtensorMap* map, EncodeTiledFn encode, const void* base, int esize,
                       long long inner, long long outer, int box_outer,
                       long long pitch = 0) {
  MapKey key{base, 2, esize, {inner, outer, 0, 0}, {pitch ? pitch : inner * esize, 0, 0},
             {128 / esize, box_outer, 0, 0}};
  return encode_map(map, encode, key);
}

}  // namespace sm90
}  // namespace vit

// Multi-head attention with the one-shot softmax of _head_attention, one
// body for two entries:
//   packed       [B, T, 3D] packed q|k|v -> the head-major context [B, T, D]
//                (vit_packed_attention_bf16: slab packing, T keys;
//                vit_packed_attention_kv: slab or per-head packing, keys at
//                and past kv_len masked). Replaces
//                vit_with_opencl_tpu/ops/attention.py:_packed_kernel
//                (packed_fused_attention, with its packings and
//                true_seq_len) and the per-head attention that
//                ops/fused_block.py:_block_kernel inlines (_head_attention).
//                "slab" packing: head h's q, k and v are the hd columns at
//                h*hd, D + h*hd and 2D + h*hd; "per_head" at 3h*hd, (3h +
//                1)*hd and (3h + 2)*hd (attention.py:_packed_offsets).
//   single pass  q, k, v, out as strided [B, H, T, hd] views, keys at and
//                past kv_len masked (vit_single_pass_attention in
//                attention_single.cu, bf16). Replaces
//                vit_with_opencl_tpu/ops/attention.py:_single_pass_kernel
//                (flash_attention up to T = 1024).
// Per head, the numerics of _head_attention:
//   qs = q * scale               rounded to bf16, as the input dtype
//   s  = qs . k^T                fp32 accumulation
//   e  = exp(s - rowmax(s))      fp32, against the row's exact final max;
//                                keys at and past kv_len (T for the packed
//                                entry) score MASK_VALUE (attention.py:43),
//                                not -inf
//   o  = bf16(e) . v             fp32 accumulation
//   o *= 1 / rowsum(e)           normalised after the product, then cast
// The only reassociation is the order of rowsum(e)'s fp32 terms (a
// pairwise tree within each chunk).
//
// Bound on the card: bytes at ViT-B's T = 197 (the operations are a third
// of the time the bytes take, at the card's peaks); operations at T = 1024
// (B = 4, 16 heads: 17.2 GFLOP, 0.0174 ms, against 33.6 MB, 0.0100 ms).
// Design (Hopper, sm_90a; tiles and maps in attention_sm90.cuh): a
// persistent grid of one block an SM, each block walking work units of
// (image, head, 128 queries), the units of a head side by side, so that the
// blocks running at once share their K/V in L2. A block is one producer
// warpgroup and two consumer warpgroups, each consumer owning 64 queries of
// the unit, so the two query tiles share every K/V tile the block stages.
// One producer thread loads 64-key K and V tiles by TMA from the K and V
// views' maps (for the slabs one map of 3H heads, K and V at head
// coordinates H + h and 2H + h) into a ring of slots (8 up to hd 64: the
// next unit's tiles load under this unit's products; 4 past it); V stays
// row-major and is the PV product's MN-major B operand. Each consumer holds
// qs (its words loaded a unit ahead through q's strides, scaled and rounded
// in registers) as the A operand of S = qs . K^T (wgmma m64n64k16, A from
// registers), one 64-key chunk an accumulator of 32 registers. The key
// chunks run to kv_len; chunks wholly past it hold masked keys only, whose
// e is exactly 0, and are neither loaded nor multiplied.
//   <= 256 keys: the row's scores fit registers (the chunk count a template
//             parameter): one pass takes the exact max, e, its row sum and
//             bf16(e) (the accumulators turned into A fragments) from the
//             same registers, then o = bf16(e) . V. The two consumers take
//             turns issuing their products (attention_sm90.cuh), so one's
//             softmax runs under the other's products.
//   more:     the ring streams K alone (pass 1: the exact max, chunk by
//             chunk), then K and V (pass 2: S again, e, the row sum and o
//             += bf16(e) . V_chunk).
// The output tile stays in registers until it is scaled by 1/l and stored
// through out's strides, rows past T left alone. The two entries are two
// kernels of one body (packed_attention_kernel, single_pass_attention_kernel:
// a trace tells them apart). What differs between them is resolved at
// compile time where the consumers would pay for it (q's and out's
// addressing; kv_len == T, also a form of the packed kernel); the maps'
// order and the heads' coordinates in them are read by the producer's one
// thread.
// Operations: 4 T^2 hd a head up to 256 keys (padded to whole 64-key chunks
// and 64-query tiles), 6 T^2 hd past it; the exponential is expf (the plain
// version's torch.exp).
#include <limits.h>

#include <type_traits>

#include "attention_sm90.cuh"

namespace vit {
namespace attn90 {

constexpr int kMaxChunks = 4;  // keys held in registers: one pass up to 256

// K/V tile pairs in the ring: two units' chunks at hd <= 64, so the next
// unit's loads run under this one's products; one unit's past it.
template <int HDP>
__host__ __device__ constexpr int fwd_slots() {
  return boxes<HDP>() == 1 ? 2 * kMaxChunks : kMaxChunks;
}
template <int HDP>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 1024 + fwd_slots<HDP>() * 2 * tile_bytes<HDP>() + 2 * fwd_slots<HDP>() * 8;
}

// What the entries pass the body besides the maps.
struct FwdArgs {
  const bf16* q;
  bf16* out;
  tiles::Strides qs, os;  // element strides (image, head, row) of q and out
  MapOrder ko, vo;        // where K's and V's maps keep head, row and image (views)
  int T, kv_len, num_heads, hd, units;
  float scale;
};

// kViews: the single-pass entry (any view, a key count); otherwise the
// packed entries, whose addressing of q and out ([B, T, 3D] and [B, T, D])
// is fixed at compile time: read from the views' strides at run time, they
// measured slower in the packed kernel at ViT-B B = 256. The packed
// kernel's slab form (kGeneral false) also fixes slab packing and T keys;
// its general form reads the key count and the packing from the arguments
// (qs.head: hd for slabs, 3 hd for per-head packing, whose head h has q, K
// and V at head coordinates 3h, 3h + 1 and 3h + 2 of the packed map).
template <int HDP, bool kViews, bool kGeneral>
__device__ __forceinline__ void attention_fwd(const CUtensorMap* map_k,
                                              const CUtensorMap* map_v, const FwdArgs& a) {
  const int T = a.T, kv_len = kViews || kGeneral ? a.kv_len : a.T;
  const int num_heads = a.num_heads, hd = a.hd;
  const int units = a.units;
  const float scale = a.scale;
  const int D = num_heads * hd;
  const bf16* __restrict__ q = a.q;
  bf16* __restrict__ out = a.out;
  constexpr int kB = boxes<HDP>(), kTile = tile_bytes<HDP>(), kSteps = HDP / 16;
  constexpr int kSlots = fwd_slots<HDP>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = smem_u32(aligned_smem(smem_raw));  // slot i: K, then V
  const uint32_t full = ring + kSlots * 2 * kTile;
  const uint32_t empty = full + kSlots * 8;
  const int nchunks = (kv_len + kRows - 1) / kRows, nqb = (T + 2 * kRows - 1) / (2 * kRows);
  const bool one_pass = nchunks <= kMaxChunks;
  const int steps = one_pass ? nchunks : 2 * nchunks;  // pass 1 loads K alone
  // Tile steps n = 0, 1, ... of this block, over its units in turn, take
  // slot n % kSlots in phase (n / kSlots) & 1, for the producer and the
  // consumers alike.
  auto slot_of = [](int n) { return n % kSlots; };
  auto phase_of = [](int n) { return static_cast<uint32_t>((n / kSlots) & 1); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int n = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const FwdUnit w = fwd_unit(u, nqb, num_heads);
        for (int s = 0; s < steps; ++s, ++n) {
          const int c = s % nchunks;
          const bool with_v = one_pass || s >= nchunks;
          mbar_wait(empty + 8 * slot_of(n), phase_of(n) ^ 1);  // the first round passes
          const uint32_t bar = full + 8 * slot_of(n), k = ring + slot_of(n) * 2 * kTile;
          mbar_expect_tx(bar, (with_v ? 2 : 1) * kTile);  // zero-filled boxes count whole
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            // The slabs: one map of 3H heads, K at H + h and V at 2H + h.
            const bool per_head = kGeneral && a.qs.head != hd;
            const int kh = kViews ? w.h : per_head ? 3 * w.h + 1 : num_heads + w.h;
            const int vh = kViews ? w.h : per_head ? 3 * w.h + 2 : 2 * num_heads + w.h;
            tma_load_view(k + j * kBox, map_k, a.ko, 64 * j, kh, c * kRows, w.b, bar);
            if (with_v)
              tma_load_view(k + kTile + j * kBox, map_v, a.vo, 64 * j, vh, c * kRows, w.b, bar);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, lane = t % 32, g = lane / 4, tq = lane % 4;
  auto first_row = [&](const FwdUnit& w) {  // the warp's first query in unit w
    return (w.qb * kConsumers + wg) * kRows + 16 * (t / 32);
  };

  auto mask = [&](float (&c)[32], int chunk) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = chunk * kRows + 8 * j + 2 * tq;
      if (key >= kv_len) c[4 * j] = c[4 * j + 2] = kMaskValue;
      if (key + 1 >= kv_len) c[4 * j + 1] = c[4 * j + 3] = kMaskValue;
    }
  };
  auto row_max = [](const float (&c)[32], float& m0, float& m1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(c[4 * j], c[4 * j + 1]));
      m1 = fmaxf(m1, fmaxf(c[4 * j + 2], c[4 * j + 3]));
    }
  };
  // e = exp(s - m) in place, its row sums (pairwise) added to (l0, l1).
  auto exp_rows = [](float (&c)[32], float m0, float m1, float& l0, float& l1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[4 * j] = expf(c[4 * j] - m0);
      c[4 * j + 1] = expf(c[4 * j + 1] - m0);
      c[4 * j + 2] = expf(c[4 * j + 2] - m1);
      c[4 * j + 3] = expf(c[4 * j + 3] - m1);
    }
    float r0, r1;
    row_sums(c, r0, r1);
    l0 += r0;
    l1 += r1;
  };

  // A unit's q words, raw (rows past T and columns past hd zero), loaded a
  // unit ahead so that their latency runs under the unit before.
  auto load_q = [&](uint32_t (&raw)[kSteps][4], int u) {
    if (u >= units) return;
    const FwdUnit w = fwd_unit(u, nqb, num_heads);
    if constexpr (kViews)
      load_a_raw<HDP>(raw, q + w.b * a.qs.batch + w.h * a.qs.head,
                      static_cast<int>(a.qs.row), 0, first_row(w), T, hd, g, tq);
    else
      load_a_raw<HDP>(raw, q + static_cast<size_t>(w.b) * T * 3 * D, 3 * D,
                      w.h * (kGeneral ? static_cast<int>(a.qs.head) : hd), first_row(w), T, hd,
                      g, tq);
  };
  uint32_t q_next[kSteps][4];
  load_q(q_next, blockIdx.x);
  int n = 0;
  if (one_pass) turns_begin(wg);  // the streamed passes take no turns
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const FwdUnit w = fwd_unit(u, nqb, num_heads);
    // qs in the A layout, scaled and rounded as `q * jnp.asarray(scale,
    // q.dtype)` does (`scale` is bf16-exact).
    uint32_t qa[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[kk][r] = tiles::scale2(q_next[kk][r], scale);
    load_q(q_next, u + gridDim.x);
    // s = qs . K^T of the K tile at `k` into c.
    auto scores = [&](float (&c)[32], uint32_t k) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) wgmma_rs<0>(c, qa[kk], desc_k(k, kk), kk > 0);
    };
    auto k_tile = [&](int m) { return ring + slot_of(m) * 2 * kTile; };

    float m0 = -FLT_MAX, m1 = -FLT_MAX, l0 = 0.f, l1 = 0.f;
    float o[kB][32];
    // One pass over NC chunks, every chunk's scores held at once.
    auto one_pass_unit = [&](auto nc) {
      constexpr int NC = decltype(nc)::value;
      float s[NC][32];
      turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        mbar_wait(full + 8 * slot_of(n + c), phase_of(n + c));
        scores(s[c], k_tile(n + c));
      }
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        fence_acc(s[c]);
        if (c == NC - 1) mask(s[c], c);  // only the last chunk holds keys past kv_len
        row_max(s[c], m0, m1);
      }
      quad_max(m0);
      quad_max(m1);
      uint32_t pa[NC][4][4];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        exp_rows(s[c], m0, m1, l0, l1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) to_a(pa[c][kk], s[c], kk);
      }
      turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint32_t v = k_tile(n + c) + kTile;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < kB; ++j)
            wgmma_rs<1>(o[j], pa[c][kk], desc_mn(v, j, kk), c + kk > 0);
      }
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < kB; ++j) fence_acc(o[j]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_frag(pa[c][kk]);
        mbar_arrive(empty + 8 * slot_of(n + c));
      }
      n += NC;
    };
    if (one_pass) {
      switch (nchunks) {
        case 1: one_pass_unit(std::integral_constant<int, 1>()); break;
        case 2: one_pass_unit(std::integral_constant<int, 2>()); break;
        case 3: one_pass_unit(std::integral_constant<int, 3>()); break;
        default: one_pass_unit(std::integral_constant<int, kMaxChunks>()); break;
      }
    } else {
      // Pass 1: the exact max of each row over all keys.
      for (int c = 0; c < nchunks; ++c, ++n) {
        float s[32];
        mbar_wait(full + 8 * slot_of(n), phase_of(n));
        wgmma_fence();
        scores(s, k_tile(n));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(s);
        mbar_arrive(empty + 8 * slot_of(n));
        mask(s, c);
        row_max(s, m0, m1);
      }
      quad_max(m0);
      quad_max(m1);
      // Pass 2: e against that max, its row sums, o += bf16(e) . V.
      for (int c = 0; c < nchunks; ++c, ++n) {
        float s[32];
        mbar_wait(full + 8 * slot_of(n), phase_of(n));
        const uint32_t k = k_tile(n);
        wgmma_fence();
        scores(s, k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(s);
        mask(s, c);
        exp_rows(s, m0, m1, l0, l1);
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) to_a(pa[kk], s, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < kB; ++j)
            wgmma_rs<1>(o[j], pa[kk], desc_mn(k + kTile, j, kk), c + kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < kB; ++j) fence_acc(o[j]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_frag(pa[kk]);
        mbar_arrive(empty + 8 * slot_of(n));
      }
    }
    quad_sum(l0);
    quad_sum(l1);
    if constexpr (kViews)
      store_rows<kB, bf16>(out + w.b * a.os.batch + w.h * a.os.head,
                           static_cast<int>(a.os.row), 0, o, 1.f / l0, 1.f / l1, first_row(w),
                           T, hd, g, tq);
    else
      store_rows<kB, bf16>(out + static_cast<size_t>(w.b) * T * D, D, w.h * hd, o, 1.f / l0,
                           1.f / l1, first_row(w), T, hd, g, tq);
  }
  if (one_pass) turns_end(wg);
}

template <int HDP, bool kGeneral>
__global__ void __launch_bounds__(kThreads, 1)
packed_attention_kernel(const __grid_constant__ CUtensorMap map_qkv,
                        const __grid_constant__ FwdArgs args) {
  attention_fwd<HDP, false, kGeneral>(&map_qkv, &map_qkv, args);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
single_pass_attention_kernel(const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ FwdArgs args) {
  attention_fwd<HDP, true, true>(&map_k, &map_v, args);
}

// One launch of either kernel: the packed one when map_v is null (K and V
// in map_k; its general form for a key count or per-head packing), the
// single-pass one otherwise; args.units set here.
template <int HDP>
cudaError_t launch_fwd(const CUtensorMap& map_k, const CUtensorMap* map_v, FwdArgs args,
                       int B, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  constexpr int smem = fwd_smem_bytes<HDP>();
  const long long units =
      static_cast<long long>((args.T + 2 * kRows - 1) / (2 * kRows)) * args.num_heads * B;
  if (units > INT_MAX || args.qs.row > INT_MAX || args.os.row > INT_MAX)
    return cudaErrorInvalidValue;
  args.units = static_cast<int>(units);
  const int grid = static_cast<int>(units < sms ? units : sms);  // persistent
  if (map_v == nullptr && (args.kv_len < args.T || args.qs.head != args.hd)) {
    const cudaError_t err = allow_dynamic_smem(packed_attention_kernel<HDP, true>, smem);
    if (err != cudaSuccess) return err;
    packed_attention_kernel<HDP, true><<<grid, kThreads, smem, stream>>>(map_k, args);
  } else if (map_v == nullptr) {
    const cudaError_t err = allow_dynamic_smem(packed_attention_kernel<HDP, false>, smem);
    if (err != cudaSuccess) return err;
    packed_attention_kernel<HDP, false><<<grid, kThreads, smem, stream>>>(map_k, args);
  } else {
    const cudaError_t err = allow_dynamic_smem(single_pass_attention_kernel<HDP>, smem);
    if (err != cudaSuccess) return err;
    single_pass_attention_kernel<HDP><<<grid, kThreads, smem, stream>>>(map_k, *map_v, args);
  }
  return cudaGetLastError();
}

// The packed [B, T, 3D] buffer as one map of 3H heads of hd columns: slab
// packing puts head h's q, K and V at head coordinates h, H + h and 2H + h,
// per-head packing at 3h, 3h + 1 and 3h + 2.
template <int HDP>
cudaError_t launch_packed(const void* qkv, void* out, int B, int T, int kv_len, int num_heads,
                          int hd, bool per_head, float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const long long D = static_cast<long long>(num_heads) * hd;
  FwdArgs args{static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
               {T * 3 * D, per_head ? 3LL * hd : hd, 3 * D}, {T * D, hd, D}, {}, {},
               T, kv_len, num_heads, hd, 0, scale};
  CUtensorMap map;
  if (!encode_view_map(&map, &args.ko, encode, qkv, hd, B, 3 * num_heads, T, T * 3 * D, hd,
                       3 * D))
    return cudaErrorInvalidValue;
  args.vo = args.ko;
  return launch_fwd<HDP>(map, nullptr, args, B, stream);
}

template <int HDP>
cudaError_t launch_views(const void* q, const void* k, const void* v, void* out,
                         const long long* st, int B, int H, int T, int kv_len, int hd,
                         float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  FwdArgs args{static_cast<const bf16*>(q), static_cast<bf16*>(out),
               {st[0], st[1], st[2]}, {st[9], st[10], st[11]}, {}, {},
               T, kv_len, H, hd, 0, scale};
  CUtensorMap map_k, map_v;
  if (!encode_view_map(&map_k, &args.ko, encode, k, hd, B, H, T, st[3], st[4], st[5]) ||
      !encode_view_map(&map_v, &args.vo, encode, v, hd, B, H, T, st[6], st[7], st[8]))
    return cudaErrorInvalidValue;
  return launch_fwd<HDP>(map_k, &map_v, args, B, stream);
}

cudaError_t single_pass_views_bf16(const void* q, const void* k, const void* v, void* out,
                                   const long long* strides, int B, int H, int T, int kv_len,
                                   int hd, float scale, cudaStream_t stream) {
  switch ((hd + 15) / 16 * 16) {
    case 16: return launch_views<16>(q, k, v, out, strides, B, H, T, kv_len, hd, scale, stream);
    case 32: return launch_views<32>(q, k, v, out, strides, B, H, T, kv_len, hd, scale, stream);
    case 48: return launch_views<48>(q, k, v, out, strides, B, H, T, kv_len, hd, scale, stream);
    case 64: return launch_views<64>(q, k, v, out, strides, B, H, T, kv_len, hd, scale, stream);
    case 80: return launch_views<80>(q, k, v, out, strides, B, H, T, kv_len, hd, scale, stream);
    case 96: return launch_views<96>(q, k, v, out, strides, B, H, T, kv_len, hd, scale, stream);
    case 112: return launch_views<112>(q, k, v, out, strides, B, H, T, kv_len, hd, scale, stream);
    case 128: return launch_views<128>(q, k, v, out, strides, B, H, T, kv_len, hd, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn90
}  // namespace vit

#define VIT_PACKED_DISPATCH(...)                                         \
  switch ((head_dim + 15) / 16 * 16) {                                   \
    case 16: return launch_packed<16>(__VA_ARGS__);                      \
    case 32: return launch_packed<32>(__VA_ARGS__);                      \
    case 48: return launch_packed<48>(__VA_ARGS__);                      \
    case 64: return launch_packed<64>(__VA_ARGS__);                      \
    case 80: return launch_packed<80>(__VA_ARGS__);                      \
    case 96: return launch_packed<96>(__VA_ARGS__);                      \
    case 112: return launch_packed<112>(__VA_ARGS__);                    \
    case 128: return launch_packed<128>(__VA_ARGS__);                    \
    default: return cudaErrorInvalidValue;                               \
  }

// Slab packing, T keys. head_dim must be a multiple of 8 and at most 128
// (ops/attention.py checks that before calling); any T.
VIT_EXPORT int vit_packed_attention_bf16(const void* qkv, void* out, int B,
                                         int T, int num_heads, int head_dim,
                                         float scale, void* stream) {
  using namespace vit::attn90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0)
    return cudaErrorInvalidValue;
  VIT_PACKED_DISPATCH(qkv, out, B, T, T, num_heads, head_dim, false, scale, s)
}

// The same kernel with keys at and past kv_len (1 <= kv_len <= T) masked
// and slab (per_head 0) or per-head (1) packing: its general form, or its
// slab form for slab packing and T keys.
VIT_EXPORT int vit_packed_attention_kv(const void* qkv, void* out, int B, int T, int kv_len,
                                       int num_heads, int head_dim, int per_head, float scale,
                                       void* stream) {
  using namespace vit::attn90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || kv_len <= 0 || kv_len > T || num_heads <= 0 ||
      head_dim % 8 != 0 || (per_head != 0 && per_head != 1))
    return cudaErrorInvalidValue;
  VIT_PACKED_DISPATCH(qkv, out, B, T, kv_len, num_heads, head_dim, per_head != 0, scale, s)
}

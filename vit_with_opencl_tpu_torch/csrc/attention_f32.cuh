// One fp32 attention body on register tiles, for three functions that
// differ in small ways (a template parameter, the form):
//   single pass  (attention_single.cu, fp32: the single-pass attention's
//                fp32 form) q, k, v, out strided [B, H, T, hd] views; q
//                scaled in fp32 first; keys at and past kv_len masked; one
//                key block of all keys (the one-shot max over every key);
//                o normalised by 1 / rowsum(e) after the PV product.
//   ring step    (attention_ring.cu, fp32: the ring step's fp32 form) q, k,
//                v contiguous [n, t_loc, hd]; the scores scaled, then a
//                per-key bias added (two roundings); the key blocks of
//                block_k keys in order, each with its exact max, the row's
//                (m, l, acc) carried in and out, un-normalised.
//   blockwise    (attention_flash_f32.cu: the blockwise forward's fp32
//                form) q, k, v, out strided views; the scores scaled (q is
//                not); keys at and past kv_len masked; the key blocks of
//                block_k keys in order, each with its exact max, from m =
//                -inf, l = 0, o = 0; o normalised by 1 / l (l == 0 -> 1)
//                and, where asked, lse = m + log(l) (l == 0 -> 1) written.
// The blockwise form skips a block's 64-key tiles that hold no key below
// kv_len (the other forms have none).
// Per key block, two passes over its 64-key tiles: the block's exact row
// max of s, then p = exp(s - m') (fp32, not rounded), its row sum and
// o += p . V; between them the running max moves and o is rescaled by
// a = exp(m - m') (single pass: m = -inf, o = 0 before the one block).
//
// Products stay plain fp32 FMA on the CUDA cores (no TF32). Bound on the
// card: operations (67 TFLOP/s fp32). One thread a query row, reading each
// K and V element as a shared-memory broadcast, would spend a load on every
// FMA; so a block of 256 threads takes 64 queries, and thread t owns
// queries t / 16 + 16 i and, of each 64-key tile, keys t % 16 + 16 j (i, j
// < 4) of S: a 4 x 4 micro-tile whose operands are whole float4s along hd,
// four q rows and four K rows, 64 FMAs for eight 16-byte loads. q, K and V
// sit row-major in shared memory (rows padded by 4 floats, so that the 16
// rows a half-warp reads fall on distinct banks), copied by coalesced
// 16-byte cp.async (q by plain loads, scaled on the way for the single
// pass). p goes to shared memory [query][key]; then o += p . V is a second
// register-tiled product in which the same thread owns its 4 queries x the
// float4 columns t % 16, t % 16 + 16 of V. The 16 threads of a query group
// are one half-warp, so a row's max and sum cross them with shuffles. K, V
// and the keys' bias (or mask) are double-buffered: the next tile's copies
// run under this tile's products. Every output element sums over hd and
// over the keys in a fixed order: two calls give the same bits.
#pragma once

#include <math.h>

#include "common.cuh"

namespace vit {
namespace f32attn {

constexpr int kQ = 64;          // queries of a block
constexpr int kK = 64;          // keys of a tile
constexpr int kThreads = 256;   // 16 query groups x 16 key (or column) groups
constexpr int kPPitch = 64 + 16;  // a row of p, in floats: two rows 16 banks apart
static_assert(kQ == 64 && kK == 64, "the tiles below are 64 rows");
// The body's forms (its template parameter).
constexpr int kSinglePass = 0, kRingStep = 1, kBlockwise = 2;

// Shared memory of a block, in floats: q [kQ][HDP + 4], K 2 x [kK][HDP + 4],
// V 2 x [kK][HDP + 4], p [kQ][kPPitch], bias 2 x [kK].
template <int HDP>
struct Geom {
  static constexpr int kChunks = HDP / 4;            // float4 columns of a row
  static constexpr int kCols = (kChunks + 15) / 16;  // a thread's float4 columns of o
  static constexpr int kPitch = HDP + 4;             // a row of q, K and V
  static constexpr int kTile = 64 * kPitch;          // a 64-row tile, in floats
  static constexpr int kKs = kTile;
  static constexpr int kVs = kKs + 2 * kTile;
  static constexpr int kP = kVs + 2 * kTile;
  static constexpr int kBias = kP + kQ * kPPitch;
  static constexpr int kFloats = kBias + 2 * kK;
};
template <int HDP>
__host__ __device__ constexpr size_t smem_bytes() {
  return Geom<HDP>::kFloats * sizeof(float);
}
// Blocks an SM: two where their shared memory fits twice (up to hd 64),
// so that one block's barriers and copies run under the other's FMAs.
// (Holding a block's scores in registers between the passes, up to 5
// tiles, needed 218-246 registers a thread, one block an SM, and ran
// slower at the ring's 257-key shards than S computed twice.)
template <int HDP>
__host__ __device__ constexpr int min_blocks() {
  return HDP <= 64 ? 2 : 1;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));  // 0: fill with zeros
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The max and the sum over the 16 lanes of a half-warp (a query group's
// threads): a butterfly, so every lane gets the same bits.
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int w = 1; w < 16; w *= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, w));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int w = 1; w < 16; w *= 2) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The tiling, shared with the fp32 attention backward (attention_bwd_f32.cu).
// A 64-row tile is [64][kPitch] floats; a thread's rows are rg + 16 i of
// one operand and cg + 16 j of the other (i, j < 4), rg = t / 16, cg = t % 16
// (or the other way round).

// Rows r0.. of a [rows, hd] view (rows ld floats apart) into a 64-row tile
// and, where `two`, the same rows of a second view into a second tile (one
// loop); zeros at and past row `end` and past hd, by 16-byte cp.async; the
// copies join the caller's group.
template <int HDP>
__device__ __forceinline__ void load_rows(float* tile, const float* src, long long ld,
                                          float* tile2, const float* src2, long long ld2,
                                          bool two, int r0, int end, int hd, int t) {
  using G = Geom<HDP>;
  for (int i = t; i < 64 * G::kChunks; i += kThreads) {
    const int r = i / G::kChunks, c = i % G::kChunks;
    const bool ok = r0 + r < end && 4 * c < hd;
    cp_async16(tile + r * G::kPitch + 4 * c, ok ? src + (r0 + r) * ld + 4 * c : src, ok);
    if (two)
      cp_async16(tile2 + r * G::kPitch + 4 * c, ok ? src2 + (r0 + r) * ld2 + 4 * c : src2, ok);
  }
}
template <int HDP>
__device__ __forceinline__ void load_rows(float* tile, const float* src, long long ld, int r0,
                                          int end, int hd, int t) {
  load_rows<HDP>(tile, src, ld, nullptr, nullptr, 0, false, r0, end, hd, t);
}

// sc[i][j] = the sum over d, in order, of R[rg + 16 i][d] * C[cg + 16 j][d]
// (two tiles); kScaleC: C's values times `scale` first (each product
// rounded).
template <int HDP, bool kScaleC = false>
__device__ __forceinline__ void products(const float* R, const float* C, int rg, int cg,
                                         float scale, float (&sc)[4][4]) {
  constexpr int kPitch = Geom<HDP>::kPitch;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; d += 4) {
    float4 rv[4], cv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rv[i] = *reinterpret_cast<const float4*>(R + (rg + 16 * i) * kPitch + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cv[j] = *reinterpret_cast<const float4*>(C + (cg + 16 * j) * kPitch + d);
      if (kScaleC) {
        cv[j].x = __fmul_rn(cv[j].x, scale);
        cv[j].y = __fmul_rn(cv[j].y, scale);
        cv[j].z = __fmul_rn(cv[j].z, scale);
        cv[j].w = __fmul_rn(cv[j].w, scale);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] = fmaf(lane_of(rv[i], e), lane_of(cv[j], e), sc[i][j]);
  }
}

// o[i][..] += P[rg + 16 i][j] * V[j][..] over j < nk, in order, in steps of
// 4 (P [64][kPPitch], its entries past nk zeros; V a tile), the float4
// columns cg + 16 c of V.
template <int HDP>
__device__ __forceinline__ void accumulate(const float* P, const float* V, int rg, int cg,
                                           int nk, float (&o)[4][4 * Geom<HDP>::kCols]) {
  using G = Geom<HDP>;
  for (int j = 0; j < nk; j += 4) {
    float4 pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pr[i] = *reinterpret_cast<const float4*>(P + (rg + 16 * i) * kPPitch + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < G::kCols; ++c) {
        const int chunk = cg + 16 * c;
        if (chunk < G::kChunks) {
          const float4 vv =
              *reinterpret_cast<const float4*>(V + (j + jj) * G::kPitch + 4 * chunk);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pw = lane_of(pr[i], jj);
            o[i][4 * c] = fmaf(pw, vv.x, o[i][4 * c]);
            o[i][4 * c + 1] = fmaf(pw, vv.y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(pw, vv.z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(pw, vv.w, o[i][4 * c + 3]);
          }
        }
      }
  }
}

// A step of a double-buffered stream of nsteps steps: step s + 1's copies
// issued (fetch, which commits them), step s's landed, then a barrier.
// The step's end is a barrier too: a buffer is refilled two steps on.
template <typename Fetch>
__device__ __forceinline__ void begin_step(const Fetch& fetch, int s, int nsteps) {
  if (s + 1 < nsteps) {
    fetch(s + 1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}

// What the entries pass. Single pass: q, k, v, out views (image b =
// blockIdx.z, head h = blockIdx.y), T rows, keys below kv_len, block_k =
// kv_len, scale multiplies q. Ring step: [n, t_loc, hd] (row group b =
// blockIdx.z, h = 0), kv_len = T = t_loc, scale multiplies the scores,
// bias [T], m_in, l_in [n, T] and acc_in (out's layout) in, m_out, l_out
// and out (the accumulator) out. Blockwise: the single pass's views, keys
// below kv_len in blocks of block_k, scale multiplies the scores; lse
// [B, H, T] (H = gridDim.y) or null.
struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  Strides qs, ks, vs, os;
  const float* bias;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  int T, kv_len, block_k, hd;
  float scale;
  float* lse;
};

template <int HDP, int kForm>
__device__ __forceinline__ void attention_f32(const Args& a) {
  constexpr bool kRing = kForm == kRingStep;
  using G = Geom<HDP>;
  constexpr int kChunks = G::kChunks, kCols = G::kCols, kPitch = G::kPitch;
  extern __shared__ __align__(16) float f32_smem[];
  float* const qs = f32_smem;
  float* const ks0 = f32_smem + G::kKs;
  float* const vs0 = f32_smem + G::kVs;
  float* const ps = f32_smem + G::kP;
  float* const bs0 = f32_smem + G::kBias;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int t = threadIdx.x, qg = t / 16, kg = t % 16;
  const int T = a.T, hd = a.hd, kv_len = a.kv_len, block_k = a.block_k;
  const float scale = a.scale;
  const float* qb = head_base(a.q, a.qs, b, h);
  const float* kb = head_base(a.k, a.ks, b, h);
  const float* vb = head_base(a.v, a.vs, b, h);

  // q into shared memory, zeros past T and hd; the single pass scales it
  // first (fp32, q * scale).
  for (int i = t; i < kQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T && 4 * c < hd)
      x = __ldg(reinterpret_cast<const float4*>(qb + (q0 + r) * a.qs.row + 4 * c));
    if (kForm == kSinglePass) {
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(qs + r * kPitch + 4 * c) = x;
  }

  // The thread's 4 rows (queries qg + 16 i): their running max, sum and
  // accumulator (float4 columns kg + 16 c); the ring step carries them in.
  float m[4], l[4], o[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + qg + 16 * i;
    const bool live = kRing && row < T;
    m[i] = live ? a.m_in[static_cast<size_t>(b) * T + row] : -INFINITY;
    l[i] = live ? a.l_in[static_cast<size_t>(b) * T + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int chunk = kg + 16 * c;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && chunk < kChunks && 4 * chunk < hd)
        x = __ldg(reinterpret_cast<const float4*>(head_base(a.acc_in, a.os, b, h) +
                                                  row * a.os.row + 4 * chunk));
      o[i][4 * c] = x.x;
      o[i][4 * c + 1] = x.y;
      o[i][4 * c + 2] = x.z;
      o[i][4 * c + 3] = x.w;
    }
  }

  // Steps: key block s / (2 nt); of its 2 nt steps, [0, nt) are pass 1 (K
  // tiles and their biases), [nt, 2 nt) pass 2 (K and V tiles, the biases
  // again). Rows at and past the block's end arrive as zeros, and their
  // bias as -inf (no max, p exactly 0). The blockwise form's last block may
  // hold whole tiles past kv_len (the other forms' blocks end at kv_len
  // whole): their steps copy and compute nothing.
  const int nt = (block_k + kK - 1) / kK;
  const int nsteps = ((kv_len + block_k - 1) / block_k) * 2 * nt;
  auto fetch = [&](int s) {
    const int bi = s / (2 * nt), r = s % (2 * nt), tile = r % nt, buf = s & 1;
    const int j0 = bi * block_k + tile * kK, kend = min(bi * block_k + block_k, kv_len);
    if (kForm != kBlockwise || j0 < kend) {
      load_rows<HDP>(ks0 + buf * G::kTile, kb, a.ks.row, vs0 + buf * G::kTile, vb,
                     a.vs.row, r >= nt, j0, kend, hd, t);
      if (t < kK)
        bs0[buf * kK + t] = j0 + t < kend ? (kRing ? __ldg(a.bias + j0 + t) : 0.f) : -INFINITY;
    }
    cp_async_commit();
  };
  int s = 0;
  // A step's end (the buffers are refilled two steps on, p one step on).
  auto end_step = [&]() {
    __syncthreads();
    ++s;
  };
  // S of the step's K tile: queries qg + 16 i, keys kg + 16 j, summed over
  // hd in order; then the ring step's s * scale + bias (two roundings), the
  // blockwise form's s * scale + 0 (or -inf past kv_len), the single pass's
  // s + 0 (or -inf past kv_len).
  auto scores = [&](float (&sc)[4][4]) {
    const int buf = s & 1;
    products<HDP>(qs, ks0 + buf * G::kTile, qg, kg, 0.f, sc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = bs0[buf * kK + kg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sc[i][j] = kForm == kSinglePass ? __fadd_rn(sc[i][j], bj)
                                        : __fadd_rn(__fmul_rn(sc[i][j], scale), bj);
    }
  };
  float mb[4], lb[4], al[4];
  auto max_into = [&](const float (&sc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      mb[i] = fmaxf(mb[i], fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3])));
  };
  // The block's max is known: move the running max, rescale o.
  auto move_max = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], group_max(mb[i]));
      al[i] = expf(m[i] - mn);  // 0 from m = -inf
      m[i] = mn;
      mb[i] = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4 * kCols; ++e) o[i][e] *= al[i];
    }
  };
  // p = exp(s - m') into shared memory, its row sums into lb; then o +=
  // p . V over the step's V tile's nk keys, in key order.
  auto pv = [&](const float (&sc)[4][4], int nk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(sc[i][j] - m[i]);
        ps[(qg + 16 * i) * kPPitch + kg + 16 * j] = p[j];
      }
      lb[i] += ((p[0] + p[1]) + p[2]) + p[3];
    }
    __syncthreads();
    accumulate<HDP>(ps, vs0 + (s & 1) * G::kTile, qg, kg, nk, o);
  };
  // The block is done: l' = a * l + rowsum(p).
  auto move_sum = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = __fadd_rn(__fmul_rn(al[i], l[i]), group_sum(lb[i]));
      lb[i] = 0.f;
    }
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mb[i] = -INFINITY;
    lb[i] = 0.f;
    al[i] = 1.f;
  }
  fetch(0);
  for (int k0 = 0; k0 < kv_len; k0 += block_k) {
    const int kend = min(k0 + block_k, kv_len);
    // Pass 1: the block's exact max; pass 2: S again, p and p . V.
    for (int tile = 0; tile < nt; ++tile) {
      float sc[4][4];
      begin_step(fetch, s, nsteps);
      if (kForm != kBlockwise || k0 + tile * kK < kend) {
        scores(sc);
        max_into(sc);
      }
      end_step();
    }
    move_max();
    for (int tile = 0; tile < nt; ++tile) {
      float sc[4][4];
      begin_step(fetch, s, nsteps);
      if (kForm != kBlockwise || k0 + tile * kK < kend) {
        scores(sc);
        pv(sc, min(kK, kend - (k0 + tile * kK)));
      }
      end_step();
    }
    move_sum();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + qg + 16 * i;
    if (row >= T) continue;
    if (kRing && kg == 0) {
      a.m_out[static_cast<size_t>(b) * T + row] = m[i];
      a.l_out[static_cast<size_t>(b) * T + row] = l[i];
    }
    const float l_safe = kForm == kBlockwise && l[i] == 0.f ? 1.f : l[i];
    if (kForm == kBlockwise && a.lse != nullptr && kg == 0)
      a.lse[(static_cast<size_t>(b) * gridDim.y + h) * T + row] = m[i] + logf(l_safe);
    const float inv = kRing ? 1.f : 1.f / l_safe;
    float* orow = head_base(a.out, a.os, b, h) + row * a.os.row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int chunk = kg + 16 * c;
      if (chunk < kChunks && 4 * chunk < hd)
        *reinterpret_cast<float4*>(orow + 4 * chunk) =
            kRing ? make_float4(o[i][4 * c], o[i][4 * c + 1], o[i][4 * c + 2], o[i][4 * c + 3])
                  : make_float4(o[i][4 * c] * inv, o[i][4 * c + 1] * inv,
                                o[i][4 * c + 2] * inv, o[i][4 * c + 3] * inv);
    }
  }
}

// One launch of a form of the body (a kernel that calls attention_f32):
// grid (query tiles, heads, images or row groups).
template <typename Kernel>
__host__ inline cudaError_t launch(Kernel kernel, size_t smem, const Args& args, int heads,
                                   int images, cudaStream_t stream) {
  if (images > 65535 || heads > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.T + kQ - 1) / kQ, heads, images);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace f32attn
}  // namespace vit

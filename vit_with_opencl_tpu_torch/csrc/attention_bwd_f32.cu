// Backward of multi-head attention over a packed QKV buffer in fp32:
// (qkv [B, T, 3D], dO [B, T, D]) -> dqkv [B, T, 3D], fp32 or bf16.
//
// Replaces vit_with_opencl_tpu/ops/attention.py:_packed_bwd_kernel
// (packed_attention_bwd) with fp32 qkv and dO, and the per-head backward
// that ops/fused_block.py:_attn_bwd_kernel inlines, as attention_bwd.cu does
// in bf16. Per head, the TPU kernel's arithmetic (it recomputes the softmax):
//   qs = q * scale                fp32, rounded (as the forward)
//   s  = qs . k^T; m = rowmax(s); e = exp(s - m); inv = 1 / rowsum(e)
//   p  = e * inv                  the normalised probability
//   dp = dO . v^T
//   ds = (p * (dp - delta)) * scale,  delta = rowsum(dp * p)
//   dq = ds . k,  dk = ds^T . q (the unscaled q),  dv = p^T . dO
// with the bf16 form's one reassociation: delta = inv * rowsum(e * dp), so
// that it comes out of the same pass as rowsum(e). Everything else differs
// from the plain version only in the order of fp32 sums.
//
// Bound on the card: operations (10 T^2 hd a head, the five products, at
// 67 TFLOP/s fp32: 4.77 GFLOP, 0.071 ms at ViT-B's T = 197, B = 16; the
// kernels' own work, S and dP recomputed, is twice that). Design: the fp32
// attention body's tiling (attention_f32.cuh: load_rows, products,
// accumulate, begin_step) in two kernels, FlashAttention-2's split, so that
// no block sums into another's output and dqkv has the same bits from run
// to run. Blocks of 256 threads own 64 rows; every product is the body's
// register tiling: thread t owns rows t / 16 + 16 i and, of each 64-row
// tile of the other operand, rows t % 16 + 16 j (i, j < 4), a 4 x 4
// micro-tile read as float4s along hd from row-major tiles in rows of hd +
// 4 floats (16 rows a half-warp reads fall on distinct banks); p or ds go
// to shared memory [row][key] for the register-tiled product that follows
// (o += p . V's pattern). Streamed tiles come by 16-byte cp.async, double-buffered, zero
// past T and hd.
//   dq kernel   per (image, head, 64 queries): qs and dO resident; K and V
//               tiles stream three times: pass 1 S for the exact row max;
//               pass 2 S and dP for rowsum(e) and rowsum(e * dp); pass 3 S
//               and dP again for ds, then dq += ds . K. It writes each row's
//               (m, inv, delta) to the statistics buffer, 16 bytes a row,
//               whole 64-row tiles (zeros past T).
//   dkv kernel  per (image, head, 64 keys): K and V resident; q and dO
//               tiles and their rows' statistics stream once: S^T = K .
//               (q * scale)^T (the same sums as the dq kernel's S, element
//               for element) and dP^T = V . dO^T, p^T and ds^T from them,
//               then dv += p^T . dO and dk += ds^T . q.
// A block's shared memory depends on the head dim only (at hd 128, 218 KiB
// and 220 KiB), never on T.
//
// The same two kernels in a form whose statistics are given: the blockwise
// backward's fp32 form, which replaces
// vit_with_opencl_tpu/ops/attention.py:_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (blockwise_attention_bwd, the route past padded
// T = 1024) with fp32 qkv, out, lse and dO. p comes from the forward's
// log-sum-exp instead of a recomputed softmax, and the scale multiplies the
// scores, not q:
//   s  = (q . k^T) * scale, keys at and past T masked (p exactly 0)
//   p  = exp(s - lse),  dp = dO . v^T,  dvec = rowsum(dO * O)
//   ds = (p * (dp - dvec)) * scale
//   dq = ds . k,  dk = ds^T . q (the unscaled q),  dv = p^T . dO
// fp32 throughout, the sums in another order than JAX's. Bound on the card:
// operations, 10 T^2 hd a head at 67 TFLOP/s fp32 (0.642 ms at
// ViT-L/16@512, B = 4; 2.568 ms at B = 16); the kernels do 14 (s and dp in
// both). The dq kernel (flash_bwd_dq_f32_kernel) keeps q and dO resident,
// computes its rows' dvec from dO and O, and streams each K and V tile
// once (the recomputing form's passes 1 and 2, which found the row's max
// and sums, go away); it writes each row's (lse, dvec) to the statistics
// buffer, 8 bytes a row, whole 64-row tiles (zeros past T), which the
// dK/dV kernel (flash_bwd_dkv_f32_kernel) streams beside q and dO past its
// resident K and V, as the recomputing form streams (m, inv, delta).
#include "attention_f32.cuh"

namespace vit {
namespace f32bwd {

using f32attn::accumulate;
using f32attn::begin_step;
using f32attn::Geom;
using f32attn::kK;
using f32attn::kPPitch;
using f32attn::kQ;
using f32attn::kThreads;
using f32attn::load_rows;
using f32attn::products;

// Shared memory of a block, in floats: six 64-row tiles (dq: qs, dO, K and
// V twice; dkv: K, V, q and dO twice), p or ds [64][kPPitch], and (dkv) two
// tiles' statistics, 64 float4 each (64 float2 each where they are given).
template <int HDP>
struct Smem {
  static constexpr int kDq = 6 * Geom<HDP>::kTile + 64 * kPPitch;
  static constexpr int kDkv = kDq + 2 * 64 * 4;
  static constexpr int kDkvGiven = kDq + 2 * 64 * 2;
};

struct Args {
  const float* qkv;
  const float* dout;
  void* dqkv;
  int out_bf16;
  // [B, H, rows, 4]: (m, inv, delta, 0), rows = T in whole 64-row tiles;
  // where the statistics are given, [B, H, rows, 2]: (lse, dvec).
  float* stats;
  int T, H, hd;
  float scale;
  const float* out;  // the forward's output [B, T, D] and lse [B, H, T]
  const float* lse;  // (the form whose statistics are given)
};

// The thread's rows rg + 16 i (below T) of o into columns `col` of dqkv's
// rows (3 D apart), float4 column cg + 16 c at a time.
template <int HDP>
__device__ __forceinline__ void store_rows(const Args& a, int b, int r0, int rg, int cg,
                                           long long col, const float (&o)[4][4 * Geom<HDP>::kCols]) {
  using G = Geom<HDP>;
  const long long row_len = 3LL * a.H * a.hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg + 16 * i;
    if (row >= a.T) continue;
    const long long base = (static_cast<long long>(b) * a.T + row) * row_len + col;
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) {
      const int chunk = cg + 16 * c;
      if (chunk >= G::kChunks || 4 * chunk >= a.hd) continue;
      const float* v = &o[i][4 * c];
      if (a.out_bf16) {
        uint2 p;
        p.x = pack_bf16x2(v[0], v[1]);
        p.y = pack_bf16x2(v[2], v[3]);
        *reinterpret_cast<uint2*>(static_cast<bf16*>(a.dqkv) + base + 4 * chunk) = p;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(a.dqkv) + base + 4 * chunk) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_f32_kernel(const __grid_constant__ Args a) {
  using G = Geom<HDP>;
  extern __shared__ __align__(16) float bwd_smem[];
  float* const qs = bwd_smem;
  float* const dos = qs + G::kTile;
  float* const ks0 = dos + G::kTile;
  float* const vs0 = ks0 + 2 * G::kTile;
  float* const ps = vs0 + 2 * G::kTile;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int t = threadIdx.x, qg = t / 16, kg = t % 16;
  const int T = a.T, hd = a.hd;
  const long long D = static_cast<long long>(a.H) * hd;
  const float scale = a.scale;
  const float* img = a.qkv + static_cast<long long>(b) * T * 3 * D;
  const float* qb = img + h * hd;
  const float* kb = img + D + h * hd;
  const float* vb = img + 2 * D + h * hd;
  const float* dob = a.dout + static_cast<long long>(b) * T * D + h * hd;

  // qs = q * scale and dO, zeros past T and hd.
  for (int i = t; i < kQ * G::kChunks; i += kThreads) {
    const int r = i / G::kChunks, c = i % G::kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (q0 + r < T && 4 * c < hd) {
      x = __ldg(reinterpret_cast<const float4*>(qb + (q0 + r) * 3 * D + 4 * c));
      y = __ldg(reinterpret_cast<const float4*>(dob + (q0 + r) * D + 4 * c));
    }
    x.x = __fmul_rn(x.x, scale);
    x.y = __fmul_rn(x.y, scale);
    x.z = __fmul_rn(x.z, scale);
    x.w = __fmul_rn(x.w, scale);
    *reinterpret_cast<float4*>(qs + r * G::kPitch + 4 * c) = x;
    *reinterpret_cast<float4*>(dos + r * G::kPitch + 4 * c) = y;
  }

  // Steps: [0, nt) pass 1 (K tiles), [nt, 2 nt) pass 2 and [2 nt, 3 nt)
  // pass 3 (K and V tiles).
  const int nt = (T + kK - 1) / kK, nsteps = 3 * nt;
  auto fetch = [&](int s) {
    const int tile = s % nt, buf = s & 1;
    load_rows<HDP>(ks0 + buf * G::kTile, kb, 3 * D, tile * kK, T, hd, t);
    if (s >= nt) load_rows<HDP>(vs0 + buf * G::kTile, vb, 3 * D, tile * kK, T, hd, t);
    f32attn::cp_async_commit();
  };
  int s = 0;
  auto end_step = [&]() {
    __syncthreads();
    ++s;
  };
  // S of the step's K tile, keys at and past T at -inf; and dP of its V tile.
  auto scores = [&](float (&sc)[4][4]) {
    products<HDP>(qs, ks0 + (s & 1) * G::kTile, qg, kg, 0.f, sc);
    const int j0 = (s % nt) * kK;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j0 + kg + 16 * j >= T)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][j] = -INFINITY;
  };
  auto dprods = [&](float (&dp)[4][4]) {
    products<HDP>(dos, vs0 + (s & 1) * G::kTile, qg, kg, 0.f, dp);
  };

  float m[4], inv[4], delta[4], lb[4], db[4], dq[4][4 * G::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lb[i] = 0.f;
    db[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * G::kCols; ++e) dq[i][e] = 0.f;
  }
  fetch(0);
  // Pass 1: the exact row max.
  for (int tile = 0; tile < nt; ++tile) {
    float sc[4][4];
    begin_step(fetch, s, nsteps);
    scores(sc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      m[i] = fmaxf(m[i], fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3])));
    end_step();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = f32attn::group_max(m[i]);
  // Pass 2: rowsum(e) and rowsum(e * dp).
  for (int tile = 0; tile < nt; ++tile) {
    float sc[4][4], dp[4][4];
    begin_step(fetch, s, nsteps);
    scores(sc);
    dprods(dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(sc[i][j] - m[i]);
        lb[i] += e;
        db[i] = fmaf(e, dp[i][j], db[i]);
      }
    end_step();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = 1.f / f32attn::group_sum(lb[i]);
    delta[i] = __fmul_rn(inv[i], f32attn::group_sum(db[i]));
  }
  // Pass 3: ds into shared memory, then dq += ds . K.
  for (int tile = 0; tile < nt; ++tile) {
    float sc[4][4], dp[4][4];
    begin_step(fetch, s, nsteps);
    scores(sc);
    dprods(dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __fmul_rn(expf(sc[i][j] - m[i]), inv[i]);
        ps[(qg + 16 * i) * kPPitch + kg + 16 * j] =
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], delta[i])), scale);
      }
    __syncthreads();
    accumulate<HDP>(ps, ks0 + (s & 1) * G::kTile, qg, kg, min(kK, T - tile * kK), dq);
    end_step();
  }

  store_rows<HDP>(a, b, q0, qg, kg, static_cast<long long>(h) * hd, dq);
  if (kg == 0) {
    const int rows = nt * kK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + qg + 16 * i;
      const bool live = row < T;
      reinterpret_cast<float4*>(a.stats)[(static_cast<long long>(b) * a.H + h) * rows + row] =
          live ? make_float4(m[i], inv[i], delta[i], 0.f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkv_f32_kernel(const __grid_constant__ Args a) {
  using G = Geom<HDP>;
  extern __shared__ __align__(16) float bwd_smem[];
  float* const ks = bwd_smem;
  float* const vs = ks + G::kTile;
  float* const qt0 = vs + G::kTile;
  float* const dt0 = qt0 + 2 * G::kTile;
  float* const ps = dt0 + 2 * G::kTile;
  float* const st0 = ps + 64 * kPPitch;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kK;
  const int t = threadIdx.x, kg = t / 16, qg = t % 16;
  const int T = a.T, hd = a.hd;
  const long long D = static_cast<long long>(a.H) * hd;
  const float scale = a.scale;
  const float* img = a.qkv + static_cast<long long>(b) * T * 3 * D;
  const float* qb = img + h * hd;
  const float* dob = a.dout + static_cast<long long>(b) * T * D + h * hd;
  const int nt = (T + kQ - 1) / kQ;
  const float* stats =
      a.stats + (static_cast<long long>(b) * a.H + h) * static_cast<long long>(nt * kQ) * 4;

  load_rows<HDP>(ks, img + D + h * hd, 3 * D, k0, T, hd, t);
  load_rows<HDP>(vs, img + 2 * D + h * hd, 3 * D, k0, T, hd, t);
  f32attn::cp_async_commit();
  auto fetch = [&](int s) {
    const int buf = s & 1;
    load_rows<HDP>(qt0 + buf * G::kTile, qb, 3 * D, s * kQ, T, hd, t);
    load_rows<HDP>(dt0 + buf * G::kTile, dob, D, s * kQ, T, hd, t);
    if (t < kQ) f32attn::cp_async16(st0 + buf * 4 * kQ + 4 * t, stats + 4 * (s * kQ + t), true);
    f32attn::cp_async_commit();
  };

  float dk[4][4 * G::kCols], dv[4][4 * G::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * G::kCols; ++e) {
      dk[i][e] = 0.f;
      dv[i][e] = 0.f;
    }
  fetch(0);
  for (int s = 0; s < nt; ++s) {
    begin_step(fetch, s, nt);
    const int buf = s & 1;
    const float* qt = qt0 + buf * G::kTile;
    const float* dt = dt0 + buf * G::kTile;
    const float4* st = reinterpret_cast<const float4*>(st0 + buf * 4 * kQ);
    float sc[4][4], dp[4][4], ds[4][4];
    products<HDP, true>(ks, qt, kg, qg, scale, sc);
    products<HDP>(vs, dt, kg, qg, 0.f, dp);
    // p^T and ds^T; keys past T at 0 (their rows are not written), queries
    // past T at 0 through their zero statistics.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 r = st[qg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = k0 + kg + 16 * i < T;
        const float p = live ? __fmul_rn(expf(sc[i][j] - r.x), r.y) : 0.f;
        ds[i][j] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], r.z)), scale);
        ps[(kg + 16 * i) * kPPitch + qg + 16 * j] = p;
      }
    }
    __syncthreads();
    const int nq = min(kQ, T - s * kQ);
    accumulate<HDP>(ps, dt, kg, qg, nq, dv);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(kg + 16 * i) * kPPitch + qg + 16 * j] = ds[i][j];
    __syncthreads();
    accumulate<HDP>(ps, qt, kg, qg, nq, dk);
    __syncthreads();  // the buffers are refilled two steps on, p one step on
  }
  store_rows<HDP>(a, b, k0, kg, qg, D + static_cast<long long>(h) * hd, dk);
  store_rows<HDP>(a, b, k0, kg, qg, 2 * D + static_cast<long long>(h) * hd, dv);
}

// dq with the statistics given: per (image, head, 64 queries), q (unscaled)
// and dO resident, each K and V tile streamed once.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ Args a) {
  using G = Geom<HDP>;
  extern __shared__ __align__(16) float bwd_smem[];
  float* const qs = bwd_smem;
  float* const dos = qs + G::kTile;
  float* const ks0 = dos + G::kTile;
  float* const vs0 = ks0 + 2 * G::kTile;
  float* const ps = vs0 + 2 * G::kTile;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQ;
  const int t = threadIdx.x, qg = t / 16, kg = t % 16;
  const int T = a.T, hd = a.hd;
  const long long D = static_cast<long long>(a.H) * hd;
  const float scale = a.scale;
  const float* img = a.qkv + static_cast<long long>(b) * T * 3 * D;
  const float* kb = img + D + h * hd;
  const float* vb = img + 2 * D + h * hd;
  const float* dob = a.dout + static_cast<long long>(b) * T * D + h * hd;
  const float* ob = a.out + static_cast<long long>(b) * T * D + h * hd;
  const long long head = static_cast<long long>(b) * a.H + h;

  // q and dO, zeros past T and hd (a group of their own, before the K/V
  // stream's).
  load_rows<HDP>(qs, img + h * hd, 3 * D, dos, dob, D, true, q0, T, hd, t);
  f32attn::cp_async_commit();
  // Each row's lse and dvec = rowsum(dO * O) (the thread's float4 columns,
  // then its query group's 16 lanes); 0 past T.
  float lse[4], dvec[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + qg + 16 * i;
    float part = 0.f;
    if (row < T) {
#pragma unroll
      for (int c = 0; c < G::kCols; ++c) {
        const int chunk = kg + 16 * c;
        if (chunk < G::kChunks && 4 * chunk < hd) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(dob + row * D + 4 * chunk));
          const float4 y = __ldg(reinterpret_cast<const float4*>(ob + row * D + 4 * chunk));
          part = fmaf(x.x, y.x, part);
          part = fmaf(x.y, y.y, part);
          part = fmaf(x.z, y.z, part);
          part = fmaf(x.w, y.w, part);
        }
      }
    }
    dvec[i] = f32attn::group_sum(part);
    lse[i] = row < T ? __ldg(a.lse + head * T + row) : 0.f;
  }

  const int nt = (T + kK - 1) / kK;
  auto fetch = [&](int s) {
    const int buf = s & 1;
    load_rows<HDP>(ks0 + buf * G::kTile, kb, 3 * D, vs0 + buf * G::kTile, vb, 3 * D, true,
                   s * kK, T, hd, t);
    f32attn::cp_async_commit();
  };
  float dq[4][4 * G::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * G::kCols; ++e) dq[i][e] = 0.f;
  fetch(0);
  for (int s = 0; s < nt; ++s) {
    begin_step(fetch, s, nt);
    const int buf = s & 1, j0 = s * kK;
    float sc[4][4], dp[4][4];
    products<HDP>(qs, ks0 + buf * G::kTile, qg, kg, 0.f, sc);
    products<HDP>(dos, vs0 + buf * G::kTile, qg, kg, 0.f, dp);
    // ds into shared memory, then dq += ds . K.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = j0 + kg + 16 * j < T
                            ? expf(__fsub_rn(__fmul_rn(sc[i][j], scale), lse[i]))
                            : 0.f;
        ps[(qg + 16 * i) * kPPitch + kg + 16 * j] =
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dvec[i])), scale);
      }
    __syncthreads();
    accumulate<HDP>(ps, ks0 + buf * G::kTile, qg, kg, min(kK, T - j0), dq);
    __syncthreads();  // the buffers are refilled two steps on, p one step on
  }

  store_rows<HDP>(a, b, q0, qg, kg, static_cast<long long>(h) * hd, dq);
  if (kg == 0) {
    const int rows = nt * kK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + qg + 16 * i;
      reinterpret_cast<float2*>(a.stats)[head * rows + row] =
          row < T ? make_float2(lse[i], dvec[i]) : make_float2(0.f, 0.f);
    }
  }
}

// dK/dV with the statistics given: per (image, head, 64 keys), K and V
// resident; q and dO tiles and their rows' (lse, dvec) streamed once.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ Args a) {
  using G = Geom<HDP>;
  extern __shared__ __align__(16) float bwd_smem[];
  float* const ks = bwd_smem;
  float* const vs = ks + G::kTile;
  float* const qt0 = vs + G::kTile;
  float* const dt0 = qt0 + 2 * G::kTile;
  float* const ps = dt0 + 2 * G::kTile;
  float* const st0 = ps + 64 * kPPitch;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kK;
  const int t = threadIdx.x, kg = t / 16, qg = t % 16;
  const int T = a.T, hd = a.hd;
  const long long D = static_cast<long long>(a.H) * hd;
  const float scale = a.scale;
  const float* img = a.qkv + static_cast<long long>(b) * T * 3 * D;
  const float* qb = img + h * hd;
  const float* dob = a.dout + static_cast<long long>(b) * T * D + h * hd;
  const int nt = (T + kQ - 1) / kQ;
  const float* stats =
      a.stats + (static_cast<long long>(b) * a.H + h) * static_cast<long long>(nt * kQ) * 2;

  load_rows<HDP>(ks, img + D + h * hd, 3 * D, vs, img + 2 * D + h * hd, 3 * D, true, k0, T,
                 hd, t);
  f32attn::cp_async_commit();
  auto fetch = [&](int s) {
    const int buf = s & 1;
    load_rows<HDP>(qt0 + buf * G::kTile, qb, 3 * D, dt0 + buf * G::kTile, dob, D, true,
                   s * kQ, T, hd, t);
    // 64 rows' (lse, dvec): 32 copies of 16 bytes.
    if (t < kQ / 2)
      f32attn::cp_async16(st0 + buf * 2 * kQ + 4 * t, stats + 2 * s * kQ + 4 * t, true);
    f32attn::cp_async_commit();
  };

  float dk[4][4 * G::kCols], dv[4][4 * G::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * G::kCols; ++e) {
      dk[i][e] = 0.f;
      dv[i][e] = 0.f;
    }
  fetch(0);
  for (int s = 0; s < nt; ++s) {
    begin_step(fetch, s, nt);
    const int buf = s & 1;
    const float* qt = qt0 + buf * G::kTile;
    const float* dt = dt0 + buf * G::kTile;
    const float2* st = reinterpret_cast<const float2*>(st0 + buf * 2 * kQ);
    float sc[4][4], dp[4][4], ds[4][4];
    // S^T = K . q^T (the dq kernel's sums, element for element) and dP^T =
    // V . dO^T.
    products<HDP>(ks, qt, kg, qg, 0.f, sc);
    products<HDP>(vs, dt, kg, qg, 0.f, dp);
    // p^T and ds^T; keys past T (their rows are not written) and queries
    // past T at 0.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 r = st[qg + 16 * j];
      const bool query = s * kQ + qg + 16 * j < T;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = query && k0 + kg + 16 * i < T;
        const float p = live ? expf(__fsub_rn(__fmul_rn(sc[i][j], scale), r.x)) : 0.f;
        ds[i][j] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], r.y)), scale);
        ps[(kg + 16 * i) * kPPitch + qg + 16 * j] = p;
      }
    }
    __syncthreads();
    const int nq = min(kQ, T - s * kQ);
    accumulate<HDP>(ps, dt, kg, qg, nq, dv);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(kg + 16 * i) * kPPitch + qg + 16 * j] = ds[i][j];
    __syncthreads();
    accumulate<HDP>(ps, qt, kg, qg, nq, dk);
    __syncthreads();  // the buffers are refilled two steps on, p one step on
  }
  store_rows<HDP>(a, b, k0, kg, qg, D + static_cast<long long>(h) * hd, dk);
  store_rows<HDP>(a, b, k0, kg, qg, 2 * D + static_cast<long long>(h) * hd, dv);
}

template <int HDP>
cudaError_t launch_given(const Args& a, int B, cudaStream_t stream) {
  if (B > 65535 || a.H > 65535) return cudaErrorInvalidValue;
  const dim3 grid((a.T + kQ - 1) / kQ, a.H, B);
  const size_t dq_smem = Smem<HDP>::kDq * sizeof(float);
  const size_t dkv_smem = Smem<HDP>::kDkvGiven * sizeof(float);
  cudaError_t err = allow_dynamic_smem(flash_bwd_dq_f32_kernel<HDP>, dq_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<HDP><<<grid, kThreads, dq_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_dynamic_smem(flash_bwd_dkv_f32_kernel<HDP>, dkv_smem)) != cudaSuccess)
    return err;
  flash_bwd_dkv_f32_kernel<HDP><<<grid, kThreads, dkv_smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HDP>
int given_geometry(int what) {
  switch (what) {
    case 0: return static_cast<int>(Smem<HDP>::kDq * sizeof(float));
    case 1: return static_cast<int>(Smem<HDP>::kDkvGiven * sizeof(float));
    default: return -1;
  }
}

template <int HDP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  if (B > 65535 || a.H > 65535) return cudaErrorInvalidValue;
  const dim3 grid((a.T + kQ - 1) / kQ, a.H, B);
  const size_t dq_smem = Smem<HDP>::kDq * sizeof(float);
  const size_t dkv_smem = Smem<HDP>::kDkv * sizeof(float);
  cudaError_t err = allow_dynamic_smem(attention_bwd_dq_f32_kernel<HDP>, dq_smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_f32_kernel<HDP><<<grid, kThreads, dq_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_dynamic_smem(attention_bwd_dkv_f32_kernel<HDP>, dkv_smem)) != cudaSuccess)
    return err;
  attention_bwd_dkv_f32_kernel<HDP><<<grid, kThreads, dkv_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace f32bwd
}  // namespace vit

// qkv [B, T, 3D] and dout [B, T, D] fp32 (slab packing) -> dqkv [B, T, 3D]
// in `dqkv_dtype` (0 fp32, 1 bf16); `stats` [B, num_heads, rows, 4] fp32
// scratch, rows = T rounded up to a multiple of 64. `scale` is
// float32(1/sqrt(head_dim)); head_dim a multiple of 8 up to 128. Two
// kernels.
VIT_EXPORT int vit_packed_attention_bwd_f32(const float* qkv, const float* dout, void* dqkv,
                                            int dqkv_dtype, float* stats, int B, int T,
                                            int num_heads, int head_dim, float scale,
                                            void* stream) {
  using namespace vit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128 ||
      (dqkv_dtype != kF32 && dqkv_dtype != kBF16))
    return cudaErrorInvalidValue;
  const f32bwd::Args a{qkv, dout, dqkv, dqkv_dtype == kBF16, stats, T, num_heads, head_dim,
                       scale};
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return f32bwd::launch<16>(a, B, s);
    case 32: return f32bwd::launch<32>(a, B, s);
    case 48: return f32bwd::launch<48>(a, B, s);
    case 64: return f32bwd::launch<64>(a, B, s);
    case 80: return f32bwd::launch<80>(a, B, s);
    case 96: return f32bwd::launch<96>(a, B, s);
    case 112: return f32bwd::launch<112>(a, B, s);
    case 128: return f32bwd::launch<128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The blockwise backward in fp32: qkv [B, T, 3D], the forward's out
// [B, T, D] and lse [B, num_heads, T], dout [B, T, D], all fp32 (slab
// packing) -> dqkv [B, T, 3D] fp32; `stats` [B, num_heads, rows, 2] fp32
// scratch, rows = T rounded up to a multiple of 64. `scale` is
// float32(1/sqrt(head_dim)); head_dim a multiple of 8 up to 128. Two
// kernels.
VIT_EXPORT int vit_flash_attention_bwd_f32(const float* qkv, const float* out,
                                           const float* lse, const float* dout, float* dqkv,
                                           float* stats, int B, int T, int num_heads,
                                           int head_dim, float scale, void* stream) {
  using namespace vit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || num_heads <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return cudaErrorInvalidValue;
  const f32bwd::Args a{qkv, dout, dqkv, 0, stats, T, num_heads, head_dim, scale, out, lse};
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return f32bwd::launch_given<16>(a, B, s);
    case 32: return f32bwd::launch_given<32>(a, B, s);
    case 48: return f32bwd::launch_given<48>(a, B, s);
    case 64: return f32bwd::launch_given<64>(a, B, s);
    case 80: return f32bwd::launch_given<80>(a, B, s);
    case 96: return f32bwd::launch_given<96>(a, B, s);
    case 112: return f32bwd::launch_given<112>(a, B, s);
    case 128: return f32bwd::launch_given<128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// The shared memory (bytes) of a block of the blockwise backward's fp32
// kernels at head_dim, for the host's copy (ops/attention.py) to be held
// against: `what` 0 the dq kernel's, 1 the dK/dV kernel's; -1 for anything
// else.
VIT_EXPORT int vit_flash_bwd_f32_geometry(int head_dim, int what) {
  if (head_dim <= 0 || head_dim % 8 != 0 || head_dim > 128) return -1;
  switch ((head_dim + 15) / 16 * 16) {
    case 16: return vit::f32bwd::given_geometry<16>(what);
    case 32: return vit::f32bwd::given_geometry<32>(what);
    case 48: return vit::f32bwd::given_geometry<48>(what);
    case 64: return vit::f32bwd::given_geometry<64>(what);
    case 80: return vit::f32bwd::given_geometry<80>(what);
    case 96: return vit::f32bwd::given_geometry<96>(what);
    case 112: return vit::f32bwd::given_geometry<112>(what);
    default: return vit::f32bwd::given_geometry<128>(what);
  }
}

// The fp32 GEMM: out[M, N] = epi(A . B) with fp32 operands, plain fp32 FMA
// on the CUDA cores (no TF32, no 3xTF32: the fp32 mode exists for parity,
// and the plain path runs with TF32 off).
//
// Replaces, in fp32, what gemm_sm90.cuh replaces in bf16:
//   * vit_with_opencl_tpu/ops/linear.py:_linear_kernel and the four matmuls
//     of ops/fused_block.py:_block_kernel and _stack_kernel (_mm) with fp32
//     x and w: the forward form, A = x [M, K] row-major, B = w [K, N]
//     row-major; also the MLP backward's fc1 recompute (two outputs);
//   * the backward's GEMM forms of ops/fused_block.py (_dot inside
//     _mlp_bwd_kernel and _attn_bwd_kernel) with fp32 operands: dgrad, dY
//     [M, N'] . W^T with W stored [K', N'] (B stored [N, K]), and wgrad,
//     X^T . dY over the B*T tokens (A stored [K, M]; the contraction is the
//     ragged token axis).
// The epilogue is epilogue.cuh's, in its order: + residual (fp32 or bf16),
// + bias, * _gelu_fast_grad(pre), _gelu_fast, the store in fp32 or bf16,
// and a second output (fp32 or bf16) of the value or of its _gelu_fast.
//
// Bound on the card: operations (2 M N K at 67 TFLOP/s fp32; ViT-B's
// encoder GEMMs do 2 x 3152 x 768 x 2304 = 11.2 GFLOP for qkv at B = 16,
// 0.167 ms; their bytes take a tenth of that at 3.35 TB/s).
// Design (the fp32 attention body's, attention_f32.cuh, on a GEMM): blocks
// of 256 threads take a 128 x 128 output tile; thread t owns an 8 x 8
// micro-tile, 64 accumulators in registers, and for every 4-deep step of K
// reads its 8 A values and 8 B values of each depth as float4s from shared
// memory: 256 FMAs for 16 16-byte loads. The operand tiles (128 x 16 fp32
// of A and of B) are copied by 16-byte cp.async in their global layout,
// double-buffered, so that the next 16-deep slice lands under this one's
// products, and zero-filled past M, N and K. A tile whose rows run along K
// ([x][k]: A row-major, B stored [N, K]) sits in rows of 16 + 4 floats, one
// along M or N ([k][x]: A stored [K, M], B row-major) in rows of 128 + 4.
// The thread's rows of A are 4 t_r .. 4 t_r + 3 and 64 + the same (t_r =
// t / 16: one address for a quarter-warp, a broadcast); its columns of B
// are 4 t_c .. 4 t_c + 3 and 64 + the same where B's rows run along N (a
// quarter-warp reads 128 contiguous bytes), and t_c + 16 j where they run
// along K (eight consecutive rows of 20 floats, on distinct bank groups: a
// stride of 4 rows would put two on each). Every output element sums over
// K in order, so two calls give the same bits. A weight gradient's split
// (ops/linear._wgrad_splits: tiles 0..full-1 whole, the rest over the
// tokens in `splits` runs of split_k) writes fp32 partial tiles that
// gemm_sm90.cu's fixed-order sum adds: no atomics.
#include <math.h>

#include "epilogue.cuh"

namespace vit {

// gemm_sm90.cu: the fixed-order sum of 128 x 128 partial tiles.
cudaError_t launch_wgrad_split_sum(const float* parts, float* out, int M, int N, int full,
                                   int splits, cudaStream_t s);

namespace f32gemm {

constexpr int kBM = 128, kBN = 128, kBK = 16;
static_assert(kBM == 128 && kBN == 128, "the split sum (gemm_sm90.cu) adds 128 x 128 tiles");
constexpr int kThreads = 256;
constexpr int kKPitch = kBK + 4;   // a [x][k] tile's row
constexpr int kXPitch = kBM + 4;   // a [k][x] tile's row
constexpr int kTileFloats = kBM * kKPitch > kBK * kXPitch ? kBM * kKPitch : kBK * kXPitch;
constexpr int kSmemBytes = 2 * 2 * kTileFloats * sizeof(float);  // A and B, two stages

struct Args {
  const float* a;
  const float* b;
  int M, N, K;
  int full, splits, split_k;  // splits 1: every tile whole over K
  float* parts;               // [splits][tiles - full][kBM][kBN]
  const float* bias;
  const void* residual;
  int residual_kind;
  void* out;
  int out_bf16;
  int gelu;
  const float* gelu_grad_of;
  void* out2;
  int out2_bf16;
  int out2_gelu;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));  // 0: fill with zeros
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One operand's 128 x 16 slice at depth k0 (rows x0.. of x_len, depth
// below k_end), in its global layout: kKInner, rows of ld floats along K
// ([x][k]); else rows of ld floats along x ([k][x]). 512 16-byte chunks,
// two a thread.
template <bool kKInner>
__device__ __forceinline__ void load_tile(float* tile, const float* g, int ld, int x0,
                                          int x_len, int k0, int k_end, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = t + r * kThreads;
    if (kKInner) {
      const int row = c / 4, kc = 4 * (c % 4);
      const bool ok = x0 + row < x_len && k0 + kc < k_end;
      cp_async16(tile + row * kKPitch + kc,
                 ok ? g + static_cast<size_t>(x0 + row) * ld + k0 + kc : g, ok);
    } else {
      const int row = c / 32, xc = 4 * (c % 32);
      const bool ok = k0 + row < k_end && x0 + xc < x_len;
      cp_async16(tile + row * kXPitch + xc,
                 ok ? g + static_cast<size_t>(k0 + row) * ld + x0 + xc : g, ok);
    }
  }
}

// The thread's 8 values of one operand at 4 depths k..k+3: v[i][kk].
// kKInner: rows idx(i), a float4 each; else 2 float4 a depth along x at
// columns base and base + 64.
template <bool kKInner, bool kVec>
__device__ __forceinline__ void fragment(const float* tile, int k, int tx, float (&v)[8][4]) {
  if (kKInner) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = kVec ? (i / 4) * 64 + 4 * tx + i % 4 : tx + 16 * i;
      const float4 q = *reinterpret_cast<const float4*>(tile + row * kKPitch + k);
      v[i][0] = q.x;
      v[i][1] = q.y;
      v[i][2] = q.z;
      v[i][3] = q.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 q =
            *reinterpret_cast<const float4*>(tile + (k + kk) * kXPitch + 64 * h + 4 * tx);
        v[4 * h][kk] = q.x;
        v[4 * h + 1][kk] = q.y;
        v[4 * h + 2][kk] = q.z;
        v[4 * h + 3][kk] = q.w;
      }
  }
}

__device__ __forceinline__ float load_any(const void* p, size_t off, bool bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[off]) : static_cast<const float*>(p)[off];
}
__device__ __forceinline__ void store_any(void* p, size_t off, bool bf, float v) {
  if (bf)
    static_cast<bf16*>(p)[off] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[off] = v;
}

// kATrans: A stored [K, M]; kBTrans: B stored [N, K]. A's rows always take
// the vector mapping; B's columns take it where B's rows run along N.
template <bool kATrans, bool kBTrans>
__global__ void __launch_bounds__(kThreads, 1) gemm_f32_kernel(const __grid_constant__ Args g) {
  constexpr bool kAKInner = !kATrans, kBKInner = kBTrans, kBVec = !kBTrans;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, tr = t / 16, tc = t % 16;
  const int tiles_n = (g.N + kBN - 1) / kBN;
  // The unit: tile u whole below full; past it tile full + (u - full) / S
  // over run (u - full) % S of the tokens.
  const int u = blockIdx.x;
  int tile = u, split = 0;
  if (u >= g.full) {
    tile = g.full + (u - g.full) / g.splits;
    split = (u - g.full) % g.splits;
  }
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
  const int k_begin = u >= g.full ? split * g.split_k : 0;
  const int k_end = u >= g.full ? min(g.K, k_begin + g.split_k) : g.K;
  const int lda = kATrans ? g.M : g.K, ldb = kBTrans ? g.K : g.N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = (k_end - k_begin + kBK - 1) / kBK;
  auto fetch = [&](int s) {
    float* at = smem + (s & 1) * 2 * kTileFloats;
    float* bt = at + kTileFloats;
    load_tile<kAKInner>(at, g.a, lda, m0, g.M, k_begin + s * kBK, k_end, t);
    load_tile<kBKInner>(bt, g.b, ldb, n0, g.N, k_begin + s * kBK, k_end, t);
    cp_async_commit();
  };
  if (steps > 0) fetch(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* at = smem + (s & 1) * 2 * kTileFloats;
    const float* bt = at + kTileFloats;
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float av[8][4], bv[8][4];
      fragment<kAKInner, true>(at, k, tr, av);
      fragment<kBKInner, kBVec>(bt, k, tc, bv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i][kk], bv[j][kk], acc[i][j]);
    }
    __syncthreads();  // the buffer is refilled by the next step's fetch
  }

  if (u >= g.full) {
    // A split unit: its fp32 partial tile, whole (the sum masks the edges).
    const int rest = (static_cast<int>(gridDim.x) - g.full) / g.splits;
    float* part = g.parts + (static_cast<size_t>(split) * rest + (tile - g.full)) * kBM * kBN;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = (i / 4) * 64 + 4 * tr + i % 4;
        const int c = kBVec ? (j / 4) * 64 + 4 * tc + j % 4 : tc + 16 * j;
        part[r * kBN + c] = acc[i][j];
      }
    return;
  }
  // The epilogue, in epilogue.cuh's order, element by element.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i / 4) * 64 + 4 * tr + i % 4;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (kBVec ? (j / 4) * 64 + 4 * tc + j % 4 : tc + 16 * j);
      if (gn >= g.N) continue;
      const size_t off = static_cast<size_t>(gm) * g.N + gn;
      float v = acc[i][j];
      if (g.residual_kind != kNoResidual)
        v = load_any(g.residual, off, g.residual_kind == kResidualBF16) + v;
      if (g.bias != nullptr) v = v + __ldg(g.bias + gn);
      if (g.gelu_grad_of != nullptr) v = v * gelu_fast_grad(__ldg(g.gelu_grad_of + off));
      if (g.gelu) v = gelu_fast(v);
      store_any(g.out, off, g.out_bf16, v);
      if (g.out2 != nullptr) store_any(g.out2, off, g.out2_bf16, g.out2_gelu ? gelu_fast(v) : v);
    }
  }
}

template <bool kATrans, bool kBTrans>
cudaError_t launch(const Args& g, int units, cudaStream_t stream) {
  auto kernel = gemm_f32_kernel<kATrans, kBTrans>;
  const cudaError_t err = allow_dynamic_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<units, kThreads, kSmemBytes, stream>>>(g);
  return cudaGetLastError();
}

inline cudaError_t run(Args g, int a_trans, int b_trans, cudaStream_t s) {
  const int tiles = ((g.M + kBM - 1) / kBM) * ((g.N + kBN - 1) / kBN);
  if (g.splits > 1) {
    const long long runs = (static_cast<long long>(g.K) + g.split_k - 1) / g.split_k;
    if (g.full < 0 || g.full >= tiles || g.split_k <= 0 || g.split_k % kBK != 0 ||
        runs != g.splits || g.parts == nullptr)
      return cudaErrorInvalidValue;
  } else {
    g.full = tiles;
    g.splits = 1;
    g.split_k = g.K;
  }
  const long long units = g.full + static_cast<long long>(tiles - g.full) * g.splits;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err;
  if (!a_trans && !b_trans)
    err = launch<false, false>(g, static_cast<int>(units), s);
  else if (!a_trans)
    err = launch<false, true>(g, static_cast<int>(units), s);
  else if (!b_trans)
    err = launch<true, false>(g, static_cast<int>(units), s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_wgrad_split_sum(g.parts, static_cast<float*>(g.out), g.M, g.N, g.full,
                                g.splits, s);
}

}  // namespace f32gemm
}  // namespace vit

// out [M, N] = epilogue(x [M, K] @ w [K, N]), fp32 operands and sums; the
// epilogue of epilogue.cuh (residual fp32 or bf16, bias, GELU, fp32 or bf16
// out). K and N must be multiples of 8 (ops/linear.py checks that first).
VIT_EXPORT int vit_linear_f32(const float* x, const float* w, const float* bias,
                              const void* residual, int residual_kind, void* out,
                              int out_bf16, int gelu, int M, int N, int K, void* stream) {
  using namespace vit;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 || bad_epilogue(residual_kind))
    return cudaErrorInvalidValue;
  f32gemm::Args g{x, w, M, N, K, 0, 1, 0, nullptr, bias, residual, residual_kind, out,
                  out_bf16, gelu, nullptr, nullptr, 0, 0};
  return f32gemm::run(g, 0, 0, static_cast<cudaStream_t>(stream));
}

// out [M, N] = epilogue(A . B) in fp32: A is [M, K] row-major, or (a_trans)
// stored [K, M]; B is [K, N] row-major, or (b_trans) stored [N, K]. The
// dgrad form is (0, 1), the wgrad form (1, 0) with fp32 out, the fc1
// recompute (0, 0) with out2. out2 (or null) is fp32 or bf16 (out2_bf16).
// N and each operand's contiguous axis must be multiples of 8. splits > 1
// (wgrad only, no epilogue): the 128 x 128 tiles from `full` on run over K
// in runs of split_k (a multiple of 16; the last run ragged) into fp32
// partials in `workspace` [splits][tiles - full][128][128], then their
// fixed-order sum into out: two kernels.
VIT_EXPORT int vit_gemm_grad_f32(const float* a, int a_trans, const float* b, int b_trans,
                                 const float* bias, const float* gelu_grad_of, void* out,
                                 int out_bf16, void* out2, int out2_bf16, int out2_gelu,
                                 int M, int N, int K, int full, int splits, int split_k,
                                 float* workspace, void* stream) {
  using namespace vit;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || (a_trans ? M : K) % 8 != 0 ||
      (b_trans && K % 8 != 0) || (a_trans && b_trans) || splits < 1)
    return cudaErrorInvalidValue;
  if (splits > 1 && (!a_trans || bias != nullptr || gelu_grad_of != nullptr ||
                     out2 != nullptr || out_bf16))
    return cudaErrorInvalidValue;
  f32gemm::Args g{a,   b,        M,           N,    K,        full,         splits,
                  split_k, workspace, bias, nullptr, kNoResidual, out, out_bf16,
                  0,   gelu_grad_of, out2, out2_bf16, out2_gelu};
  return f32gemm::run(g, a_trans, b_trans, static_cast<cudaStream_t>(stream));
}

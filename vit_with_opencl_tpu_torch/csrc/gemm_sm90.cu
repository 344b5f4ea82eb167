// The entry points of the GEMM core (gemm_sm90.cuh): the forward GEMM
// (ops/linear.py fused_linear with a bf16 w, and with an int8 w and its
// scale), the W8A8 GEMM (fused_linear_w8a8, with and without the bf16 side
// product) and the backward's forms (linear_dgrad, linear_wgrad,
// fused_linear_with_gelu), and the fixed-order sum of the weight gradients'
// split-K partials.
#include "gemm_sm90.cuh"

namespace vit {

// The split tiles of a weight gradient: tile full + i of out [M, N] (tiles
// in row-major order, tiles_n to a row) is ((p[0][i] + p[1][i]) + p[2][i])
// + ..., its partials' slots [splits][rest][kBM][kBN] in index order, so a
// weight gradient has the same bits from run to run. Bound: bytes (splits
// reads and one write of the split tiles in fp32).
__global__ void wgrad_split_sum_kernel(const float4* __restrict__ parts,
                                       float* __restrict__ out, int M, int N,
                                       int tiles_n, int full, int rest, int splits) {
  constexpr int kTile4 = sm90::kBM * sm90::kBN / 4;
  const long long n4 = static_cast<long long>(rest) * kTile4;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int tile = full + static_cast<int>(i / kTile4);
    const int e = static_cast<int>(i % kTile4);
    const int gm = (tile / tiles_n) * sm90::kBM + e / (sm90::kBN / 4);
    const int gn = (tile % tiles_n) * sm90::kBN + (e % (sm90::kBN / 4)) * 4;
    if (gm >= M || gn >= N) continue;  // N % 8 == 0: 4 columns all in or out
    float4 s = parts[i];
    for (int p = 1; p < splits; ++p) {
      const float4 v = parts[p * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(gm) * N + gn) = s;
  }
}

// The fixed-order sum of a split weight gradient's partials into out [M,
// N], for every GEMM whose split tiles are kBM x kBN (this core's and the
// fp32 GEMM's, gemm_f32.cu).
cudaError_t launch_wgrad_split_sum(const float* parts, float* out, int M, int N, int full,
                                   int splits, cudaStream_t s) {
  if (splits < 2) return cudaErrorInvalidValue;
  const int tiles_n = (N + sm90::kBN - 1) / sm90::kBN;
  const int rest = ((M + sm90::kBM - 1) / sm90::kBM) * tiles_n - full;
  const long long n4 = static_cast<long long>(rest) * sm90::kBM * sm90::kBN / 4;
  const long long blocks = (n4 + 255) / 256;
  wgrad_split_sum_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      reinterpret_cast<const float4*>(parts), out, M, N, tiles_n, full, rest, splits);
  return cudaGetLastError();
}

}  // namespace vit

// out [M, N] = epilogue(x [M, K] @ w [K, N]) in bf16 with fp32 accumulation;
// the epilogue of epilogue.cuh (residual, bias, GELU, bf16 or fp32 out). K
// and N must be multiples of 8 (ops/linear.py checks that before calling).
VIT_EXPORT int vit_linear_bf16(const void* x, const void* w, const float* bias,
                               const void* residual, int residual_kind, void* out,
                               int out_bf16, int gelu, int M, int N, int K,
                               void* stream) {
  using namespace vit;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 ||
      bad_epilogue(residual_kind))
    return cudaErrorInvalidValue;
  Epilogue ep{bias, residual, residual_kind, out, out_bf16, gelu};
  return sm90::launch_gemm<false, true>(x, w, M, N, K, 0, 1, 0, nullptr, ep,
                                        static_cast<cudaStream_t>(stream));
}

// out [M, N] = epilogue((x [M, K] @ bf16(w [K, N] int8)) * w_scale [N]), the
// product in fp32 on the same core, w widened to bf16 in shared memory
// (exact). K must be a multiple of 8 and N of 16 (16-byte TMA row pitches of
// x and of the int8 w; ops/linear.py checks them before calling).
VIT_EXPORT int vit_linear_int8w(const void* x, const void* w, const float* w_scale,
                                const float* bias, const void* residual, int residual_kind,
                                void* out, int out_bf16, int gelu, int M, int N, int K,
                                void* stream) {
  using namespace vit;
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 8 != 0 || w_scale == nullptr ||
      bad_epilogue(residual_kind))
    return cudaErrorInvalidValue;
  Epilogue ep{bias, residual, residual_kind, out, out_bf16, gelu};
  return sm90::launch_gemm<false, true, true>(x, w, M, N, K, 0, 1, 0, nullptr, ep,
                                              static_cast<cudaStream_t>(stream), w_scale);
}

// out [M, N] = epilogue(((float)(xq [M, K] @ w [K, N]) * x_scale[m]) *
// w_scale[n] [+ x_hi [M, K_hi] @ w_hi [K_hi, N]]): int8 operands with int32
// sums, w stored K-major (N rows of K bytes, ldw bytes apart: int8 wgmma
// reads no other layout), the side product in bf16 with fp32 sums; x_hi and
// w_hi null (K_hi 0): none. K, ldw and N must be multiples of 16 and K_hi of
// 8 (ops/linear.py checks them before calling).
VIT_EXPORT int vit_linear_w8a8(const void* xq, const float* x_scale, const void* w, int ldw,
                               const float* w_scale, const void* x_hi, const void* w_hi,
                               int K_hi, const float* bias, const void* residual,
                               int residual_kind, void* out, int out_bf16, int gelu, int M,
                               int N, int K, void* stream) {
  using namespace vit;
  const bool side = x_hi != nullptr;
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0 || ldw < K ||
      ldw % 16 != 0 || x_scale == nullptr || w_scale == nullptr ||
      bad_epilogue(residual_kind) || side != (w_hi != nullptr) ||
      (side && (K_hi <= 0 || K_hi % 8 != 0)))
    return cudaErrorInvalidValue;
  const Epilogue ep{bias, residual, residual_kind, out, out_bf16, gelu};
  return sm90::launch_w8a8(xq, x_scale, w, ldw, w_scale, x_hi, w_hi, side ? K_hi : 0, M, N, K,
                           ep, static_cast<cudaStream_t>(stream));
}

// out [M, N] = epilogue(A . B) in bf16: A is [M, K] row-major, or (a_trans)
// stored [K, M]; B is [K, N] row-major, or (b_trans) stored [N, K]. The
// dgrad form is (0, 1), the wgrad form (1, 0) with fp32 out, the fc1
// recompute (0, 0) with out2. N and each operand's contiguous axis must be
// multiples of 8. splits > 1 (wgrad only): the 128 x 128 tiles from `full`
// on run over K in runs of split_k (a multiple of 64; the last run ragged)
// into fp32 partials in `workspace` [splits][tiles - full][128][128], then
// their sum into out: two kernels.
VIT_EXPORT int vit_gemm_grad(const void* a, int a_trans, const void* b, int b_trans,
                             const float* bias, const float* gelu_grad_of, void* out,
                             int out_bf16, void* out2, int out2_gelu, int M, int N,
                             int K, int full, int splits, int split_k, void* workspace,
                             void* stream) {
  using namespace vit;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || (a_trans ? M : K) % 8 != 0 ||
      (b_trans && K % 8 != 0) || (a_trans && b_trans) || splits < 1)
    return cudaErrorInvalidValue;
  const Epilogue ep{bias,     nullptr,      kNoResidual,
                    out,      out_bf16,     0,
                    gelu_grad_of, static_cast<bf16*>(out2), out2_gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a_trans && b_trans)
    return splits == 1 ? sm90::launch_gemm<false, false>(a, b, M, N, K, 0, 1, 0, nullptr,
                                                         ep, s)
                       : cudaErrorInvalidValue;
  if (!a_trans)
    return splits == 1 ? sm90::launch_gemm<false, true>(a, b, M, N, K, 0, 1, 0, nullptr,
                                                        ep, s)
                       : cudaErrorInvalidValue;
  if (splits == 1)
    return sm90::launch_gemm<true, true>(a, b, M, N, K, 0, 1, 0, nullptr, ep, s);
  // The wgrad's split-K: fp32 out only, no epilogue (ops/linear.py).
  if (bias != nullptr || gelu_grad_of != nullptr || out2 != nullptr || out_bf16 ||
      workspace == nullptr || split_k <= 0 || split_k % sm90::kBK != 0)
    return cudaErrorInvalidValue;
  float* parts = static_cast<float*>(workspace);
  cudaError_t err = sm90::launch_gemm<true, true>(a, b, M, N, K, full, splits,
                                                  split_k / sm90::kBK, parts, ep, s);
  if (err != cudaSuccess) return err;
  return launch_wgrad_split_sum(parts, static_cast<float*>(out), M, N, full, splits, s);
}

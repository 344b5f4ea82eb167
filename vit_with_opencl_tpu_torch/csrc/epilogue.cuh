// The GEMMs' fp32 epilogue, one copy for every form of the Hopper core
// (gemm_sm90.cuh: the bf16 forward, dgrad, wgrad and fc1-pair forms, the
// weight-only int8 form and the W8A8 forms).
//
// After the product (already scaled for the int8 forms) the epilogue runs
// in fp32 in this order, each step optional:
//   + residual (fp32 or bf16 [M, N]), + bias (fp32 [N]),
//   * _gelu_fast_grad(pre) (fp32 [M, N]: fc2's dgrad through fc1's GELU),
//   _gelu_fast, then the store in bf16 or fp32,
//   and a second bf16 output of the value or of its _gelu_fast.
// That is the encoder layer's order (the residual first, then the bias),
// and the backward's (the bias, then the GELU gradient). No caller sets both
// a forward field (residual, gelu) and a backward one (gelu_grad_of, out2).
#pragma once

#include "common.cuh"

namespace vit {

// Residual kinds (ops/linear.py passes the same codes).
enum Residual : int { kNoResidual = 0, kResidualF32 = 1, kResidualBF16 = 2 };

struct Epilogue {
  const float* bias;           // [N] or null
  const void* residual;        // [M, N] or null
  int residual_kind;
  void* out;                   // [M, N]
  int out_bf16;
  int gelu;                    // _gelu_fast before the store
  const float* gelu_grad_of;   // [M, N] fp32 pre-activation or null
  bf16* out2;                  // [M, N] bf16 or null
  int out2_gelu;               // out2 = bf16(_gelu_fast(v)) instead of bf16(v)
};

inline bool bad_epilogue(int residual_kind) {
  return residual_kind < kNoResidual || residual_kind > kResidualBF16;
}

// vit_with_opencl_tpu_torch/ops/fused_block.py:_GELU_P, highest power first
// in the Horner loop (tests/test_torch_ops.py checks the two agree).
__device__ __forceinline__ float gelu_fast(float x) {
  const float u = x * x;
  float p = 1.1191059256776888e-06f;
  p = p * u + -3.0581402420578764e-05f;
  p = p * u + -0.00012485972711897262f;
  p = p * u + 0.03646878821593782f;
  p = p * u + 0.79782813653302f;
  return 0.5f * x * (1.0f + tanhf(x * p));
}

// d/dx of gelu_fast (ops/fused_block.py:_gelu_fast_grad): with w = x P(x^2),
// g'(x) = 0.5 (1 + t) + 0.5 x (1 - t^2) (P(u) + 2 u P'(u)), t = tanh(w).
__device__ __forceinline__ float gelu_fast_grad(float x) {
  const float u = x * x;
  float p = 1.1191059256776888e-06f;
  p = p * u + -3.0581402420578764e-05f;
  p = p * u + -0.00012485972711897262f;
  p = p * u + 0.03646878821593782f;
  p = p * u + 0.79782813653302f;
  float dp = 4.0f * 1.1191059256776888e-06f;
  dp = dp * u + 3.0f * -3.0581402420578764e-05f;
  dp = dp * u + 2.0f * -0.00012485972711897262f;
  dp = dp * u + 1.0f * 0.03646878821593782f;
  const float t = tanhf(x * p);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * (p + 2.0f * u * dp);
}

// The epilogue of R rows gm[i] at the same V consecutive columns gn..gn+V-1,
// whose products are in v[i]; ok[i] false leaves a row out. The steps run
// over all R rows in turn (independent work for the GELU's tanh), each row
// in the order of the note at the top. x[i] holds what the rows read besides
// the product: the residual (as fp32) or the GELU's pre-activation (no
// caller has both); load_rows reads it, so that a caller can issue the
// reads of several rows before their arithmetic.
template <int R, int V>
__device__ __forceinline__ void load_rows(float (&x)[R][V], const int (&gm)[R],
                                          const bool (&ok)[R], int gn, int N,
                                          const Epilogue& ep) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!ok[i]) continue;
    const size_t off = static_cast<size_t>(gm[i]) * N + gn;
    if (ep.residual_kind == kResidualF32)
      load_f32<V>(x[i], static_cast<const float*>(ep.residual) + off);
    else if (ep.residual_kind == kResidualBF16)
      load_bf16<V>(x[i], static_cast<const bf16*>(ep.residual) + off);
    else if (ep.gelu_grad_of != nullptr)
      load_f32<V>(x[i], ep.gelu_grad_of + off);
  }
}

template <int V>
__device__ __forceinline__ void load_bias(float (&b)[V], int gn, const Epilogue& ep) {
  if (ep.bias != nullptr) load_f32<V>(b, ep.bias + gn);
}

template <int R, int V>
__device__ __forceinline__ void apply_rows(float (&v)[R][V], const float (&x)[R][V],
                                           const float (&b)[V], const int (&gm)[R],
                                           const bool (&ok)[R], int gn, int N,
                                           const Epilogue& ep) {
  if (ep.residual_kind != kNoResidual) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) v[i][e] = x[i][e] + v[i][e];
  }
  if (ep.bias != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) v[i][e] = v[i][e] + b[e];
  }
  if (ep.gelu_grad_of != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) v[i][e] = v[i][e] * gelu_fast_grad(x[i][e]);
  }
  if (ep.gelu) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) v[i][e] = gelu_fast(v[i][e]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (ok[i]) store_vec<V>(ep.out, static_cast<size_t>(gm[i]) * N + gn, ep.out_bf16, v[i]);
  if (ep.out2 != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float w[V];
#pragma unroll
      for (int e = 0; e < V; ++e) w[e] = ep.out2_gelu ? gelu_fast(v[i][e]) : v[i][e];
      if (ok[i]) store_vec<V>(ep.out2, static_cast<size_t>(gm[i]) * N + gn, 1, w);
    }
  }
}

}  // namespace vit

"""One pre-LN encoder layer as a chain of the port's CUDA kernels.

Replaces ``vit_with_opencl_tpu/ops/fused_block.py:_block_kernel`` in bf16
(``fused_encoder_layer``). The TPU kernel keeps a whole layer's weights
(14.2 MB for ViT-B in bf16) resident in on-chip memory and never writes an
activation back between stages. A Hopper SM has 227 KB of shared memory, so
here the layer is seven launches of three kernels, with the activations
passing through device memory between them:

  LN1 (layernorm.cu) → qkv GEMM + bias (linear.cu) → packed attention
  (attention.cu) → out-proj GEMM + fp32 residual + bias → LN2 (fp32 in)
  → fc1 GEMM + bias + ``_gelu_fast`` → fc2 GEMM + fp32 residual + bias.

The numerics are the TPU kernel's: fp32 LN statistics, fp32 accumulation,
the residual stream kept in fp32 inside the layer (the fp32 ``x1`` crosses
two launches; rounding it to bf16 would change the result), residual added
before the bias, the tanh-polynomial ``_gelu_fast`` (not erf), and the
activation dtype at the layer's output.

``fused_encoder_layer`` launches the kernels for CUDA tensors; for CPU
tensors every link computes its plain version, which is
``fused_encoder_layer_reference`` on any device.
"""

from __future__ import annotations

import torch

from ..config import ViTConfig
from . import attention, layernorm, linear

# Chain runs on the card since the count was last set to 0: one per layer
# whose seven kernel launches went out (chip_smoke.py reads it).
LAUNCHES = 0

# Minimax-fitted odd polynomial inside tanh: GELU(x) = 0.5x(1+tanh(x P(x^2))),
# |err| <= 3.4e-6 against erf-GELU on all of R. The same five coefficients
# are written out in csrc/linear.cu (gelu_fast).
_GELU_P = (0.79782813653302, 0.03646878821593782, -0.00012485972711897262,
           -3.0581402420578764e-05, 1.1191059256776888e-06)

# Per-layer weight bytes above which the JAX package leaves the fused layer
# for the per-op path (its on-chip weight budget). The chain here has no such
# limit; ``supports`` keeps the bound so that both packages route each
# config the same way and their forwards stay comparable.
FUSED_BLOCK_MAX_WEIGHT_BYTES = 40 << 20


def _gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """erf-GELU to 3.4e-6 through one tanh (fp32 in, fp32 out)."""
    u = x * x
    p = _GELU_P[4]
    for c in _GELU_P[3::-1]:
        p = p * u + c
    return 0.5 * x * (1.0 + torch.tanh(x * p))


def supports(config: ViTConfig, dtype_bytes: int = 2) -> bool:
    """Whether the ``flash`` route sends this config's layers to the chain:
    erf-GELU configs whose per-layer weights are within the JAX package's
    fused-layer bound (tanh-GELU configs take the per-op path)."""
    if config.gelu_approx != "erf":
        return False
    d, h = config.embed_dim, config.hidden_dim
    weight_bytes = (d * 3 * d + d * d + d * h + h * d) * dtype_bytes
    return weight_bytes <= FUSED_BLOCK_MAX_WEIGHT_BYTES


def _chain(x, lp, config: ViTConfig, ln, mm, attn) -> torch.Tensor:
    cdt = x.dtype
    eps = config.eps

    def w(key):
        return lp[key].to(cdt)

    h = ln(x, lp["ln1_w"], lp["ln1_b"], eps, out_dtype=cdt)
    qkv = mm(h, w("qkv_w"), lp["qkv_b"], out_dtype=cdt)
    ctx = attn(qkv, num_heads=config.num_heads, head_dim=config.head_dim)
    x1 = mm(ctx, w("out_w"), lp["out_b"], residual=x, out_dtype=torch.float32)
    h2 = ln(x1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=cdt)
    hid = mm(h2, w("fc1_w"), lp["fc1_b"], fuse_gelu=True, out_dtype=cdt)
    return mm(hid, w("fc2_w"), lp["fc2_b"], residual=x1, out_dtype=cdt)


def fused_encoder_layer(x: torch.Tensor, lp, config: ViTConfig) -> torch.Tensor:
    """One pre-LN encoder layer. x: [B, T, D] → [B, T, D] in x's dtype.

    ``lp`` is one layer's slice of the stacked params (models/vit layout:
    qkv_w [D, 3D], out_w [D, D], fc1_w [D, H], fc2_w [H, D] in the param
    dtype, fp32 LN parameters and biases)."""
    global LAUNCHES
    out = _chain(x, lp, config, layernorm.layer_norm, linear.fused_linear,
                 attention.packed_fused_attention)
    if x.is_cuda:
        LAUNCHES += 1
    return out


def fused_encoder_layer_reference(x: torch.Tensor, lp,
                                  config: ViTConfig) -> torch.Tensor:
    """The chain computed by each link's plain version, on any device."""
    return _chain(x, lp, config, layernorm.layer_norm_reference,
                  linear.fused_linear_reference,
                  attention.packed_fused_attention_reference)

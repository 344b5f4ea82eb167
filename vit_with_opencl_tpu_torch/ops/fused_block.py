"""One pre-LN encoder layer as a chain of the port's CUDA kernels.

Replaces ``vit_with_opencl_tpu/ops/fused_block.py:_block_kernel``
(``fused_encoder_layer``) in its four forms. The TPU kernel keeps a whole
layer's weights (14.2 MB for ViT-B in bf16, 7.1 MB in int8) resident in
on-chip memory and never writes an activation back between stages. A Hopper
SM has 227 KB of shared memory, so here the layer is a chain of launches,
with the activations passing through device memory between them:

  bf16 and weight-only int8 (``quantized=True``), 7 launches:
    LN1 (layernorm.cu) → qkv GEMM + bias (linear.cu) → packed attention
    (attention.cu) → out-proj GEMM + fp32 residual + bias → LN2 (fp32 in)
    → fc1 GEMM + bias + ``_gelu_fast`` → fc2 GEMM + fp32 residual + bias;
    with int8 weights each GEMM is the int8-weight one, whose fp32 product
    is multiplied by the per-channel scale before the epilogue.
  W8A8 (``quantized=True, w8a8=True``), 11 launches:
    LN1 (fp32 out) → quantize (quantize.cu) → int8 qkv GEMM + bias → packed
    attention → quantize → int8 out-proj + fp32 residual + bias → LN2 (fp32
    out) → quantize → int8 fc1 + bias + ``_gelu_fast`` (fp32 out) → quantize
    → int8 fc2 + fp32 residual + bias.
  calibrated outlier-aware W8A8 (``w8a8=True`` with the ``"hi"`` weight
  dicts of ``models/quant.calibrate_w8a8``), 11 launches: the W8A8 chain
  with the outlier forms of its quantizes and GEMMs (``_mm`` with
  ``hi_ref`` and ``_mm_ctx_masked``). Before qkv, fc1 and fc2 the split
  quantize (quantize.cu) quantizes the leading columns of the fp32 LN output
  or GELU'd hidden and rounds the trailing outlier group to the activation
  dtype; before out-proj the masked quantize leaves each head's tail
  columns of the context out of the absmax, clips them, and copies them
  out. Each GEMM then adds its bf16 side product over the outlier group
  (linear.cu), after the scales and before the residual and the bias.

The numerics are the TPU kernel's: fp32 LN statistics, fp32 accumulation
(exact int32 for W8A8), the residual stream kept in fp32 inside the layer
(the fp32 ``x1`` crosses launches; rounding it to bf16 would change the
result), residual added before the bias, the tanh-polynomial ``_gelu_fast``
(not erf), and the activation dtype at the layer's output. W8A8 quantizes
the fp32 LN outputs and the fp32 GELU'd hidden directly, with no bf16
rounding first (a rounding there would move int8 decisions); the qkv
product is rounded to the activation dtype after its bias, and the
attention context is quantized from the activation dtype.

``fused_encoder_layer`` launches the kernels for CUDA tensors; for CPU
tensors every link computes its plain version, which is
``fused_encoder_layer_reference`` on any device.
"""

from __future__ import annotations

import torch

from ..config import ViTConfig
from ..models.quant import is_quantized, refuse_outliers
from . import attention, layernorm, linear, quantize

# Chain runs on the card since the counts were last set to 0: one per layer
# whose launches all went out (chip_smoke.py reads them), for the bf16,
# weight-only int8, W8A8 and outlier-aware W8A8 chains.
LAUNCHES = 0
LAUNCHES_INT8W = 0
LAUNCHES_W8A8 = 0
LAUNCHES_W8A8_OUTLIER = 0

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
# Whole-stack weight bytes up to which the JAX package runs every layer in
# one kernel (``_stack_kernel``, not ported). Kept for ``supports_stack``,
# which decides what ``engine.resolve_quantize("auto")`` picks.
FUSED_STACK_MAX_WEIGHT_BYTES = 44 << 20


def _gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """erf-GELU to 3.4e-6 through one tanh (fp32 in, fp32 out)."""
    u = x * x
    p = _GELU_P[4]
    for c in _GELU_P[3::-1]:
        p = p * u + c
    return 0.5 * x * (1.0 + torch.tanh(x * p))


def _layer_weight_bytes(config: ViTConfig, dtype_bytes: int) -> int:
    d, h = config.embed_dim, config.hidden_dim
    return (d * 3 * d + d * d + d * h + h * d) * dtype_bytes


def supports(config: ViTConfig, dtype_bytes: int = 2) -> bool:
    """Whether the ``flash`` route sends this config's layers to the chain:
    erf-GELU configs whose per-layer weights are within the JAX package's
    fused-layer bound (tanh-GELU configs take the per-op path)."""
    if config.gelu_approx != "erf":
        return False
    return _layer_weight_bytes(config, dtype_bytes) <= FUSED_BLOCK_MAX_WEIGHT_BYTES


def supports_stack(config: ViTConfig, dtype_bytes: int = 2) -> bool:
    """Whether the JAX package runs this config's whole encoder in one
    kernel: its full weight stack within the on-chip budget."""
    if config.gelu_approx != "erf":
        return False
    return (config.depth * _layer_weight_bytes(config, dtype_bytes)
            <= FUSED_STACK_MAX_WEIGHT_BYTES)


def _chain(x, lp, config: ViTConfig, ln, mm, attn) -> torch.Tensor:
    """bf16 or weight-only int8: the 7-link chain."""
    cdt = x.dtype
    eps = config.eps

    def mm_w(h, key, bkey, **kw):
        w = lp[key]
        if is_quantized(w):
            return mm(h, w["q"], lp[bkey], w_scale=w["scale"], **kw)
        return mm(h, w.to(cdt), lp[bkey], **kw)

    h = ln(x, lp["ln1_w"], lp["ln1_b"], eps, out_dtype=cdt)
    qkv = mm_w(h, "qkv_w", "qkv_b", out_dtype=cdt)
    ctx = attn(qkv, num_heads=config.num_heads, head_dim=config.head_dim)
    x1 = mm_w(ctx, "out_w", "out_b", residual=x, out_dtype=torch.float32)
    h2 = ln(x1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=cdt)
    hid = mm_w(h2, "fc1_w", "fc1_b", fuse_gelu=True, out_dtype=cdt)
    return mm_w(hid, "fc2_w", "fc2_b", residual=x1, out_dtype=cdt)


def _chain_w8a8(x, lp, config: ViTConfig, ln, quant, split, masked, mm8,
                attn) -> torch.Tensor:
    """W8A8, plain or outlier-aware: the 11-link chain."""
    cdt, f32 = x.dtype, torch.float32
    eps, nh, hd = config.eps, config.num_heads, config.head_dim

    def mm_q(h, key, bkey, **kw):
        w = lp[key]
        if "hi" not in w:
            hq, hs = quant(h)
            return mm8(hq, hs, w["q"], w["scale"], lp[bkey], **kw)
        if key == "out_w":  # the context's per-head tails
            hq, hs, h_hi = masked(h, nh, hd, w["hi"].shape[0] // nh)
        else:  # a trailing group, rounded to the activation dtype
            hq, hs, h_hi = split(h, w["q"].shape[0], cdt)
        return mm8(hq, hs, w["q"], w["scale"], lp[bkey], x_hi=h_hi,
                   w_hi=w["hi"].to(cdt), **kw)

    h = ln(x, lp["ln1_w"], lp["ln1_b"], eps, out_dtype=f32)
    qkv = mm_q(h, "qkv_w", "qkv_b", out_dtype=cdt)
    ctx = attn(qkv, num_heads=config.num_heads, head_dim=config.head_dim)
    x1 = mm_q(ctx, "out_w", "out_b", residual=x, out_dtype=f32)
    h2 = ln(x1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=f32)
    hid = mm_q(h2, "fc1_w", "fc1_b", fuse_gelu=True, out_dtype=f32)
    return mm_q(hid, "fc2_w", "fc2_b", residual=x1, out_dtype=cdt)


def _form(lp, w8a8: bool) -> str:
    """Which chain a layer's weights take: "bf16", "int8w", "w8a8" or
    "outlier". ``w8a8`` needs int8 weights and is ignored without them, as
    in the JAX package; outlier-aware weights need it."""
    if not is_quantized(lp["qkv_w"]):
        return "bf16"
    if "hi" in lp["qkv_w"]:
        if not w8a8:
            refuse_outliers(lp["qkv_w"])
        return "outlier"
    return "w8a8" if w8a8 else "int8w"


def fused_encoder_layer(x: torch.Tensor, lp, config: ViTConfig, *,
                        w8a8: bool = False) -> torch.Tensor:
    """One pre-LN encoder layer. x: [B, T, D] → [B, T, D] in x's dtype.

    ``lp`` is one layer's slice of the stacked params (models/vit layout:
    qkv_w [D, 3D], out_w [D, D], fc1_w [D, H], fc2_w [H, D] in the param
    dtype, or as int8 dicts {"q": [in, out], "scale": [1, out]} from
    models/quant, with a bf16 "hi" group in the outlier-aware form; fp32
    LN parameters and biases). ``w8a8`` quantizes the activations too."""
    global LAUNCHES, LAUNCHES_INT8W, LAUNCHES_W8A8, LAUNCHES_W8A8_OUTLIER
    form = _form(lp, w8a8)
    if form in ("w8a8", "outlier"):
        out = _chain_w8a8(x, lp, config, layernorm.layer_norm,
                          quantize.quantize_rows, quantize.quantize_rows_split,
                          quantize.quantize_rows_masked,
                          linear.fused_linear_w8a8,
                          attention.packed_fused_attention)
    else:
        out = _chain(x, lp, config, layernorm.layer_norm, linear.fused_linear,
                     attention.packed_fused_attention)
    if x.is_cuda:
        if form == "outlier":
            LAUNCHES_W8A8_OUTLIER += 1
        elif form == "w8a8":
            LAUNCHES_W8A8 += 1
        elif form == "int8w":
            LAUNCHES_INT8W += 1
        else:
            LAUNCHES += 1
    return out


def fused_encoder_layer_reference(x: torch.Tensor, lp, config: ViTConfig, *,
                                  w8a8: bool = False) -> torch.Tensor:
    """The chain computed by each link's plain version, on any device."""
    if _form(lp, w8a8) in ("w8a8", "outlier"):
        return _chain_w8a8(x, lp, config, layernorm.layer_norm_reference,
                           quantize.quantize_rows_reference,
                           quantize.quantize_rows_split_reference,
                           quantize.quantize_rows_masked_reference,
                           linear.fused_linear_w8a8_reference,
                           attention.packed_fused_attention_reference)
    return _chain(x, lp, config, layernorm.layer_norm_reference,
                  linear.fused_linear_reference,
                  attention.packed_fused_attention_reference)

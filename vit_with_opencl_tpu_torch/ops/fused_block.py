"""Pre-LN encoder layers as chains of the port's CUDA kernels.

Replaces ``vit_with_opencl_tpu/ops/fused_block.py:_block_kernel``
(``fused_encoder_layer``, and ``fused_encoder_group`` for its ``depth > 1``
form) in its four forms, and ``_stack_kernel`` (``fused_encoder_stack``,
``fused_encoder_layer_flat``). The TPU kernels keep a layer's weights (14.2
MB for ViT-B in bf16), a group's or a small model's whole stack (10.6 MB for
ViT-Ti) resident in on-chip memory and never write an activation back
between stages. A Hopper SM has 227 KB of shared memory, so here each is a
chain of launches, with the activations passing through device memory:

  bf16 and weight-only int8 (``quantized=True``), 7 launches a layer:
    LN1 (layernorm.cu) → qkv GEMM + bias (linear.cu) → packed attention
    (attention.cu) → out-proj GEMM + fp32 residual + bias → LN2 (fp32 in)
    → fc1 GEMM + bias + ``_gelu_fast`` → fc2 GEMM + fp32 residual + bias;
    with int8 weights each GEMM is the int8-weight one, whose fp32 product
    is multiplied by the per-channel scale before the epilogue. Inside the
    stack and a group, fc2 writes the fp32 stream and the next layer's LN1
    reads it.
  W8A8 (``quantized=True, w8a8=True``), 11 launches a layer:
    LN1 (fp32 out) → quantize (quantize.cu) → int8 qkv GEMM + bias → packed
    attention → quantize → int8 out-proj + fp32 residual + bias → LN2 (fp32
    out) → quantize → int8 fc1 + bias + ``_gelu_fast`` (fp32 out) → quantize
    → int8 fc2 + fp32 residual + bias.
  calibrated outlier-aware W8A8 (``w8a8=True`` with the ``"hi"`` weight
  dicts of ``models/quant.calibrate_w8a8``), 11 launches a layer: the W8A8
  chain with the outlier forms of its quantizes and GEMMs (``_mm`` with
  ``hi_ref`` and ``_mm_ctx_masked``). Before qkv, fc1 and fc2 the split
  quantize (quantize.cu) quantizes the leading columns of the fp32 LN output
  or GELU'd hidden and rounds the trailing outlier group to the activation
  dtype; before out-proj the masked quantize leaves each head's tail
  columns of the context out of the absmax, clips them, and copies them
  out. Each GEMM then adds its bf16 side product over the outlier group
  (linear.cu), after the scales and before the residual and the bias. The
  stack has no such form (``ValueError``, as in the JAX package).

The numerics are the TPU kernels': fp32 LN statistics, fp32 accumulation
(exact int32 for W8A8), the residual stream kept in fp32 across the layers
of one launch there (one layer for ``fused_encoder_layer``, a group for
``fused_encoder_group``, every layer for ``fused_encoder_stack``) and
rounded to the activation dtype only at its end (rounding it at each layer
would change the result), residual added before the bias, the
tanh-polynomial ``_gelu_fast`` (not erf). Inside a layer the LN outputs and
the GELU'd hidden are rounded to the activation dtype for bf16 and int8
weights; W8A8 quantizes the fp32 LN outputs and the fp32 GELU'd hidden
directly, with no bf16 rounding first (a rounding there would move int8
decisions); the qkv product is rounded to the activation dtype after its
bias, and the attention context is quantized from the activation dtype.

Each function launches the kernels for CUDA tensors; for CPU tensors every
link computes its plain version, which is its ``*_reference`` on any
device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import ViTConfig
from ..models.quant import is_quantized, refuse_outliers
from . import attention, layernorm, linear, quantize

# Runs on the card since the counts were last set to 0 (chip_smoke.py reads
# them), counted when all of a run's launches went out. Per layer, for the
# bf16, weight-only int8, W8A8 and outlier-aware W8A8 chains:
LAUNCHES = 0
LAUNCHES_INT8W = 0
LAUNCHES_W8A8 = 0
LAUNCHES_W8A8_OUTLIER = 0
# Per ``fused_encoder_stack`` call, for the bf16, weight-only int8 and W8A8
# stacks; per group of ``fused_encoder_group``, in any form.
LAUNCHES_STACK = 0
LAUNCHES_STACK_INT8W = 0
LAUNCHES_STACK_W8A8 = 0
LAUNCHES_GROUP = 0

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
# one kernel (``_stack_kernel``); ``supports_stack`` routes the same configs
# to ``fused_encoder_stack`` and decides what
# ``engine.resolve_quantize("auto")`` picks.
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


class _Links(NamedTuple):
    """The kernels (or plain versions) a chain is made of."""
    ln: Callable
    mm: Callable
    attn: Callable
    quant: Callable
    split: Callable
    masked: Callable
    mm8: Callable


_KERNELS = _Links(layernorm.layer_norm, linear.fused_linear,
                  attention.packed_fused_attention, quantize.quantize_rows,
                  quantize.quantize_rows_split, quantize.quantize_rows_masked,
                  linear.fused_linear_w8a8)
_PLAIN = _Links(layernorm.layer_norm_reference, linear.fused_linear_reference,
                attention.packed_fused_attention_reference,
                quantize.quantize_rows_reference,
                quantize.quantize_rows_split_reference,
                quantize.quantize_rows_masked_reference,
                linear.fused_linear_w8a8_reference)


def _chain(x, lps, config: ViTConfig, k: _Links) -> torch.Tensor:
    """bf16 or weight-only int8 through the layers ``lps`` in order: 7
    launches a layer, the residual stream in fp32 between them."""
    cdt, f32, eps = x.dtype, torch.float32, config.eps

    def mm(h, lp, key, **kw):
        w = lp[key]
        if is_quantized(w):
            return k.mm(h, w["q"], lp[key[:-1] + "b"], w_scale=w["scale"], **kw)
        return k.mm(h, w.to(cdt), lp[key[:-1] + "b"], **kw)

    for i, lp in enumerate(lps):
        h = k.ln(x, lp["ln1_w"], lp["ln1_b"], eps, out_dtype=cdt)
        qkv = mm(h, lp, "qkv_w", out_dtype=cdt)
        ctx = k.attn(qkv, num_heads=config.num_heads, head_dim=config.head_dim)
        x1 = mm(ctx, lp, "out_w", residual=x, out_dtype=f32)
        h2 = k.ln(x1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=cdt)
        hid = mm(h2, lp, "fc1_w", fuse_gelu=True, out_dtype=cdt)
        x = mm(hid, lp, "fc2_w", residual=x1,
               out_dtype=cdt if i + 1 == len(lps) else f32)
    return x


def _chain_w8a8(x, lps, config: ViTConfig, k: _Links) -> torch.Tensor:
    """W8A8, plain or outlier-aware, through the layers ``lps`` in order:
    11 launches a layer, the residual stream in fp32 between them."""
    cdt, f32 = x.dtype, torch.float32
    eps, nh, hd = config.eps, config.num_heads, config.head_dim

    def mm_q(h, lp, key, **kw):
        w, b = lp[key], lp[key[:-1] + "b"]
        if "hi" not in w:
            hq, hs = k.quant(h)
            return k.mm8(hq, hs, w["q"], w["scale"], b, **kw)
        if key == "out_w":  # the context's per-head tails
            hq, hs, h_hi = k.masked(h, nh, hd, w["hi"].shape[0] // nh)
        else:  # a trailing group, rounded to the activation dtype
            hq, hs, h_hi = k.split(h, w["q"].shape[0], cdt)
        return k.mm8(hq, hs, w["q"], w["scale"], b, x_hi=h_hi,
                     w_hi=w["hi"].to(cdt), **kw)

    for i, lp in enumerate(lps):
        h = k.ln(x, lp["ln1_w"], lp["ln1_b"], eps, out_dtype=f32)
        qkv = mm_q(h, lp, "qkv_w", out_dtype=cdt)
        ctx = k.attn(qkv, num_heads=nh, head_dim=hd)
        x1 = mm_q(ctx, lp, "out_w", residual=x, out_dtype=f32)
        h2 = k.ln(x1, lp["ln2_w"], lp["ln2_b"], eps, out_dtype=f32)
        hid = mm_q(h2, lp, "fc1_w", fuse_gelu=True, out_dtype=f32)
        x = mm_q(hid, lp, "fc2_w", residual=x1,
                 out_dtype=cdt if i + 1 == len(lps) else f32)
    return x


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


def _run(x, lps, config: ViTConfig, w8a8: bool, k: _Links) -> torch.Tensor:
    if _form(lps[0], w8a8) in ("w8a8", "outlier"):
        return _chain_w8a8(x, lps, config, k)
    return _chain(x, lps, config, k)


def _layers(layers, count: int) -> list:
    """The first ``count`` layers of a stacked pytree (leading layer axis),
    one dict each."""
    def take(v, i):
        return {kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i]

    return [{key: take(v, i) for key, v in layers.items()} for i in range(count)]


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
    out = _run(x, [lp], config, w8a8, _KERNELS)
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
    return _run(x, [lp], config, w8a8, _PLAIN)


def _groups(layers, config: ViTConfig, group_size: int) -> list:
    if group_size < 1 or config.depth % group_size:
        raise ValueError(f"group_size {group_size} does not divide depth "
                         f"{config.depth}")
    lps = _layers(layers, config.depth)
    return [lps[i:i + group_size] for i in range(0, config.depth, group_size)]


def fused_encoder_group(x: torch.Tensor, layers, config: ViTConfig, *,
                        group_size: int, w8a8: bool = False) -> torch.Tensor:
    """The encoder as groups of ``group_size`` consecutive layers: the
    residual stream in fp32 inside a group, in x's dtype between groups
    (the JAX package's ``_block_kernel`` at ``depth = group_size``).
    ``layers`` is the stacked per-layer pytree of all ``config.depth``
    layers, in any of the four forms."""
    global LAUNCHES_GROUP
    for group in _groups(layers, config, group_size):
        x = _run(x, group, config, w8a8, _KERNELS)
        if x.is_cuda:
            LAUNCHES_GROUP += 1
    return x


def fused_encoder_group_reference(x: torch.Tensor, layers, config: ViTConfig,
                                  *, group_size: int,
                                  w8a8: bool = False) -> torch.Tensor:
    """The groups computed by each link's plain version, on any device."""
    for group in _groups(layers, config, group_size):
        x = _run(x, group, config, w8a8, _PLAIN)
    return x


def _stack_layers(layers, config: ViTConfig, num_layers) -> list:
    if is_quantized(layers["qkv_w"]) and "hi" in layers["qkv_w"]:
        raise ValueError(
            "the whole-stack kernel has no outlier-aware W8A8 path (stack-"
            "class models route W8A8 per-layer; see models/vit.encoder)")
    return _layers(layers, config.depth if num_layers is None else num_layers)


def fused_encoder_stack(x: torch.Tensor, layers, config: ViTConfig, *,
                        num_layers=None, w8a8: bool = False) -> torch.Tensor:
    """``num_layers`` consecutive encoder layers (default ``config.depth``)
    as one chain: x [B, T, D] → [B, T, D] in x's dtype, the residual stream
    in fp32 throughout and rounded once, at the end.

    ``layers`` is the stacked per-layer pytree (leading layer axis), in the
    bf16, int8-weight or (with ``w8a8``) W8A8 form; outlier-aware weights
    raise ``ValueError``. The JAX kernel pads T to a multiple of 16 and
    masks the padded keys, which then carry exactly zero weight, and its
    GEMMs are row-wise, so padded rows never reach real ones: T stays as it
    is here."""
    global LAUNCHES_STACK, LAUNCHES_STACK_INT8W, LAUNCHES_STACK_W8A8
    lps = _stack_layers(layers, config, num_layers)
    form = _form(lps[0], w8a8)
    out = _run(x, lps, config, w8a8, _KERNELS)
    if x.is_cuda:
        if form == "w8a8":
            LAUNCHES_STACK_W8A8 += 1
        elif form == "int8w":
            LAUNCHES_STACK_INT8W += 1
        else:
            LAUNCHES_STACK += 1
    return out


def fused_encoder_stack_reference(x: torch.Tensor, layers, config: ViTConfig,
                                  *, num_layers=None,
                                  w8a8: bool = False) -> torch.Tensor:
    """The stack computed by each link's plain version, on any device."""
    return _run(x, _stack_layers(layers, config, num_layers), config, w8a8,
                _PLAIN)


def fused_encoder_layer_flat(x: torch.Tensor, lp,
                             config: ViTConfig) -> torch.Tensor:
    """One encoder layer through the stack (``num_layers=1``): the
    ``encoder_block`` slot's alternative to ``fused_encoder_layer``."""
    layers1 = {k: ({kk: vv[None] for kk, vv in v.items()}
                   if isinstance(v, dict) else v[None]) for k, v in lp.items()}
    return fused_encoder_stack(x, layers1, config, num_layers=1)

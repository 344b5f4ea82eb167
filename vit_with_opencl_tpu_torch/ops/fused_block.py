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
    LN1 (layernorm.cu) → qkv GEMM + bias (gemm_sm90.cuh) → packed attention
    (attention.cu) → out-proj GEMM + fp32 residual + bias → LN2 (fp32 in)
    → fc1 GEMM + bias + ``_gelu_fast`` → fc2 GEMM + fp32 residual + bias;
    with int8 weights each GEMM is the int8-weight one, whose fp32 product
    is multiplied by the per-channel scale before the epilogue. Inside the
    stack and a group, fc2 writes the fp32 stream and the next layer's LN1
    reads it.
  W8A8 (``quantized=True, w8a8=True``), 11 launches a layer:
    LN1 (fp32 out) → quantize (quantize.cu) → int8 qkv GEMM + bias (the
    core's int8 ``wgmma`` form, its int8 weights stored K-major) → packed
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
  (the core's side form), after the scales and before the residual and the
  bias. The stack has no such form (``ValueError``, as in the JAX package).

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

The attention link is ``attention.packed_fused_attention``, which routes
as JAX's packed attention does: past ``SINGLE_PASS_MAX_T`` (padded T >
1024, e.g. ViT-L/16@512's 1025 tokens) it runs the blockwise kernel
(``csrc/attention_flash.cu``), in the forward chain and in the backward's
two recomputes (``_attn_recompute``), and the plain links take the plain
blockwise version. JAX's fused layer keeps the whole-row one-shot softmax
there: the same function with other rounding points (the scale on the fp32
scores instead of a bf16-scaled q, and p rounded to bf16 against the running
max of each 128-key tile instead of the row's max). The backward's
attention stage still takes ``packed_attention_bwd`` (the streamed
``csrc/attention_bwd.cu``, any T), which recomputes the whole-row softmax
as JAX's ``_attn_bwd_kernel`` does.

Each function launches the kernels for CUDA tensors; for CPU tensors every
link computes its plain version, which is its ``*_reference`` on any
device. On the card the chains refuse to run under autograd (their results
would carry no graph).

Training (the JAX package's ``fused_encoder_layer_trainable`` and its
three-kernel backward, ``fused_encoder_layer_bwd``) is here too: a
``torch.autograd.Function`` whose forward is ``fused_encoder_layer`` and
whose only saved activation is x, and whose backward is three stages, each
a chain of the kernels above and of the backward's own (the GEMM forms of
``linear.py``, ``layernorm.layer_norm_bwd`` and ``column_sum``, and
``attention.packed_attention_bwd``):

  ``fused_bwd_stage_x2`` (``_attn_half_fwd_kernel``): LN1 → qkv GEMM →
    attention → out-proj GEMM with the fp32 x residual: fp32 x2 (4 launches);
  ``fused_bwd_stage_mlp_mono`` (``_mlp_bwd_kernel``): LN2 → the fc1
    recompute (fp32 hid_pre and bf16 GELU'd hidden) → dfc2_w, dfc2_b →
    fc2's dgrad times the GELU gradient (fp32 dhid_pre and its bf16) →
    dfc1_w, dfc1_b → fc1's dgrad → LN2 backward with dOut added: fp32 dx2
    (11 launches with the column sums);
  or, past ``MLP_BWD_RESIDENT_BUDGET`` (ViT-L/H widths), the same split at
  the GELU as the JAX package's pair:
  ``fused_bwd_stage_mlp_light`` (``_mlp_light_bwd_kernel``): the mono
    stage without its two weight gradients, returning the bf16 GELU'd
    hidden and dhid_pre streams it made (9 launches);
  ``fused_bwd_stage_mlp_wgrad`` (``_mlp_wgrad_kernel``): LN2 recomputed
    from x2 → dfc1_w = h2cᵀ · dhpc and dfc2_w = hidcᵀ · dOut over all B·T
    tokens (3 launches). The TPU kernel chunks H so that its fp32
    accumulators fit VMEM; a GEMM block here keeps its output tile's fp32
    accumulator in registers whatever H is, so each gradient is one launch
    over the whole H, and ``mlp_chunks`` is validated as in JAX but does
    not change the result;
  ``fused_bwd_stage_attn`` (``_attn_bwd_kernel``): the attention half
    recomputed (3 launches) → dout_w, dout_b → out-proj dgrad (bf16 dctx)
    → attention backward (fp32 dqkv) → dqkv_b, dqkv_w (from dqkv rounded
    to the activation dtype) → qkv dgrad → LN1 backward with dx2 added: dx
    in x's dtype (13 launches with the column sums).

They keep the TPU kernels' rounding points: fp32 LN statistics, the
activation dtype for h1c, qkvc, ctx, h2c, hidc, dmc, dac, dctx, dhpc and
dqkv_c, fp32 for x2, dx2, hid_pre, dhid_pre and the dqkv that the bias sum
reads, every gradient accumulated in fp32 and cast to its leaf's dtype at
the end. The TPU split the backward in three (four with the chunked MLP
pair) to fit VMEM; here the split costs nothing more than the attention
half's recompute, which stage 3 does again as the TPU kernel does, and, in
the chunked pair, LN2 again and a [B, T, H] round trip of the two bf16
streams.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import ViTConfig
from ..models.quant import is_quantized, refuse_outliers
from . import _build, attention, layernorm, linear, quantize

# Runs on the card since the counts were last set to 0 (chip_smoke.py reads
# them), counted when all of a run's launches went out. Per layer, for the
# three backward stages and the whole backward:
LAUNCHES_BWD_X2 = 0
LAUNCHES_BWD_MLP = 0
LAUNCHES_BWD_MLP_LIGHT = 0
LAUNCHES_BWD_MLP_WGRAD = 0
LAUNCHES_BWD_ATTN = 0
LAUNCHES_BWD = 0
# Per layer, for the bf16, weight-only int8, W8A8 and outlier-aware W8A8
# chains:
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
# are written out in csrc/epilogue.cuh (gelu_fast).
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


def _gelu_fast_grad(x: torch.Tensor) -> torch.Tensor:
    """Derivative of ``_gelu_fast`` (not of exact erf-GELU: the backward
    differentiates what the forward computed).

    g(x) = 0.5 x (1 + tanh(w)), w = x P(x²)
    g'(x) = 0.5 (1 + t) + 0.5 x (1 − t²) (P(u) + 2 u P'(u)),  t = tanh(w)
    """
    u = x * x
    p = _GELU_P[4]
    for c in _GELU_P[3::-1]:
        p = p * u + c

    def f32(v):  # the coefficient as jnp.float32 rounds it
        return float(torch.tensor(v, dtype=torch.float32))

    dp = 4.0 * f32(_GELU_P[4])
    for i, c in zip((3.0, 2.0, 1.0), _GELU_P[3:0:-1]):
        dp = dp * u + i * f32(c)
    t = torch.tanh(x * p)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * (p + 2.0 * u * dp)


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
    """The kernels (or plain versions) the chains are made of: the forward's,
    then the training backward's."""
    ln: Callable
    mm: Callable
    attn: Callable
    quant: Callable
    split: Callable
    masked: Callable
    mm8: Callable
    mm_gelu: Callable
    dgrad: Callable
    wgrad: Callable
    ln_bwd: Callable
    csum: Callable
    attn_bwd: Callable


_KERNELS = _Links(layernorm.layer_norm, linear.fused_linear,
                  attention.packed_fused_attention, quantize.quantize_rows,
                  quantize.quantize_rows_split, quantize.quantize_rows_masked,
                  linear.fused_linear_w8a8, linear.fused_linear_with_gelu,
                  linear.linear_dgrad, linear.linear_wgrad,
                  layernorm.layer_norm_bwd, layernorm.column_sum,
                  attention.packed_attention_bwd)
_PLAIN = _Links(layernorm.layer_norm_reference, linear.fused_linear_reference,
                attention.packed_fused_attention_reference,
                quantize.quantize_rows_reference,
                quantize.quantize_rows_split_reference,
                quantize.quantize_rows_masked_reference,
                linear.fused_linear_w8a8_reference,
                linear.fused_linear_with_gelu_reference,
                linear.linear_dgrad_reference, linear.linear_wgrad_reference,
                layernorm.layer_norm_bwd_reference,
                layernorm.column_sum_reference,
                attention.packed_attention_bwd_reference)


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


def _refuse_autograd(what: str, x: torch.Tensor, weights: dict) -> None:
    if x.is_cuda:
        _build.refuse_autograd(what, (x, weights),
                               "fused_encoder_layer_trainable")


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
    _refuse_autograd("fused_encoder_layer", x, lp)
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
    _refuse_autograd("fused_encoder_group", x, layers)
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
    _refuse_autograd("fused_encoder_stack", x, layers)
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


# ---------------------------------------------------------------------------
# Training: the rematerialising backward of one layer (x is its only saved
# activation) and the autograd Function around the forward chain
# ---------------------------------------------------------------------------

# The JAX package's resident ceilings, kept so that both packages route each
# config the same way: the MLP backward runs as one stage when its bf16
# weights and fp32 gradients fit ``MLP_BWD_RESIDENT_BUDGET`` (ViT-B: 28.3
# MB), else the light/wgrad pair chunked over H; the attention side gates
# ``supports_trainable``.
MLP_BWD_RESIDENT_BUDGET = 40 << 20
MLP_WGRAD_CHUNK_BUDGET = 32 << 20
TRAINABLE_ATTN_RESIDENT_BUDGET = 52 << 20

_ATTN_KEYS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b")
_MLP_KEYS = ("ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _ln_fwd_stats(xf: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  eps: float):
    """LN forward returning (x̂, inv_std, out) in fp32."""
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    return xhat, inv, xhat * w.float() + b.float()


def _ln_bwd(dy: torch.Tensor, xhat: torch.Tensor, inv: torch.Tensor,
            w: torch.Tensor):
    """dx for y = x̂·w + b given fp32 dy: (dx, dw rows, db rows); the rows
    still need the token-axis ``_csum``."""
    dxhat = dy * w.float()
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, dy * xhat, dy


def _csum(x: torch.Tensor) -> torch.Tensor:
    """Token-axis column sum → [1, cols] fp32."""
    return layernorm.column_sum_reference(x)[None]


def _pick_mlp_chunks(d: int, hdim: int, itemsize: int) -> int:
    """1 → the single MLP-backward stage; else the H-chunk count of the
    JAX package's light/wgrad split (smallest divisor of H whose fp32
    accumulators fit)."""
    if 2 * d * hdim * (itemsize + 4) <= MLP_BWD_RESIDENT_BUDGET:
        return 1
    for nc in (2, 3, 4, 5, 6, 8, 10, 16):
        if hdim % nc == 0 and 2 * d * (hdim // nc) * 4 <= MLP_WGRAD_CHUNK_BUDGET:
            return nc
    raise ValueError(
        f"no H-chunking of hidden_dim={hdim} fits the wgrad VMEM budget")


def supports_trainable(config: ViTConfig, dtype_bytes: int = 2) -> bool:
    """Whether training routes this config through the fused layer and its
    fused backward (the JAX package's gate)."""
    if config.gelu_approx != "erf":
        return False
    d, h = config.embed_dim, config.hidden_dim
    if (d * 3 * d + d * d) * (dtype_bytes + 4) > TRAINABLE_ATTN_RESIDENT_BUDGET:
        return False
    try:
        _pick_mlp_chunks(d, h, dtype_bytes)
    except ValueError:
        return False
    return True


def _attn_recompute(x, lp, config: ViTConfig, k: _Links):
    """The attention half's forward from x, as ``_block_kernel`` computes
    it: (h1c, qkvc, ctx) in x's dtype."""
    cdt = x.dtype
    h1c = k.ln(x, lp["ln1_w"], lp["ln1_b"], config.eps, out_dtype=cdt)
    qkvc = k.mm(h1c, lp["qkv_w"].to(cdt), lp["qkv_b"], out_dtype=cdt)
    ctx = k.attn(qkvc, num_heads=config.num_heads, head_dim=config.head_dim)
    return h1c, qkvc, ctx


def _stage_x2(x, lp, config: ViTConfig, k: _Links) -> torch.Tensor:
    _, _, ctx = _attn_recompute(x, lp, config, k)
    return k.mm(ctx, lp["out_w"].to(x.dtype), lp["out_b"], residual=x,
                out_dtype=torch.float32)


def _h2c(x2, lp, config: ViTConfig, k: _Links, cdt):
    return k.ln(x2, lp["ln2_w"], lp["ln2_b"], config.eps, out_dtype=cdt)


def _mlp_light(x2, dout, lp, config: ViTConfig, k: _Links):
    """The MLP backward but its two weight gradients: (h2c, fp32 dx2, the
    bf16 streams hidc and dhpc, the four small gradients)."""
    cdt, f32 = dout.dtype, torch.float32
    fc1_w, fc2_w = lp["fc1_w"].to(cdt), lp["fc2_w"].to(cdt)
    h2c = _h2c(x2, lp, config, k, cdt)
    hid_pre, hidc = k.mm_gelu(h2c, fc1_w, lp["fc1_b"], out2_dtype=cdt)
    g = {"fc2_b": k.csum(dout)}
    dhid_pre, dhpc = k.dgrad(dout, fc2_w, gelu_grad_of=hid_pre, out_dtype=f32,
                             out2_dtype=cdt)
    g["fc1_b"] = k.csum(dhid_pre)
    dh2 = k.dgrad(dhpc, fc1_w, out_dtype=f32)
    dx2, g["ln2_w"], g["ln2_b"] = k.ln_bwd(x2, dh2, lp["ln2_w"], config.eps,
                                           residual=dout, out_dtype=f32)
    return h2c, dx2, hidc, dhpc, g


def _mlp_wgrad(h2c, dout, hidc, dhpc, k: _Links):
    """(dfc1_w, dfc2_w) in fp32, each one GEMM over every token."""
    return k.wgrad(h2c, dhpc), k.wgrad(hidc, dout)


def _stage_mlp(x2, dout, lp, config: ViTConfig, k: _Links):
    h2c, dx2, hidc, dhpc, g = _mlp_light(x2, dout, lp, config, k)
    g["fc1_w"], g["fc2_w"] = _mlp_wgrad(h2c, dout, hidc, dhpc, k)
    return dx2, {key: g[key][None] for key in _MLP_KEYS}


_SMALL_KEYS = ("ln2_w", "ln2_b", "fc1_b", "fc2_b")


def _stage_mlp_light(x2, dout, lp, config: ViTConfig, k: _Links):
    _, dx2, hidc, dhpc, g = _mlp_light(x2, dout, lp, config, k)
    return dx2, hidc, dhpc, {key: g[key][None] for key in _SMALL_KEYS}


def _stage_mlp_wgrad(x2, dout, hid_s, dhp_s, lp, config: ViTConfig, k: _Links,
                     mlp_chunks: int):
    hdim = config.hidden_dim
    if mlp_chunks < 1 or hdim % mlp_chunks:
        raise ValueError(
            f"mlp_chunks={mlp_chunks} must divide hidden_dim={hdim}")
    h2c = _h2c(x2, lp, config, k, dout.dtype)
    dfc1_w, dfc2_w = _mlp_wgrad(h2c, dout, hid_s, dhp_s, k)
    return dfc1_w[None], dfc2_w[None]


def _stage_attn(x, dx2, lp, config: ViTConfig, k: _Links):
    cdt, f32 = x.dtype, torch.float32
    h1c, qkvc, ctx = _attn_recompute(x, lp, config, k)
    dac = dx2.to(cdt)
    g = {"out_w": k.wgrad(ctx, dac), "out_b": k.csum(dx2)}
    dctx = k.dgrad(dac, lp["out_w"].to(cdt), out_dtype=cdt)
    dqkv = k.attn_bwd(qkvc, dctx, config.num_heads, config.head_dim,
                      out_dtype=f32)
    g["qkv_b"] = k.csum(dqkv)
    dqkv_c = dqkv.to(cdt)
    g["qkv_w"] = k.wgrad(h1c, dqkv_c)
    dh1 = k.dgrad(dqkv_c, lp["qkv_w"].to(cdt), out_dtype=f32)
    dx, g["ln1_w"], g["ln1_b"] = k.ln_bwd(x, dh1, lp["ln1_w"], config.eps,
                                          residual=dx2, out_dtype=x.dtype)
    return dx, {key: g[key][None] for key in _ATTN_KEYS}


def fused_bwd_stage_x2(x: torch.Tensor, lp, config: ViTConfig) -> torch.Tensor:
    """Backward stage 1 (``_attn_half_fwd_kernel``): the attention half's
    forward recomputed from x [B, T, D], x → fp32 x2 = x + proj(attn(LN1 x))
    + b."""
    global LAUNCHES_BWD_X2
    out = _stage_x2(x, lp, config, _KERNELS)
    if x.is_cuda:
        LAUNCHES_BWD_X2 += 1
    return out


def fused_bwd_stage_x2_reference(x: torch.Tensor, lp,
                                 config: ViTConfig) -> torch.Tensor:
    """Stage 1 computed by each link's plain version, on any device."""
    return _stage_x2(x, lp, config, _PLAIN)


def fused_bwd_stage_mlp_mono(x2: torch.Tensor, dout: torch.Tensor, lp,
                             config: ViTConfig):
    """Backward stage 2 (``_mlp_bwd_kernel``, the single-stage route of
    ViT-B-class widths): (fp32 x2, dOut) → (fp32 dx2, the six MLP gradients
    with a leading [1] axis, fp32)."""
    global LAUNCHES_BWD_MLP
    out = _stage_mlp(x2, dout, lp, config, _KERNELS)
    if x2.is_cuda:
        LAUNCHES_BWD_MLP += 1
    return out


def fused_bwd_stage_mlp_mono_reference(x2: torch.Tensor, dout: torch.Tensor,
                                       lp, config: ViTConfig):
    """Stage 2 computed by each link's plain version, on any device."""
    return _stage_mlp(x2, dout, lp, config, _PLAIN)


def fused_bwd_stage_mlp_light(x2: torch.Tensor, dout: torch.Tensor, lp,
                              config: ViTConfig):
    """Backward stage 2a of the chunked route (``_mlp_light_bwd_kernel``,
    ViT-L/H widths): the MLP backward but its two weight gradients. (fp32
    x2, dOut) → (fp32 dx2, hid_s and dhp_s: the GELU'd hidden and dhid_pre
    [B, T, H] in dOut's dtype, {ln2_w, ln2_b, fc1_b, fc2_b} with a leading
    [1] axis, fp32)."""
    global LAUNCHES_BWD_MLP_LIGHT
    out = _stage_mlp_light(x2, dout, lp, config, _KERNELS)
    if x2.is_cuda:
        LAUNCHES_BWD_MLP_LIGHT += 1
    return out


def fused_bwd_stage_mlp_light_reference(x2: torch.Tensor, dout: torch.Tensor,
                                        lp, config: ViTConfig):
    """Stage 2a computed by each link's plain version, on any device."""
    return _stage_mlp_light(x2, dout, lp, config, _PLAIN)


def fused_bwd_stage_mlp_wgrad(x2: torch.Tensor, dout: torch.Tensor,
                              hid_s: torch.Tensor, dhp_s: torch.Tensor, lp,
                              config: ViTConfig, *, mlp_chunks: int = 2):
    """Backward stage 2b of the chunked route (``_mlp_wgrad_kernel``): LN2
    recomputed from x2, then (dfc1_w [1, D, H], dfc2_w [1, H, D]) in fp32
    from the streams of stage 2a. ``mlp_chunks`` must divide H
    (``ValueError`` otherwise, as in JAX); the result does not depend on
    it: each gradient is one GEMM over the whole H."""
    global LAUNCHES_BWD_MLP_WGRAD
    out = _stage_mlp_wgrad(x2, dout, hid_s, dhp_s, lp, config, _KERNELS,
                           mlp_chunks)
    if x2.is_cuda:
        LAUNCHES_BWD_MLP_WGRAD += 1
    return out


def fused_bwd_stage_mlp_wgrad_reference(x2: torch.Tensor, dout: torch.Tensor,
                                        hid_s: torch.Tensor,
                                        dhp_s: torch.Tensor, lp,
                                        config: ViTConfig, *,
                                        mlp_chunks: int = 2):
    """Stage 2b computed by each link's plain version, on any device."""
    return _stage_mlp_wgrad(x2, dout, hid_s, dhp_s, lp, config, _PLAIN,
                            mlp_chunks)


def fused_bwd_stage_attn(x: torch.Tensor, dx2: torch.Tensor, lp,
                         config: ViTConfig):
    """Backward stage 3 (``_attn_bwd_kernel``): (x, fp32 dx2) → (dx in x's
    dtype, the six attention gradients with a leading [1] axis, fp32).
    The attention half is recomputed from x; nothing [T, T]-shaped reaches
    device memory."""
    global LAUNCHES_BWD_ATTN
    out = _stage_attn(x, dx2, lp, config, _KERNELS)
    if x.is_cuda:
        LAUNCHES_BWD_ATTN += 1
    return out


def fused_bwd_stage_attn_reference(x: torch.Tensor, dx2: torch.Tensor, lp,
                                   config: ViTConfig):
    """Stage 3 computed by each link's plain version, on any device."""
    return _stage_attn(x, dx2, lp, config, _PLAIN)


def grads_to_leaf_dtypes(lp, grads) -> dict:
    """Strip the leading [1] axis and cast each gradient to its leaf's dtype
    (the cotangent contract)."""
    return {key: g[0].to(lp[key].dtype) for key, g in grads.items()}


def _layer_bwd(x, lp, dout, config: ViTConfig, mlp_chunks, stages):
    x2_fn, mono_fn, light_fn, wgrad_fn, attn_fn = stages
    if mlp_chunks is None:
        mlp_chunks = _pick_mlp_chunks(config.embed_dim, config.hidden_dim,
                                      x.element_size())
    dout = dout.contiguous()
    x2 = x2_fn(x, lp, config)
    if mlp_chunks == 1:
        dx2, mlp_grads = mono_fn(x2, dout, lp, config)
    else:
        dx2, hid_s, dhp_s, mlp_grads = light_fn(x2, dout, lp, config)
        mlp_grads["fc1_w"], mlp_grads["fc2_w"] = wgrad_fn(
            x2, dout, hid_s, dhp_s, lp, config, mlp_chunks=mlp_chunks)
    dx, attn_grads = attn_fn(x, dx2, lp, config)
    dlp = grads_to_leaf_dtypes(lp, mlp_grads)
    dlp.update(grads_to_leaf_dtypes(lp, attn_grads))
    return dx, dlp


def fused_encoder_layer_bwd(x: torch.Tensor, lp, dout: torch.Tensor,
                            config: ViTConfig, *, mlp_chunks=None):
    """The fused backward: (x [B, T, D], one layer's params, dOut [B, T, D])
    → (dx in x's dtype, {leaf: gradient in the leaf's dtype}). Three stages
    (x2, MLP, attention); the MLP stage is the mono one for ``mlp_chunks``
    = 1, else the light → wgrad pair (the JAX package's route past
    ``MLP_BWD_RESIDENT_BUDGET``, ViT-L/H). ``None`` picks as JAX does
    (``_pick_mlp_chunks``)."""
    global LAUNCHES_BWD
    out = _layer_bwd(x, lp, dout, config, mlp_chunks,
                     (fused_bwd_stage_x2, fused_bwd_stage_mlp_mono,
                      fused_bwd_stage_mlp_light, fused_bwd_stage_mlp_wgrad,
                      fused_bwd_stage_attn))
    if x.is_cuda:
        LAUNCHES_BWD += 1
    return out


def fused_encoder_layer_bwd_reference(x: torch.Tensor, lp, dout: torch.Tensor,
                                      config: ViTConfig, *, mlp_chunks=None):
    """The backward computed by each link's plain version, on any device."""
    return _layer_bwd(x, lp, dout, config, mlp_chunks,
                      (fused_bwd_stage_x2_reference,
                       fused_bwd_stage_mlp_mono_reference,
                       fused_bwd_stage_mlp_light_reference,
                       fused_bwd_stage_mlp_wgrad_reference,
                       fused_bwd_stage_attn_reference))


class _FusedLayer(torch.autograd.Function):
    """``fused_encoder_layer`` forward, ``fused_encoder_layer_bwd`` backward;
    saves x and the layer's parameter leaves (no activation but x)."""

    @staticmethod
    def forward(ctx, config, keys, x, *leaves):
        ctx.config, ctx.keys = config, keys
        ctx.save_for_backward(x, *leaves)
        return fused_encoder_layer(x, dict(zip(keys, leaves)), config)

    @staticmethod
    def backward(ctx, g):
        x, *leaves = ctx.saved_tensors
        dx, dlp = fused_encoder_layer_bwd(x, dict(zip(ctx.keys, leaves)), g,
                                          ctx.config)
        return (None, None, dx, *(dlp[key] for key in ctx.keys))


def fused_encoder_layer_trainable(x: torch.Tensor, lp,
                                  config: ViTConfig) -> torch.Tensor:
    """Differentiable fused encoder layer: the ``encoder_block`` slot of
    training's ``fused`` route. Forward ``fused_encoder_layer`` (the chain),
    backward ``fused_encoder_layer_bwd``; gradients come back for x and for
    every leaf of ``lp`` (float weights, fp32 masters or not) in the leaf's
    dtype. First-order only."""
    keys = tuple(lp)
    return _FusedLayer.apply(config, keys, x, *(lp[key] for key in keys))

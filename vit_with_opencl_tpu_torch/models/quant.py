"""int8 quantization: weight-only (per output channel), W8A8, and the
calibrated outlier-aware W8A8 mode.

Counterpart of ``vit_with_opencl_tpu/models/quant.py``. Matmul weights are
stored as int8 with one fp32 scale per output channel. Because the scale is
per *output* channel it commutes out of the product:

    y = (x @ dequant(Wq))  ==  (x @ Wq.to(x.dtype)) * scale

so weight-only int8 keeps the activation-dtype GEMM with a scale epilogue
(``matmul_q``). W8A8 also quantizes the activation per token at run time
(``quantize_act``) and runs int8 x int8 with exact integer accumulation,
then one fp32 epilogue ``acc * s_x * s_w`` (``matmul_w8a8``).

Outlier-aware W8A8 (``calibrate_w8a8``): trained ViTs carry a few persistent
activation channels 10-100x hotter than the rest, which inflate every
token's absmax scale. A calibration forward (``collect_act_stats``) measures
each channel's absmax at the four encoder GEMM inputs; ``plan_outliers``
permutes the hottest channels into a trailing group (per head, for the
attention context), which ``apply_outlier_plan`` folds into the weights
exactly; ``quantize_stacked_params_outlier`` then keeps each group's weight
rows in bf16 (a ``"hi"`` leaf) and quantizes the rest. At run time the
normal channels go through the int8 GEMM and the outlier group through a
small bf16 side product (``matmul_w8a8``'s trailing and masked forms).

Layout: stacked weights are right-multiply ``[..., in, out]``; scales are
``[..., 1, out]``, so slicing one layer off the stack works on both. The
W8A8 GEMM on the card reads its int8 weights K-major (int8 ``wgmma`` takes
no other layout): ``w8a8_layout`` stores the encoder's four int8 weights so
once, with the same logical ``[..., in, out]`` shape and values, where the
W8A8 params reach the card (the engine, the calibrated quantizers). The
weight-only int8 GEMM reads them row-major, so the two modes' params are
kept apart.

``quantize_act``, ``quantize_act_split`` and ``quantize_act_masked`` are the
plain versions of the quantize kernels (``ops/quantize.py``,
``csrc/quantize.cu``); ``matmul_q`` and ``matmul_w8a8`` are the per-op
``xla`` route, which the JAX package leaves to XLA. The host planners are
NumPy copies of the JAX package's; they take leaves as torch tensors or
NumPy arrays and return host pytrees of torch tensors on the CPU, with the
``"hi"`` leaves rounded to bf16 by torch (round to nearest even).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ViTConfig

# Keys of matmul weights inside params["layers"] (right-multiply layout).
_LAYER_MATMUL_KEYS = ("qkv_w", "out_w", "fc1_w", "fc2_w")
# Top-level matmul weights.
_TOP_MATMUL_KEYS = ("patch_w", "head_w", "head_dist_w")

# quantize_act's floor on a row's absmax: any nonzero value keeps the divide
# finite, and a zero row quantizes to zeros either way.
ACT_ABSMAX_FLOOR = 2.0 ** -93
_INV_127 = float(np.float32(1 / 127))


def quantize_weight(w: np.ndarray) -> Dict[str, np.ndarray]:
    """fp weight [..., in, out] → {"q": int8, "scale": f32 [..., 1, out]}."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=-2, keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    safe = np.where(scale == 0.0, 1.0, scale)
    q = np.clip(np.rint(w / safe), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale}


def dequantize_weight(qw: Dict[str, np.ndarray]) -> np.ndarray:
    return np.asarray(qw["q"], np.float32) * np.asarray(qw["scale"], np.float32)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "scale" in w


def is_k_major(q: torch.Tensor) -> bool:
    """Whether ``q`` [..., K, N] is stored K-major: each column's K values
    contiguous, the columns of a matrix one after another (the ``.mT`` of a
    contiguous [..., N, K] tensor)."""
    return q.dim() >= 2 and q.mT.is_contiguous()


def k_major(q: torch.Tensor) -> torch.Tensor:
    """``q`` [..., K, N] with its values and shape, stored K-major (one copy;
    none where it is stored so already)."""
    return q if is_k_major(q) else q.mT.contiguous().mT


def w8a8_layout(params: Dict[str, Any]) -> Dict[str, Any]:
    """Stacked params with the encoder's four int8 weights (``"q"`` of
    ``params["layers"]``) stored K-major, as the W8A8 GEMM takes them on the
    card: one copy of each, on its device, at set-up. Every other leaf,
    every value and every shape stays as it is; fp weights pass through."""
    layers = dict(params["layers"])
    for key in _LAYER_MATMUL_KEYS:
        if is_quantized(layers[key]):
            layers[key] = {**layers[key], "q": k_major(layers[key]["q"])}
    return {**params, "layers": layers}


def _quantize_tensor(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``quantize_weight`` on the host, the result back on w's device."""
    qw = quantize_weight(w.detach().float().cpu().numpy())
    return {k: torch.from_numpy(v).to(w.device) for k, v in qw.items()}


def quantize_stacked_params(params: Dict[str, Any],
                            config: ViTConfig) -> Dict[str, Any]:
    """Quantize every matmul weight of a stacked param dict (on the host, in
    NumPy, from the weights as stored: bf16 ones are read back exactly).

    LN parameters, biases and embeddings stay as they are (fp32). The
    int8 and scale tensors land on the device each weight came from."""
    out = dict(params)
    for key in _TOP_MATMUL_KEYS:
        if key in out:
            out[key] = _quantize_tensor(out[key])
    layers = dict(params["layers"])
    for key in _LAYER_MATMUL_KEYS:
        layers[key] = _quantize_tensor(layers[key])
    out["layers"] = layers
    return out


def quantize_weight_device(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Torch twin of ``quantize_weight`` on w's own device (no host round
    trip). As the JAX package's device twin, the scale is absmax times
    float32(1/127), a multiply where the host version divides."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = absmax * _INV_127
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(wf / safe), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_stacked_params_device(params: Dict[str, Any],
                                   config: ViTConfig) -> Dict[str, Any]:
    """Device-side twin of ``quantize_stacked_params``."""
    out = dict(params)
    for key in _TOP_MATMUL_KEYS:
        if key in out:
            out[key] = quantize_weight_device(out[key])
    layers = dict(params["layers"])
    for key in _LAYER_MATMUL_KEYS:
        layers[key] = quantize_weight_device(layers[key])
    out["layers"] = layers
    return out


def quantize_act(x: torch.Tensor):
    """Dynamic per-token symmetric activation quantization.

    x [..., D] (any float dtype) → (int8 [..., D], fp32 scale [..., 1]) with
    scale = rowwise absmax / 127. One divide per row, then multiplies; no
    clip is needed: |x| <= absmax elementwise, so |x·r| <= 127·(1 + 2⁻²³)
    < 127.5 and rounding half to even (``torch.round``) never gives 128.
    """
    xf = x.float()
    absmax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True),
                             ACT_ABSMAX_FLOOR)
    # A tensor numerator: ``127.0 / absmax`` would take PyTorch's
    # reciprocal-then-multiply route, two roundings where this is one.
    r = torch.full_like(absmax, 127.0) / absmax
    q = torch.round(xf * r).to(torch.int8)
    return q, absmax * _INV_127


def quantize_act_split(x: torch.Tensor, m: int, hi_dtype: torch.dtype):
    """The trailing-group quantize: ``quantize_act`` of each row's leading
    ``m`` values (the absmax over those only), and the trailing ``D - m``
    values cast to ``hi_dtype`` (to bf16: rounded to nearest even).

    → (int8 [..., m], fp32 scale [..., 1], hi [..., D - m])."""
    q, s = quantize_act(x[..., :m])
    return q, s, x[..., m:].to(hi_dtype).contiguous()


def _tail_mask_heads(num_heads: int, head_dim: int, kh: int) -> np.ndarray:
    """bool [num_heads * head_dim]: True on each head's trailing ``kh``."""
    m = np.zeros(num_heads * head_dim, bool)
    for head in range(num_heads):
        m[head * head_dim + head_dim - kh:(head + 1) * head_dim] = True
    return m


def quantize_act_masked(x: torch.Tensor, num_heads: int, head_dim: int,
                        kh: int):
    """The per-head-tail quantize of the attention context: each head's
    last ``kh`` columns are left out of the row's absmax, and, since they
    can exceed it, the int8 values are clipped to ±127 (their weight rows
    are zero, so the clipped values never reach the output).

    → (int8 [..., D], fp32 scale [..., 1], hi [..., num_heads * kh]: the
    tails in head order, in x's dtype)."""
    xf = x.float()
    keep = torch.from_numpy(~_tail_mask_heads(num_heads, head_dim, kh)).to(
        device=x.device, dtype=torch.float32)
    absmax = torch.clamp_min((xf.abs() * keep).amax(dim=-1, keepdim=True),
                             ACT_ABSMAX_FLOOR)
    r = torch.full_like(absmax, 127.0) / absmax
    q = torch.clamp(torch.round(xf * r), -127, 127).to(torch.int8)
    lead = x.shape[:-1]
    hi = x.reshape(*lead, num_heads, head_dim)[..., head_dim - kh:]
    return q, absmax * _INV_127, hi.reshape(*lead, num_heads * kh)


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [..., K] int8 @ wq [K, N] int8 → the exact integer sums as fp32.

    The sums run in float64, exact below 2⁵³ (|sum| <= K·127² ≈ 5e7 at
    K = 3072), and are rounded once to fp32, as an int32 accumulator
    converted to float is. PyTorch has no int8 matmul on every device."""
    return (xq.double() @ wq.double()).float()


def refuse_outliers(w: Dict[str, Any]) -> None:
    """Raise for an outlier-aware weight dict on a weight-only int8 path."""
    if "hi" in w:
        raise ValueError(
            "outlier-aware quantized params (bf16 'hi' groups) require the "
            "w8a8 path; weight-only int8 has no activation scales to protect")


def matmul_w8a8(x: torch.Tensor, w: Any, b: Any, heads=None) -> torch.Tensor:
    """W8A8 dynamic matmul: per-token int8 x × int8 weights, exact integer
    sums, then ``acc · s_x · s_w (+ b)`` in fp32, cast to x's dtype.

    fp weights fall back to ``matmul_q``, as in the JAX package.
    Outlier-aware dicts carry a bf16 ``"hi"`` block of calibrated outlier
    rows: a trailing group (q rows < input channels) runs as the int8
    product of the leading columns plus a bf16 side product of the trailing
    ones; a masked per-head-tail group (q rows == input channels, zero rows
    on the tails) also leaves the tails out of the absmax, and needs
    ``heads=(num_heads, head_dim)`` to find them."""
    if not is_quantized(w):
        return matmul_q(x, w, b)
    if w["q"].dim() != 2:
        raise ValueError(
            f"matmul_w8a8 expects a single layer's 2D weight, got q shape "
            f"{tuple(w['q'].shape)}")
    din, m = x.shape[-1], w["q"].shape[0]
    if "hi" not in w:
        xq, sx = quantize_act(x)
        x_hi = None
    elif m < din:
        xq, sx, x_hi = quantize_act_split(x, m, x.dtype)
    else:
        if heads is None:
            raise ValueError(
                "outlier W8A8 on the attention context needs "
                "heads=(num_heads, head_dim)")
        nh, hd = heads
        xq, sx, x_hi = quantize_act_masked(x, nh, hd, w["hi"].shape[0] // nh)
    out = int8_product(xq, w["q"]) * sx * w["scale"][..., 0, :]
    if x_hi is not None:
        out = out + x_hi.float() @ w["hi"].to(x.dtype).float()
    if b is not None:
        out = out + b
    return out.to(x.dtype)


def matmul_q(x: torch.Tensor, w: Any, b: Any) -> torch.Tensor:
    """Quantization-aware matmul for fp and int8 weights, fp32 accumulation.

    int8 weights are cast to x's dtype (exact: |q| <= 127) and the
    per-channel scale multiplies the fp32 product; result in x's dtype.
    Outlier-aware dicts raise ``ValueError``: they need the W8A8 path."""
    if is_quantized(w):
        if w["q"].dim() != 2:
            # A whole stacked weight would broadcast layer 0's scale over
            # every layer: wrong numbers and no shape error.
            raise ValueError(
                f"matmul_q expects a single layer's 2D weight, got q shape "
                f"{tuple(w['q'].shape)}")
        refuse_outliers(w)
        out = x.float() @ w["q"].to(x.dtype).float()
        out = out * w["scale"][..., 0, :]
    else:
        out = x.float() @ w.float()
    if b is not None:
        out = out + b
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Host pytrees: the planners compute in NumPy and hand back torch tensors
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    """A leaf (torch tensor on any device, or array) as host fp32 NumPy;
    bf16 values come back exactly."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _as_torch(tree):
    """NumPy leaves of a (nested) dict → torch tensors on the CPU; torch
    leaves stay as they are."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


def _bf16(a: np.ndarray) -> torch.Tensor:
    """fp32 NumPy → torch bf16, rounded to nearest even (as ml_dtypes)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Calibration and SmoothQuant-style smoothing
# ---------------------------------------------------------------------------
#
# Smoothing migrates per-channel activation scale into the producing
# weights, y = (x / s) @ (diag(s) @ W), with s_j = a_j^alpha / w_j^(1-alpha).
# The division by s folds into the per-channel affine that produces x, so it
# costs nothing at run time: LN1 for qkv, LN2 for fc1, and the V slice of
# qkv for out-proj (a context channel is a convex combination of one V
# channel across tokens). fc2's input is a GELU output, which admits no
# exact fold. On the adversarial fixture smoothing alone does not rescue
# W8A8 (the JAX package's tests/test_quant_outlier.py); it stays as an
# exact, composable transform.

# W8A8 GEMM input sites that admit an exact zero-runtime-cost fold.
SMOOTH_SITES = ("qkv", "out", "fc1")


def collect_act_stats(
    images,
    params: Dict[str, Any],
    config: ViTConfig,
    *,
    compute_dtype: torch.dtype = torch.float32,
) -> Dict[str, np.ndarray]:
    """Calibration pass: per-layer per-channel absmax at the four W8A8 GEMM
    inputs, on the params' device, with TF32 off for the pass.

    Mirrors ``vit._attention_block`` and ``vit._mlp_block`` on the ``xla``
    route (fp32 LN statistics, ``xla_attention``, the config's GELU,
    ``matmul_q`` on the stacked weights); the ``features`` key lets tests
    pin this mirror against ``vit.forward_features``.

    Returns {"qkv_in": [L, D], "out_in": [L, D], "fc1_in": [L, D],
    "fc2_in": [L, H], "features": [B, T, D]} (host NumPy, fp32)."""
    from . import vit

    nh, hd, eps = config.num_heads, config.head_dim, config.eps
    dev = params["layers"]["ln1_w"].device
    sites = ("qkv_in", "out_in", "fc1_in", "fc2_in")
    stats: Dict[str, list] = {k: [] for k in sites}

    def chmax(a):
        return a.float().abs().amax(dim=(0, 1))

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            imgs = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
            x = vit.embed(imgs, params, config, compute_dtype)
            if config.pre_norm:
                x = vit.layer_norm(x, params["pre_ln_w"], params["pre_ln_b"], eps)
            b, t, d = x.shape
            for layer in range(config.depth):
                lp = vit._layer(params, layer)
                a1 = vit.layer_norm(x, lp["ln1_w"], lp["ln1_b"], eps)
                qkv = matmul_q(a1, lp["qkv_w"], lp["qkv_b"])
                q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
                ctx = vit.xla_attention(q, k, v, config)
                ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, d)
                x = x + matmul_q(ctx, lp["out_w"], lp["out_b"])
                a2 = vit.layer_norm(x, lp["ln2_w"], lp["ln2_b"], eps)
                hid = vit._gelu(matmul_q(a2, lp["fc1_w"], lp["fc1_b"]), config)
                x = x + matmul_q(hid, lp["fc2_w"], lp["fc2_b"])
                for key, a in zip(sites, (a1, ctx, a2, hid)):
                    stats[key].append(chmax(a))
            feats = vit.layer_norm(x, params["final_ln_w"],
                                   params["final_ln_b"], eps)
            out = {k: torch.stack(v).cpu().numpy() for k, v in stats.items()}
            out["features"] = feats.float().cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def merge_act_stats(a: Dict[str, np.ndarray],
                    b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Elementwise max of two calibration passes (multi-batch calibration)."""
    return {k: np.maximum(a[k], b[k]) for k in a if k != "features"}


def smoothing_scales(
    stats: Dict[str, np.ndarray],
    params: Dict[str, Any],
    alpha: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Per-site smoothing factors s_j = a_j^alpha / w_j^(1-alpha).

    a_j: calibrated activation absmax (``collect_act_stats``); w_j: weight
    absmax over the consuming matmul's input channel j. Clamped to
    [1e-2, 1e4] so dead channels can't zero an LN gain or blow a weight
    row up."""
    lp = params["layers"]

    def w_absmax(w):  # [L, in, out] → per-input-channel absmax [L, in]
        return np.max(np.abs(_host(w)), axis=-1)

    def s_for(a, w):
        a = np.maximum(np.asarray(a, np.float32), 1e-5)
        w = np.maximum(w, 1e-5)
        s = a ** alpha / w ** (1.0 - alpha)
        return np.clip(s, 1e-2, 1e4).astype(np.float32)

    return {
        "qkv": s_for(stats["qkv_in"], w_absmax(lp["qkv_w"])),
        "out": s_for(stats["out_in"], w_absmax(lp["out_w"])),
        "fc1": s_for(stats["fc1_in"], w_absmax(lp["fc1_w"])),
    }


def smooth_stacked_params(
    params: Dict[str, Any],
    scales: Dict[str, np.ndarray],
    sites=SMOOTH_SITES,
) -> Dict[str, Any]:
    """Apply the smoothing equivalence transform (host, fp32): the same fp32
    function up to 1-ulp rounding on the folded affines. Call before
    quantizing. Returns a host pytree."""
    unknown = set(sites) - set(SMOOTH_SITES)
    if unknown:
        raise ValueError(
            f"unsmoothable sites {sorted(unknown)}: only {SMOOTH_SITES} admit "
            f"an exact zero-cost fold (fc2's GELU input does not)")
    out = dict(params)
    lp = {k: _host(v) if k in (
        "ln1_w", "ln1_b", "ln2_w", "ln2_b", "qkv_w", "qkv_b", "out_w",
        "fc1_w") else v for k, v in params["layers"].items()}
    d = lp["out_w"].shape[1]
    if "qkv" in sites:
        s = scales["qkv"]  # [L, D]
        lp["ln1_w"] = lp["ln1_w"] / s
        lp["ln1_b"] = lp["ln1_b"] / s
        lp["qkv_w"] = lp["qkv_w"] * s[:, :, None]
    if "out" in sites:
        s = scales["out"]  # [L, D]
        qkv_w = np.array(lp["qkv_w"])
        qkv_w[:, :, 2 * d:] = qkv_w[:, :, 2 * d:] / s[:, None, :]
        lp["qkv_w"] = qkv_w
        qkv_b = np.array(lp["qkv_b"])
        qkv_b[:, 2 * d:] = qkv_b[:, 2 * d:] / s
        lp["qkv_b"] = qkv_b
        lp["out_w"] = lp["out_w"] * s[:, :, None]
    if "fc1" in sites:
        s = scales["fc1"]  # [L, D]
        lp["ln2_w"] = lp["ln2_w"] / s
        lp["ln2_b"] = lp["ln2_b"] / s
        lp["fc1_w"] = lp["fc1_w"] * s[:, :, None]
    out["layers"] = _as_torch(lp)
    return out


def smooth_for_w8a8(
    images,
    params: Dict[str, Any],
    config: ViTConfig,
    alpha: float = 0.5,
) -> Dict[str, Any]:
    """Calibrate on ``images`` and smooth: the one-call entry point."""
    stats = collect_act_stats(images, params, config)
    return smooth_stacked_params(params, smoothing_scales(stats, params, alpha))


# ---------------------------------------------------------------------------
# Outlier-aware W8A8
# ---------------------------------------------------------------------------
#
# Permutations are exact equivalence transforms here: the residual stream
# admits one global permutation folded into every producer and consumer (LN
# statistics are permutation-invariant); fc1→fc2 a per-layer one (GELU is
# elementwise); V channels per-layer permutations within each head
# (attention mixes tokens, never channels across heads). The hottest
# channels go last, into a group that stays bf16.


@dataclass(frozen=True)
class OutlierPlan:
    """Channel permutations and group widths for outlier-aware W8A8.

    ``perm_d``: [D] global residual-stream permutation (hot channels last).
    ``perm_h``: [L, H] per-layer fc1-output permutation (hot last).
    ``perm_v``: [L, D] per-layer within-head V permutation (hot at each
    head's tail).
    ``k_d``: trailing bf16 group width of the qkv and fc1 GEMM inputs.
    ``k_h``: trailing bf16 group width of the fc2 GEMM input.
    ``kh``: per-head bf16 tail width of the out-proj GEMM input.
    """

    perm_d: np.ndarray
    perm_h: np.ndarray
    perm_v: np.ndarray
    k_d: int
    k_h: int
    kh: int


def _group_width(c: int) -> int:
    """Default trailing-group width: 128 when the dimension affords it,
    else an eighth (small test configs)."""
    return 128 if c >= 512 else max(4, c // 8)


def plan_outliers(
    stats: Dict[str, np.ndarray],
    config: ViTConfig,
    *,
    k_d: Optional[int] = None,
    k_h: Optional[int] = None,
    kh: Optional[int] = None,
) -> OutlierPlan:
    """Build the permutation plan from calibration stats (hot channels
    last). The residual-stream permutation pools the qkv and fc1 input
    stats over layers, each layer median-normalised so one hot layer can't
    drown the rest."""
    d, h, nhd = config.embed_dim, config.hidden_dim, config.head_dim
    nh = config.num_heads
    k_d = _group_width(d) if k_d is None else int(k_d)
    k_h = _group_width(h) if k_h is None else int(k_h)
    kh = max(2, nhd // 8) if kh is None else int(kh)
    if not (0 < k_d < d and 0 < k_h < h and 0 < kh < nhd):
        raise ValueError(f"bad outlier group widths k_d={k_d} k_h={k_h} kh={kh}")

    def norm(a):  # [L, C] -> per-layer median-normalized
        return a / np.maximum(np.median(a, axis=-1, keepdims=True), 1e-12)

    pool = np.maximum(norm(stats["qkv_in"]).max(0), norm(stats["fc1_in"]).max(0))
    perm_d = np.argsort(pool, kind="stable")
    perm_h = np.argsort(stats["fc2_in"], axis=-1, kind="stable")
    L = stats["out_in"].shape[0]
    perm_v = np.zeros((L, d), np.int64)
    for layer in range(L):
        per_head = stats["out_in"][layer].reshape(nh, nhd)
        for head in range(nh):
            perm_v[layer, head * nhd:(head + 1) * nhd] = (
                head * nhd + np.argsort(per_head[head], kind="stable"))
    return OutlierPlan(perm_d=perm_d, perm_h=perm_h, perm_v=perm_v,
                       k_d=k_d, k_h=k_h, kh=kh)


def apply_outlier_plan(params: Dict[str, Any], plan: OutlierPlan,
                       config: ViTConfig) -> Dict[str, Any]:
    """Fold the plan's permutations into the fp params (host fp32, exact):
    the returned host pytree computes the identical function; only the
    channel order of internal bases changes. Apply before
    ``quantize_stacked_params_outlier``."""
    P, Ph, Pv = plan.perm_d, plan.perm_h, plan.perm_v
    d = config.embed_dim
    L = config.depth
    f32 = _host

    out = dict(params)
    out["patch_w"] = f32(params["patch_w"])[:, P]
    out["patch_b"] = f32(params["patch_b"])[P]
    out["pos_emb"] = f32(params["pos_emb"])[:, P]
    out["prefix_tokens"] = f32(params["prefix_tokens"])[:, P]
    out["final_ln_w"] = f32(params["final_ln_w"])[P]
    out["final_ln_b"] = f32(params["final_ln_b"])[P]
    if "pre_ln_w" in params:
        out["pre_ln_w"] = f32(params["pre_ln_w"])[P]
        out["pre_ln_b"] = f32(params["pre_ln_b"])[P]
    if "head_w" in params:
        out["head_w"] = f32(params["head_w"])[P, :]
    if "head_dist_w" in params:
        out["head_dist_w"] = f32(params["head_dist_w"])[P, :]

    lp = {k: f32(v) for k, v in params["layers"].items()}
    for key in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "out_b", "fc2_b"):
        lp[key] = lp[key][:, P]
    lp["qkv_w"] = lp["qkv_w"][:, P, :]
    lp["fc1_w"] = lp["fc1_w"][:, P, :]
    lp["out_w"] = lp["out_w"][:, :, P]
    lp["fc2_w"] = lp["fc2_w"][:, :, P]
    # per-layer fc1->fc2 permutation (GELU is elementwise: exact)
    lp["fc1_w"] = np.take_along_axis(lp["fc1_w"], Ph[:, None, :], axis=2)
    lp["fc1_b"] = np.take_along_axis(lp["fc1_b"], Ph, axis=1)
    lp["fc2_w"] = np.stack([lp["fc2_w"][layer][Ph[layer], :]
                            for layer in range(L)])
    # per-layer within-head V permutation (attention never mixes channels)
    vcols = lp["qkv_w"][:, :, 2 * d:]
    lp["qkv_w"] = np.concatenate(
        [lp["qkv_w"][:, :, :2 * d],
         np.take_along_axis(vcols, Pv[:, None, :], axis=2)], axis=2)
    lp["qkv_b"] = np.concatenate(
        [lp["qkv_b"][:, :2 * d],
         np.take_along_axis(lp["qkv_b"][:, 2 * d:], Pv, axis=1)], axis=1)
    lp["out_w"] = np.stack([lp["out_w"][layer][Pv[layer], :]
                            for layer in range(L)])
    out["layers"] = lp
    return _as_torch(out)


def _tail_mask(config: ViTConfig, kh: int) -> np.ndarray:
    """bool [D]: True on each head's trailing ``kh`` context channels."""
    return _tail_mask_heads(config.num_heads, config.head_dim, kh)


def _split_weight(w, k: int) -> Dict[str, torch.Tensor]:
    """[..., in, out] fp → int8 dict for rows [:-k] + bf16 "hi" rows [-k:]."""
    w = _host(w)
    lo = _as_torch(quantize_weight(w[..., :-k, :] if k else w))
    lo["hi"] = _bf16(w[..., w.shape[-2] - k:, :])
    return lo


def _masked_weight(w, mask: np.ndarray) -> Dict[str, torch.Tensor]:
    """[..., D, out] fp → int8 dict with the masked rows zeroed + bf16 "hi"
    holding exactly the masked rows (per-head tail order)."""
    w = _host(w)
    w_lo = np.array(w)
    w_lo[..., mask, :] = 0.0
    out = _as_torch(quantize_weight(w_lo))
    out["hi"] = _bf16(w[..., mask, :])
    return out


def quantize_stacked_params_outlier(
    params: Dict[str, Any], config: ViTConfig, plan: OutlierPlan
) -> Dict[str, Any]:
    """Quantize plan-permuted params with the bf16 outlier groups split out
    (host pytree). qkv and fc1 keep their trailing ``k_d`` input rows in
    bf16, fc2 its trailing ``k_h``; out-proj holds its per-head tails
    (``kh`` per head) as "hi" with the matching int8 rows zeroed. The patch
    embedding and the head quantize weight-only, as in
    ``quantize_stacked_params``. The encoder's int8 weights come K-major
    (``w8a8_layout``): only the W8A8 path takes outlier-aware params."""
    out = dict(params)
    for key in _TOP_MATMUL_KEYS:
        if key in out:
            out[key] = _as_torch(quantize_weight(_host(out[key])))
    layers = dict(params["layers"])
    layers["qkv_w"] = _split_weight(layers["qkv_w"], plan.k_d)
    layers["fc1_w"] = _split_weight(layers["fc1_w"], plan.k_d)
    layers["fc2_w"] = _split_weight(layers["fc2_w"], plan.k_h)
    layers["out_w"] = _masked_weight(layers["out_w"], _tail_mask(config, plan.kh))
    out["layers"] = layers
    return w8a8_layout(_as_torch(out))


def calibrate_w8a8(
    images,
    params: Dict[str, Any],
    config: ViTConfig,
    **plan_kw,
) -> Dict[str, Any]:
    """One-call outlier-aware quantization: calibrate (on the params'
    device) → plan → permute → quantize (on the host). ``params`` are fp
    stacked params; the result is a host pytree for ``vit.params_to``."""
    stats = collect_act_stats(images, params, config)
    plan = plan_outliers(stats, config, **plan_kw)
    permuted = apply_outlier_plan(params, plan, config)
    return quantize_stacked_params_outlier(permuted, config, plan)


# --- device twins: the permute and quantize on the params' own device -------


def apply_outlier_plan_device(params: Dict[str, Any], plan: OutlierPlan,
                              config: ViTConfig) -> Dict[str, Any]:
    """Torch twin of ``apply_outlier_plan`` on the params' device. The big
    weights permute in their stored dtype (gathers are exact; the quantizer
    casts later)."""
    dev = params["layers"]["qkv_w"].device

    def idx(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

    P, Ph, Pv = idx(plan.perm_d), idx(plan.perm_h), idx(plan.perm_v)

    def f32(a):
        return a.float()

    out = dict(params)
    out["patch_w"] = params["patch_w"][:, P]
    out["patch_b"] = f32(params["patch_b"])[P]
    out["pos_emb"] = f32(params["pos_emb"])[:, P]
    out["prefix_tokens"] = f32(params["prefix_tokens"])[:, P]
    out["final_ln_w"] = f32(params["final_ln_w"])[P]
    out["final_ln_b"] = f32(params["final_ln_b"])[P]
    if "pre_ln_w" in params:
        out["pre_ln_w"] = f32(params["pre_ln_w"])[P]
        out["pre_ln_b"] = f32(params["pre_ln_b"])[P]
    if "head_w" in params:
        out["head_w"] = params["head_w"][P, :]
    if "head_dist_w" in params:
        out["head_dist_w"] = params["head_dist_w"][P, :]

    d = config.embed_dim
    lp = dict(params["layers"])
    for key in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "out_b", "fc2_b"):
        lp[key] = f32(lp[key])[:, P]
    lp["qkv_w"] = lp["qkv_w"][:, P, :]
    lp["fc1_w"] = lp["fc1_w"][:, P, :]
    lp["out_w"] = lp["out_w"][:, :, P]
    lp["fc2_w"] = lp["fc2_w"][:, :, P]
    lp["fc1_w"] = torch.take_along_dim(lp["fc1_w"], Ph[:, None, :], dim=2)
    lp["fc1_b"] = torch.take_along_dim(f32(lp["fc1_b"]), Ph, dim=1)
    lp["fc2_w"] = torch.take_along_dim(lp["fc2_w"], Ph[:, :, None], dim=1)
    vcols = torch.take_along_dim(lp["qkv_w"][:, :, 2 * d:], Pv[:, None, :],
                                 dim=2)
    lp["qkv_w"] = torch.cat([lp["qkv_w"][:, :, :2 * d], vcols], dim=2)
    qkv_b = f32(lp["qkv_b"])
    lp["qkv_b"] = torch.cat(
        [qkv_b[:, :2 * d], torch.take_along_dim(qkv_b[:, 2 * d:], Pv, dim=1)],
        dim=1)
    lp["out_w"] = torch.take_along_dim(lp["out_w"], Pv[:, :, None], dim=1)
    out["layers"] = lp
    return out


def _split_weight_device(w: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    wf = w.float()
    lo = quantize_weight_device(wf[..., :-k, :] if k else wf)
    lo["hi"] = wf[..., wf.shape[-2] - k:, :].to(torch.bfloat16)
    return lo


def _masked_weight_device(w: torch.Tensor,
                          mask: np.ndarray) -> Dict[str, torch.Tensor]:
    wf = w.float()
    keep = torch.from_numpy(~mask).to(device=w.device,
                                      dtype=torch.float32)[:, None]
    out = quantize_weight_device(wf * keep)
    rows = torch.from_numpy(np.where(mask)[0]).to(w.device)
    out["hi"] = wf[..., rows, :].to(torch.bfloat16)
    return out


def quantize_stacked_params_outlier_device(
    params: Dict[str, Any], config: ViTConfig, plan: OutlierPlan
) -> Dict[str, Any]:
    """Torch twin of ``quantize_stacked_params_outlier`` on the params'
    device (the int8 weights K-major too)."""
    out = dict(params)
    for key in _TOP_MATMUL_KEYS:
        if key in out:
            out[key] = quantize_weight_device(out[key])
    layers = dict(params["layers"])
    layers["qkv_w"] = _split_weight_device(layers["qkv_w"], plan.k_d)
    layers["fc1_w"] = _split_weight_device(layers["fc1_w"], plan.k_d)
    layers["fc2_w"] = _split_weight_device(layers["fc2_w"], plan.k_h)
    layers["out_w"] = _masked_weight_device(
        layers["out_w"], _tail_mask(config, plan.kh))
    out["layers"] = layers
    return w8a8_layout(out)


def calibrate_w8a8_device(
    images,
    params: Dict[str, Any],
    config: ViTConfig,
    **plan_kw,
) -> Dict[str, Any]:
    """Device twin of ``calibrate_w8a8``: the calibration forward and the
    permute and quantize all run on the params' device; only the [L, D]
    stats come to the host, to build the plan."""
    stats = collect_act_stats(images, params, config)
    plan = plan_outliers(stats, config, **plan_kw)
    with torch.no_grad():
        return quantize_stacked_params_outlier_device(
            apply_outlier_plan_device(params, plan, config), config, plan)

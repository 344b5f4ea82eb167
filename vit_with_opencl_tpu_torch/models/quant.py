"""int8 quantization: weight-only (per output channel) and W8A8.

Counterpart of ``vit_with_opencl_tpu/models/quant.py``. Matmul weights are
stored as int8 with one fp32 scale per output channel. Because the scale is
per *output* channel it commutes out of the product:

    y = (x @ dequant(Wq))  ==  (x @ Wq.to(x.dtype)) * scale

so weight-only int8 keeps the activation-dtype GEMM with a scale epilogue
(``matmul_q``). W8A8 also quantizes the activation per token at run time
(``quantize_act``) and runs int8 x int8 with exact integer accumulation,
then one fp32 epilogue ``acc * s_x * s_w`` (``matmul_w8a8``).

Layout: stacked weights are right-multiply ``[..., in, out]``; scales are
``[..., 1, out]``, so slicing one layer off the stack works on both.

``quantize_act`` is the plain version of the quantize kernel
(``ops/quantize.py``, ``csrc/quantize.cu``); ``matmul_q`` and
``matmul_w8a8`` are the per-op ``xla`` route, which the JAX package leaves
to XLA. Not ported yet: the calibrated outlier-aware forms (``"hi"`` groups)
and SmoothQuant smoothing, ROADMAP.md Queue 2 item 2.
"""

from __future__ import annotations

from typing import Any, Dict

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

_OUTLIER_NOT_PORTED = (
    "outlier-aware W8A8 (weight dicts with a bf16 'hi' group) is not ported "
    "yet: ROADMAP.md, Queue 2 item 2")


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


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [..., K] int8 @ wq [K, N] int8 → the exact integer sums as fp32.

    The sums run in float64, exact below 2⁵³ (|sum| <= K·127² ≈ 5e7 at
    K = 3072), and are rounded once to fp32, as an int32 accumulator
    converted to float is. PyTorch has no int8 matmul on every device."""
    return (xq.double() @ wq.double()).float()


def refuse_outliers(w: Dict[str, Any]) -> None:
    """Raise for an outlier-aware weight dict, whose form is not ported."""
    if "hi" in w:
        raise NotImplementedError(_OUTLIER_NOT_PORTED)


def matmul_w8a8(x: torch.Tensor, w: Any, b: Any, heads=None) -> torch.Tensor:
    """W8A8 dynamic matmul: per-token int8 x × int8 weights, exact integer
    sums, then ``acc · s_x · s_w (+ b)`` in fp32, cast to x's dtype.

    fp weights fall back to ``matmul_q``, as in the JAX package. ``heads``
    only matters for the masked outlier form, which is not ported."""
    if not is_quantized(w):
        return matmul_q(x, w, b)
    if w["q"].dim() != 2:
        raise ValueError(
            f"matmul_w8a8 expects a single layer's 2D weight, got q shape "
            f"{tuple(w['q'].shape)}")
    refuse_outliers(w)
    xq, sx = quantize_act(x)
    out = int8_product(xq, w["q"]) * sx * w["scale"][..., 0, :]
    if b is not None:
        out = out + b
    return out.to(x.dtype)


def matmul_q(x: torch.Tensor, w: Any, b: Any) -> torch.Tensor:
    """Quantization-aware matmul for fp and int8 weights, fp32 accumulation.

    int8 weights are cast to x's dtype (exact: |q| <= 127) and the
    per-channel scale multiplies the fp32 product; result in x's dtype."""
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

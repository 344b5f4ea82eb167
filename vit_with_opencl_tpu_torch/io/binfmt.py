"""The reference's on-disk formats: packed image binaries and per-tensor weights.

Image format (reference: Network.c:26-109 ``load_image_data``):
    header of 4 little-endian int32 ``(n, c, h, w)`` followed by ``n*c*h*w``
    float32 values in NCHW order.

Weight format (reference: Network.c:134-218 ``load_weights``):
    a directory of files named ``Weight_<idx>_<name>.bin``, each a raw float32
    array. The loader scans the directory, parses ``<idx>`` from the filename
    (Network.c:111-132), and stores tensors positionally. At load time every
    value is rounded to 6 decimal places (Network.c:208-211) — this is part of
    observed behavior (it shifts golden probabilities), so it is reproduced
    here behind a flag that defaults on.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import ViTConfig

_HEADER_DTYPE = np.dtype("<i4")
_DATA_DTYPE = np.dtype("<f4")

_WEIGHT_RE = re.compile(r"^Weight_(\d+)_(.+)\.bin$")


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------


def load_image_data(path: str | os.PathLike) -> np.ndarray:
    """Read a packed image binary; returns float32 array of shape (n, c, h, w).

    Mirrors ``load_image_data`` (reference: Network.c:26-109), minus the
    per-image struct copies — the batch stays one contiguous array.
    """
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_HEADER_DTYPE, count=4)
        if header.size != 4:
            raise ValueError(f"{path}: truncated header (needed 4 int32)")
        n, c, h, w = (int(x) for x in header)
        if min(n, c, h, w) <= 0:
            raise ValueError(f"{path}: bad header {tuple(header)}")
        data = np.fromfile(f, dtype=_DATA_DTYPE, count=n * c * h * w)
    if data.size != n * c * h * w:
        raise ValueError(
            f"{path}: expected {n * c * h * w} floats, got {data.size}"
        )
    return data.reshape(n, c, h, w)


def save_image_data(path: str | os.PathLike, images: np.ndarray) -> None:
    """Write images (n, c, h, w) in the reference's packed binary format."""
    if images.ndim != 4:
        raise ValueError(f"expected (n, c, h, w), got shape {images.shape}")
    with open(path, "wb") as f:
        np.asarray(images.shape, dtype=_HEADER_DTYPE).tofile(f)
        np.ascontiguousarray(images, dtype=_DATA_DTYPE).tofile(f)


# ---------------------------------------------------------------------------
# Weight index map
# ---------------------------------------------------------------------------

_PER_LAYER_KEYS = (
    "ln_1_weight",
    "ln_1_bias",
    "self_attention_in_proj_weight",
    "self_attention_in_proj_bias",
    "self_attention_out_proj_weight",
    "self_attention_out_proj_bias",
    "ln_2_weight",
    "ln_2_bias",
    "mlp_0_weight",
    "mlp_0_bias",
    "mlp_3_weight",
    "mlp_3_bias",
)


def weight_names(config: ViTConfig) -> List[str]:
    """Positional index → tensor name, the reference's naming scheme.

    Index map (reference: ViT_seq.c:437-513 wiring; names are torchvision
    ``vit_b_16`` state-dict keys as seen in the shipped ``Network/`` dir):
      0 class_token, 1 conv_proj_weight, 2 conv_proj_bias,
      3 encoder_pos_embedding, then 12 per layer L at base 4+12L,
      then encoder_ln_{weight,bias}, heads_head_{weight,bias}.
    """
    names = [
        "class_token",
        "conv_proj_weight",
        "conv_proj_bias",
        "encoder_pos_embedding",
    ]
    for layer in range(config.depth):
        prefix = f"encoder_layers_encoder_layer_{layer}_"
        names.extend(prefix + k for k in _PER_LAYER_KEYS)
    names.extend(["encoder_ln_weight", "encoder_ln_bias"])
    if config.head_type != "none":
        names.extend(["heads_head_weight", "heads_head_bias"])
    # Extensions beyond the reference format (DeiT / CLIP presets): appended
    # past the reference's positional range so indices 0..151 stay
    # bit-compatible with the reference layout.
    if config.num_prefix_tokens > 1:
        names.append("dist_token")
        if config.head_type == "cls+dist":
            names.extend(["heads_head_dist_weight", "heads_head_dist_bias"])
    if config.pre_norm:
        names.extend(["encoder_pre_ln_weight", "encoder_pre_ln_bias"])
    return names


def weight_shapes(config: ViTConfig) -> Dict[str, Tuple[int, ...]]:
    """Tensor name → shape. Weight matrices are PyTorch-layout ``[out, in]``
    (reference reads ``weight[o*in_features + i]`` — ViT_seq.c:304, ll.cl:47)."""
    d, h = config.embed_dim, config.hidden_dim
    shapes: Dict[str, Tuple[int, ...]] = {
        "class_token": (d,),
        "conv_proj_weight": (d, config.in_chans, config.patch_size, config.patch_size),
        "conv_proj_bias": (d,),
        "encoder_pos_embedding": (config.num_tokens, d),
    }
    for layer in range(config.depth):
        prefix = f"encoder_layers_encoder_layer_{layer}_"
        shapes.update(
            {
                prefix + "ln_1_weight": (d,),
                prefix + "ln_1_bias": (d,),
                prefix + "self_attention_in_proj_weight": (3 * d, d),
                prefix + "self_attention_in_proj_bias": (3 * d,),
                prefix + "self_attention_out_proj_weight": (d, d),
                prefix + "self_attention_out_proj_bias": (d,),
                prefix + "ln_2_weight": (d,),
                prefix + "ln_2_bias": (d,),
                prefix + "mlp_0_weight": (h, d),
                prefix + "mlp_0_bias": (h,),
                prefix + "mlp_3_weight": (d, h),
                prefix + "mlp_3_bias": (d,),
            }
        )
    shapes["encoder_ln_weight"] = (d,)
    shapes["encoder_ln_bias"] = (d,)
    if config.head_type != "none":
        shapes["heads_head_weight"] = (config.num_classes, d)
        shapes["heads_head_bias"] = (config.num_classes,)
    if config.num_prefix_tokens > 1:
        shapes["dist_token"] = (d,)
    if config.head_type == "cls+dist":
        shapes["heads_head_dist_weight"] = (config.num_classes, d)
        shapes["heads_head_dist_bias"] = (config.num_classes,)
    if config.pre_norm:
        shapes["encoder_pre_ln_weight"] = (d,)
        shapes["encoder_pre_ln_bias"] = (d,)
    return shapes


def parse_index_from_filename(filename: str) -> Optional[Tuple[int, str]]:
    """``Weight_<idx>_<name>.bin`` → (idx, name), else None.

    Mirrors ``parse_index_from_filename`` (reference: Network.c:111-132)."""
    m = _WEIGHT_RE.match(filename)
    if not m:
        return None
    return int(m.group(1)), m.group(2)


def round_6dp(x: np.ndarray) -> np.ndarray:
    """``roundf(x * 1e6f) / 1e6f`` in float32, half away from zero.

    The reference rounds every weight to 6 decimals at load time
    (Network.c:208-211). C's ``roundf`` rounds half away from zero, which
    differs from numpy's round-half-even, so it is spelled out explicitly.
    """
    x = np.asarray(x, dtype=np.float32)
    scaled = (x * np.float32(1e6)).astype(np.float64)  # f32 multiply, exact widen
    rounded = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return (rounded.astype(np.float32)) / np.float32(1e6)


def load_weights(
    directory: str | os.PathLike,
    config: ViTConfig | None = None,
    *,
    count: Optional[int] = None,
    round_to_6dp: bool = True,
    strict: bool = False,
) -> Dict[int, np.ndarray]:
    """Scan ``directory`` for ``Weight_<idx>_*.bin``; return {idx: float32 array}.

    Mirrors ``load_weights`` (reference: Network.c:134-218): directory scan,
    index parse, raw float32 read, optional 6-decimal rounding. Unlike the
    reference (which silently leaves missing indices NULL), ``strict=True``
    raises if any index in [0, count) is absent.
    """
    if config is not None and count is None:
        count = len(weight_names(config))
    out: Dict[int, np.ndarray] = {}
    for entry in sorted(os.listdir(directory)):
        parsed = parse_index_from_filename(entry)
        if parsed is None:
            continue
        idx, _name = parsed
        if count is not None and not (0 <= idx < count):
            continue
        arr = np.fromfile(os.path.join(directory, entry), dtype=_DATA_DTYPE)
        if round_to_6dp:
            arr = round_6dp(arr)
        out[idx] = arr
    if strict and count is not None:
        missing = sorted(set(range(count)) - set(out))
        if missing:
            raise FileNotFoundError(f"{directory}: missing weight indices {missing}")
    return out


def save_weights(
    directory: str | os.PathLike,
    tensors: Sequence[np.ndarray],
    config: ViTConfig,
) -> None:
    """Write tensors positionally as ``Weight_<idx>_<name>.bin`` (the format
    the reference's offline torchvision export produced)."""
    names = weight_names(config)
    if len(tensors) != len(names):
        raise ValueError(f"expected {len(names)} tensors, got {len(tensors)}")
    os.makedirs(directory, exist_ok=True)
    for idx, (name, tensor) in enumerate(zip(names, tensors)):
        path = os.path.join(directory, f"Weight_{idx}_{name}.bin")
        np.ascontiguousarray(tensor, dtype=_DATA_DTYPE).tofile(path)


def weights_to_dict(
    weights: Dict[int, np.ndarray], config: ViTConfig, *, reshape: bool = True
) -> Dict[str, np.ndarray]:
    """Positional {idx: flat array} → {name: shaped array}."""
    names = weight_names(config)
    shapes = weight_shapes(config)
    out = {}
    for idx, arr in weights.items():
        name = names[idx]
        if reshape and name in shapes:
            expected = int(np.prod(shapes[name]))
            if arr.size != expected:
                raise ValueError(
                    f"weight {idx} ({name}): expected {expected} elements "
                    f"({shapes[name]}), got {arr.size}"
                )
            arr = arr.reshape(shapes[name])
        out[name] = arr
    return out

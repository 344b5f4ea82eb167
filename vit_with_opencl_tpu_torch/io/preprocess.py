"""Image preprocessing: raw images → the packed normalized-tensor format.

Counterpart of ``vit_with_opencl_tpu/io/preprocess.py``. The reference
consumes pre-normalized NCHW float32 tensors produced offline (its
``Data/input-*.bin`` values are standard torchvision ImageNet preprocessing
outputs: resize-256 shorter side, center-crop 224, scale to [0,1],
normalize with the ImageNet mean/std). This module is that offline stage, so
users can go from image files to ``input.bin`` (or straight to the CLI's
``--raw-images``) without leaving the framework.

PIL is used when available (bilinear resize matching torchvision's default);
a pure-NumPy fallback resizes uint8 arrays without it. Decoding files
(``preprocess_files``) needs PIL.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def uint8_normalize_constants(device: torch.device | str = "cpu") -> tuple:
    """(mean, inv_std) as [1, 3, 1, 1] fp32 tensors on ``device`` for the
    normalization of raw uint8 pixels there: x_norm = (x - mean) * inv_std.

    The one definition both inference engines use for the uint8 wire mode
    (4x less host-to-device transfer)."""
    mean = torch.from_numpy(IMAGENET_MEAN.reshape(1, 3, 1, 1) * 255.0)
    inv_std = torch.from_numpy(1.0 / (IMAGENET_STD.reshape(1, 3, 1, 1) * 255.0))
    return mean.to(device), inv_std.to(device)


def _resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pure-NumPy bilinear resize, HWC uint8/float → float32 HWC."""
    h, w = img.shape[:2]
    img = img.astype(np.float32)
    # align_corners=False convention (matches PIL/torchvision closely enough
    # for classification preprocessing).
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def preprocess_array(
    img: np.ndarray,
    img_size: int = 224,
    resize_size: Optional[int] = None,
    *,
    mean: np.ndarray = IMAGENET_MEAN,
    std: np.ndarray = IMAGENET_STD,
) -> np.ndarray:
    """HWC uint8 (or float [0,255]) → normalized CHW float32.

    torchvision classification preprocessing: resize shorter side to
    ``resize_size`` (bilinear; default scales the classic 256-for-224 ratio
    to the target size), center-crop ``img_size``, scale to [0,1], normalize
    per channel.
    """
    if resize_size is None:
        resize_size = round(img_size * 256 / 224)
    if resize_size < img_size:
        raise ValueError(
            f"resize_size {resize_size} < img_size {img_size}: the center "
            f"crop would silently truncate (use resize_size ~= img_size*256/224)"
        )
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    h, w = img.shape[:2]
    if h < w:
        new_h, new_w = resize_size, max(1, round(w * resize_size / h))
    else:
        new_h, new_w = max(1, round(h * resize_size / w)), resize_size
    if img.dtype == np.uint8:
        try:
            from PIL import Image

            pil = Image.fromarray(img)
            pil = pil.resize((new_w, new_h), Image.BILINEAR)
            resized = np.asarray(pil, np.float32)
        except ImportError:
            resized = _resize_bilinear_np(img, new_h, new_w)
    else:
        # Float input: resize at full precision (PIL would truncate to uint8
        # and wrap values > 255, silently changing the tensor).
        resized = _resize_bilinear_np(np.clip(img, 0.0, 255.0), new_h, new_w)
    top = (new_h - img_size) // 2
    left = (new_w - img_size) // 2
    crop = resized[top : top + img_size, left : left + img_size]
    crop = crop / np.float32(255.0)
    crop = (crop - mean) / std
    return crop.transpose(2, 0, 1).astype(np.float32)  # CHW


def preprocess_files(
    paths: Sequence[str | os.PathLike],
    img_size: int = 224,
    resize_size: Optional[int] = None,
) -> np.ndarray:
    """Image files → batch [n, 3, img_size, img_size] float32 (requires PIL)."""
    from PIL import Image

    out: List[np.ndarray] = []
    for p in paths:
        with Image.open(p) as im:
            arr = np.asarray(im.convert("RGB"))
        out.append(preprocess_array(arr, img_size, resize_size))
    return np.stack(out)


def images_to_input_bin(
    paths: Sequence[str | os.PathLike],
    out_path: str | os.PathLike,
    img_size: int = 224,
    resize_size: Optional[int] = None,
) -> np.ndarray:
    """Image files → a reference-format ``input.bin`` (header + NCHW fp32)."""
    from . import binfmt

    batch = preprocess_files(paths, img_size, resize_size)
    binfmt.save_image_data(out_path, batch)
    return batch

"""Training-time data augmentation on the host: the input side of the ViT/DeiT
recipe.

Counterpart of ``vit_with_opencl_tpu/augment.py``. The host half is the same
NumPy code, so for the same seed it gives the same bits:

- :func:`random_resized_crop`: torchvision ``RandomResizedCrop`` semantics
  (10 area/ratio attempts, center fallback).
- :func:`random_hflip`: ``RandomHorizontalFlip``.
- :func:`rand_augment`: a RandAugment set (photometric ops in PIL's
  conventions and center-origin affines with gray fill), magnitude M in
  [0, 10] as in the paper and timm.
- :func:`mixup_cutmix`: batch Mixup/CutMix with *soft labels* (the DeiT
  regularizers), for the soft-label loss of ``parallel.spmd.make_train_step``.
- :func:`augmented_dataset`: the composition, a drop-in replacement for
  :func:`data.memory_dataset` that yields normalized NCHW batches and soft
  labels for :class:`data.DevicePrefetcher`.

The batch mix also runs on the card: :func:`draw_mix_params` draws its few
numbers on the host from a ``torch.Generator``, :func:`apply_mixup_cutmix`
applies them to a batch wherever it lies without reading anything back, and
:func:`device_mixup_cutmix` composes the two (``Trainer(mixup=...)``).

Every function takes an explicit ``numpy.random.Generator`` (or seed) or
``torch.Generator``; nothing touches a global random state.
"""
from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .io.preprocess import IMAGENET_MEAN, IMAGENET_STD, _resize_bilinear_np

__all__ = [
    "random_resized_crop",
    "random_hflip",
    "rand_augment",
    "RAND_AUGMENT_OPS",
    "mixup_cutmix",
    "MixParams",
    "draw_mix_params",
    "apply_mixup_cutmix",
    "device_mixup_cutmix",
    "augmented_dataset",
    "resize_backend",
]


# ---------------------------------------------------------------------------
# Geometric: RandomResizedCrop / flip
# ---------------------------------------------------------------------------


def resize_backend() -> str:
    """"PIL" where PIL imports (uint8 crops are resized and warped by its C
    code), else "NumPy" (the bilinear fallback of :func:`_resize` and
    :func:`_affine`)."""
    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return "NumPy"
    return "PIL"


def _resize(img: np.ndarray, out_size: int) -> np.ndarray:
    """Bilinear square resize → float32 HWC. uint8 goes through PIL (the
    torchvision backend) where it imports."""
    if img.dtype == np.uint8:
        try:
            from PIL import Image

            pil = Image.fromarray(np.ascontiguousarray(img))
            return np.asarray(
                pil.resize((out_size, out_size), Image.BILINEAR), np.float32
            )
        except ImportError:
            pass
    return _resize_bilinear_np(img, out_size, out_size)


def random_resized_crop(
    rng: np.random.Generator,
    img: np.ndarray,
    out_size: int,
    *,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """torchvision ``RandomResizedCrop`` on an HWC image → float32 HWC.

    Samples a crop area uniformly in ``scale``×(image area) and an aspect
    ratio log-uniformly in ``ratio``; after 10 failed attempts falls back
    to the largest in-ratio center crop (torchvision's documented
    fallback). Resize is bilinear.
    """
    h, w = img.shape[:2]
    area = float(h * w)
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = img[top : top + ch, left : left + cw]
            return _resize(crop, out_size)
    # Fallback: center crop at the nearest in-range ratio.
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, min(h, int(round(w / ratio[0])))
    elif in_ratio > ratio[1]:
        cw, ch = min(w, int(round(h * ratio[1]))), h
    else:
        cw, ch = w, h
    top = (h - ch) // 2
    left = (w - cw) // 2
    crop = img[top : top + ch, left : left + cw]
    return _resize(crop, out_size)


def random_hflip(
    rng: np.random.Generator, img: np.ndarray, p: float = 0.5
) -> np.ndarray:
    """Horizontal flip with probability ``p`` (HWC; width is axis 1)."""
    if p > 0.0 and rng.random() < p:
        return img[:, ::-1]
    return img


# ---------------------------------------------------------------------------
# Photometric / affine ops (RandAugment set, PIL conventions on uint8 HWC)
# ---------------------------------------------------------------------------

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)  # PIL L-mode weights


def _to_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def _blend(img: np.ndarray, other: np.ndarray, factor: float) -> np.ndarray:
    """PIL ``ImageEnhance`` blend: other + factor*(img - other)."""
    out = other.astype(np.float32) + factor * (
        img.astype(np.float32) - other.astype(np.float32)
    )
    return _to_u8(out)


def _autocontrast(img: np.ndarray, _m: float) -> np.ndarray:
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi <= lo:
            out[..., c] = ch
        else:
            out[..., c] = _to_u8(
                (ch.astype(np.float32) - lo) * (255.0 / (hi - lo))
            )
    return out


def _equalize(img: np.ndarray, _m: float) -> np.ndarray:
    """PIL ``ImageOps.equalize``: per-channel histogram equalization with
    PIL's step/offset lut construction."""
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        hist = np.bincount(ch.reshape(-1), minlength=256)
        nonzero = hist[hist > 0]
        if nonzero.size <= 1:
            out[..., c] = ch
            continue
        step = (hist.sum() - nonzero[-1]) // 255
        if step == 0:
            out[..., c] = ch
            continue
        lut = (np.cumsum(hist) - hist + step // 2) // step
        out[..., c] = np.clip(lut, 0, 255).astype(np.uint8)[ch]
    return out


def _posterize(img: np.ndarray, bits: float) -> np.ndarray:
    b = int(round(bits))
    if b >= 8:
        return img
    mask = np.uint8(256 - (1 << (8 - b)))
    return img & mask


def _solarize(img: np.ndarray, threshold: float) -> np.ndarray:
    return np.where(img >= threshold, 255 - img, img)


def _brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, np.zeros_like(img), factor)


def _contrast(img: np.ndarray, factor: float) -> np.ndarray:
    gray = img.astype(np.float32) @ _GRAY
    mean = np.full_like(img, _to_u8(np.full((), gray.mean())))
    return _blend(img, mean, factor)


def _color(img: np.ndarray, factor: float) -> np.ndarray:
    gray = _to_u8(img.astype(np.float32) @ _GRAY)[..., None]
    return _blend(img, np.broadcast_to(gray, img.shape), factor)


def _sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """PIL SMOOTH-kernel blend ([[1,1,1],[1,5,1],[1,1,1]]/13, border kept)."""
    f = img.astype(np.float32)
    pad = np.pad(f, ((1, 1), (1, 1), (0, 0)), mode="edge")
    sm = (
        pad[:-2, :-2] + pad[:-2, 1:-1] + pad[:-2, 2:]
        + pad[1:-1, :-2] + 5.0 * f + pad[1:-1, 2:]
        + pad[2:, :-2] + pad[2:, 1:-1] + pad[2:, 2:]
    ) / 13.0
    sm[0], sm[-1], sm[:, 0], sm[:, -1] = f[0], f[-1], f[:, 0], f[:, -1]
    return _blend(img, _to_u8(sm), factor)


def _affine(img: np.ndarray, mat: Sequence[float], fill: float = 128.0):
    """Bilinear affine warp about the image center (torchvision
    ``F.affine`` convention): ``mat`` is the 2×3 *inverse* map from output
    (x, y) to input (x, y), out-of-bounds filled with gray.

    uint8 images route through PIL's C affine (the torchvision backend;
    the producer thread must keep up with the card); PIL's sample grid puts
    pixel centers at integer+0.5, hence the w/2-centered coefficient
    rebase."""
    h, w = img.shape[:2]
    a, b, c, d, e, f = mat
    if img.dtype == np.uint8:
        try:
            from PIL import Image
        except ImportError:
            Image = None
        if Image is not None:
            cx, cy = w / 2.0, h / 2.0
            coeffs = (
                a, b, -a * cx - b * cy + c + cx,
                d, e, -d * cx - e * cy + f + cy,
            )
            out = Image.fromarray(img).transform(
                (w, h), Image.AFFINE, coeffs, Image.BILINEAR,
                fillcolor=(int(fill),) * img.shape[-1],
            )
            return np.asarray(out)
    ys, xs = np.meshgrid(
        np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
        indexing="ij",
    )
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    xo, yo = xs - cx, ys - cy
    xi = a * xo + b * yo + c + cx
    yi = d * xo + e * yo + f + cy
    x0 = np.floor(xi).astype(np.int64)
    y0 = np.floor(yi).astype(np.int64)
    wx = (xi - x0)[..., None].astype(np.float32)
    wy = (yi - y0)[..., None].astype(np.float32)

    def sample(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(
            np.float32
        )
        return np.where(inside[..., None], v, np.float32(fill))

    top = sample(y0, x0) * (1 - wx) + sample(y0, x0 + 1) * wx
    bot = sample(y0 + 1, x0) * (1 - wx) + sample(y0 + 1, x0 + 1) * wx
    return _to_u8(top * (1 - wy) + bot * wy)


def _shear_x(img, v):
    return _affine(img, (1.0, -v, 0.0, 0.0, 1.0, 0.0))


def _shear_y(img, v):
    return _affine(img, (1.0, 0.0, 0.0, -v, 1.0, 0.0))


def _translate_x(img, v):
    return _affine(img, (1.0, 0.0, -v * img.shape[1], 0.0, 1.0, 0.0))


def _translate_y(img, v):
    return _affine(img, (1.0, 0.0, 0.0, 0.0, 1.0, -v * img.shape[0]))


def _rotate(img, deg):
    r = math.radians(deg)
    co, si = math.cos(r), math.sin(r)
    # torchvision convention: positive angle = visually counter-clockwise.
    # In array coords (y down) that is the CW matrix; its inverse rotates
    # output coords back CCW: [co, -si; si, co].
    return _affine(img, (co, -si, 0.0, si, co, 0.0))


def _lvl(lo, hi, signed=False):
    """Magnitude M∈[0,10] → op argument; signed ops flip direction 50/50
    (the sign draw comes from the caller's rng stream)."""
    def fn(m, sign):
        v = lo + (hi - lo) * (m / 10.0)
        return -v if (signed and sign) else v

    return fn


# name → (op, magnitude map, signed?). Ranges follow the RandAugment paper
# as implemented by timm (``rand_augment_transform`` defaults).
RAND_AUGMENT_OPS = {
    "identity": (lambda img, _m: img, _lvl(0, 0), False),
    "autocontrast": (_autocontrast, _lvl(0, 0), False),
    "equalize": (_equalize, _lvl(0, 0), False),
    "posterize": (_posterize, _lvl(8, 4), False),
    "solarize": (_solarize, _lvl(256, 0), False),
    "brightness": (_brightness, _lvl(1.0, 1.9), True),
    "contrast": (_contrast, _lvl(1.0, 1.9), True),
    "color": (_color, _lvl(1.0, 1.9), True),
    "sharpness": (_sharpness, _lvl(1.0, 1.9), True),
    "shear_x": (_shear_x, _lvl(0.0, 0.3), True),
    "shear_y": (_shear_y, _lvl(0.0, 0.3), True),
    "translate_x": (_translate_x, _lvl(0.0, 0.45), True),
    "translate_y": (_translate_y, _lvl(0.0, 0.45), True),
    "rotate": (_rotate, _lvl(0.0, 30.0), True),
}

# For the signed enhance ops timm mirrors around 1.0 (0.1..1.9), not to
# negative factors: sign flips (1+d) to (1-d).
_ENHANCE = {"brightness", "contrast", "color", "sharpness"}


def rand_augment(
    rng: np.random.Generator,
    img: np.ndarray,
    *,
    num_ops: int = 2,
    magnitude: float = 9.0,
    magnitude_std: float = 0.5,
    ops: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """RandAugment (Cubuk et al.): ``num_ops`` ops drawn uniformly from the
    set, each applied at ``magnitude`` (jittered by ``magnitude_std``, the
    timm 'rand-m9-mstd0.5' convention). uint8 HWC in and out."""
    if img.dtype != np.uint8:
        raise ValueError(f"rand_augment expects uint8 HWC, got {img.dtype}")
    names = list(ops) if ops is not None else list(RAND_AUGMENT_OPS)
    for _ in range(num_ops):
        name = names[int(rng.integers(0, len(names)))]
        op, lvl, signed = RAND_AUGMENT_OPS[name]
        m = magnitude
        if magnitude_std > 0:
            m = float(np.clip(rng.normal(magnitude, magnitude_std), 0, 10))
        sign = bool(rng.random() < 0.5) if signed else False
        v = lvl(m, sign)
        if name in _ENHANCE and sign:
            v = 2.0 - lvl(m, False)  # mirror around identity factor 1.0
        img = op(img, v)
    return img


# ---------------------------------------------------------------------------
# Batch-level: Mixup / CutMix → soft labels
# ---------------------------------------------------------------------------


def mixup_cutmix(
    rng: np.random.Generator,
    images: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    *,
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    prob: float = 1.0,
    switch_prob: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """DeiT-recipe batch Mixup/CutMix: pair each sample with the reversed
    batch, draw λ~Beta(α,α), and either lerp pixels (mixup) or paste a
    √(1−λ)-sized box (cutmix, λ corrected to the realized box area).
    Returns ``(images, soft_labels[B, num_classes])`` — soft labels even
    when the batch is left un-mixed, so every step sees one label shape.

    ``images`` is the *assembled* batch, NCHW or NHWC float (post
    per-image augments/normalization); ``labels`` is int [B].
    """
    b = images.shape[0]
    onehot = np.zeros((b, num_classes), np.float32)
    onehot[np.arange(b), labels] = 1.0
    use_cutmix = cutmix_alpha > 0 and (
        mixup_alpha <= 0 or rng.random() < switch_prob
    )
    if prob <= 0.0 or rng.random() >= prob or (
        mixup_alpha <= 0 and cutmix_alpha <= 0
    ):
        return images, onehot
    alpha = cutmix_alpha if use_cutmix else mixup_alpha
    lam = float(rng.beta(alpha, alpha))
    flipped = images[::-1]
    if use_cutmix:
        if images.shape[1] in (1, 3):  # NCHW
            h, w = images.shape[2], images.shape[3]
        else:  # NHWC
            h, w = images.shape[1], images.shape[2]
        rh, rw = int(h * math.sqrt(1.0 - lam)), int(w * math.sqrt(1.0 - lam))
        cy = int(rng.integers(0, h))
        cx = int(rng.integers(0, w))
        y0, y1 = max(cy - rh // 2, 0), min(cy + rh // 2, h)
        x0, x1 = max(cx - rw // 2, 0), min(cx + rw // 2, w)
        mixed = images.copy()
        if images.shape[1] in (1, 3):
            mixed[:, :, y0:y1, x0:x1] = flipped[:, :, y0:y1, x0:x1]
        else:
            mixed[:, y0:y1, x0:x1] = flipped[:, y0:y1, x0:x1]
        # λ corrected to the realized (clipped) box area — timm semantics.
        lam = 1.0 - ((y1 - y0) * (x1 - x0)) / float(h * w)
    else:
        mixed = lam * images + (1.0 - lam) * flipped
        mixed = mixed.astype(images.dtype)
    soft = lam * onehot + (1.0 - lam) * onehot[::-1]
    return mixed, soft



# -- the batch mix on the card ---------------------------------------------


class MixParams(NamedTuple):
    """One step's drawn Mixup/CutMix parameters (host numbers): whether the
    ``prob`` gate fired, whether CutMix (not Mixup) was chosen, λ, and the
    CutMix box centre (row, column)."""

    apply: bool
    cutmix: bool
    lam: float
    cy: int
    cx: int


def _image_hw(images) -> Tuple[int, int, int, int]:
    """(h, w, h axis, w axis) of an NCHW (C in 1, 3) or NHWC batch."""
    if images.ndim == 4 and images.shape[1] in (1, 3):
        return images.shape[2], images.shape[3], 2, 3
    return images.shape[1], images.shape[2], 1, 2


def draw_mix_params(
    generator: torch.Generator,
    h: int,
    w: int,
    *,
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    prob: float = 1.0,
    switch_prob: float = 0.5,
) -> MixParams:
    """Draw one step's Mixup/CutMix parameters from a CPU ``generator``:
    the switch (CutMix with ``switch_prob`` when both alphas are on), λ from
    Beta(α, α) of the chosen branch (the ratio of two gamma draws), the box
    centre uniform over the h x w image, and the ``prob`` gate. It takes
    the same share of ``generator``'s stream whatever it draws."""
    u_switch, u_prob = torch.rand(2, generator=generator,
                                  dtype=torch.float64).tolist()
    use_cutmix = cutmix_alpha > 0 and (mixup_alpha <= 0
                                       or u_switch < switch_prob)
    alpha = cutmix_alpha if use_cutmix else mixup_alpha
    # Gamma sampling rejects a varying number of draws: it runs on a
    # generator of its own, seeded by one draw of ``generator``.
    gamma_gen = torch.Generator().manual_seed(
        int(torch.randint(0, 2**62, (), generator=generator)))
    gam = torch._standard_gamma(
        torch.full((2,), max(alpha, 1e-12), dtype=torch.float64),
        generator=gamma_gen).tolist()
    lam = gam[0] / (gam[0] + gam[1]) if gam[0] + gam[1] > 0 else 1.0
    cy = int(torch.randint(0, h, (), generator=generator))
    cx = int(torch.randint(0, w, (), generator=generator))
    apply = (prob >= 1.0 or u_prob < prob) and (mixup_alpha > 0
                                                  or cutmix_alpha > 0)
    return MixParams(bool(apply), bool(use_cutmix), float(lam), cy, cx)


def apply_mixup_cutmix(images: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, params: MixParams):
    """Apply drawn parameters to a batch on any device, reading nothing
    back from it: the pair of image i is image B-1-i (the reversed batch);
    CutMix pastes the pair's pixels inside the box (two iota comparisons,
    clipped to the image) and corrects λ to the area actually cut; Mixup is
    the fp32 lerp λ·x + (1 − λ)·pair, cast back to the images' dtype. Soft
    labels ``λ·onehot + (1 − λ)·onehot[::-1]``; when the gate did not fire,
    the images pass through unchanged with one-hot labels.

    ``labels`` is int [B] → returns ``(images, soft_labels[B, C])`` fp32.
    The arithmetic is :func:`mixup_cutmix`'s on the same λ and box."""
    b = labels.shape[0]
    onehot = torch.zeros((b, num_classes), dtype=torch.float32,
                         device=labels.device)
    onehot.scatter_(1, labels.long()[:, None], 1.0)
    if not params.apply:
        return images, onehot
    lam = params.lam
    flipped = images.flip(0)
    if params.cutmix:
        h, w, hax, wax = _image_hw(images)
        cut = math.sqrt(1.0 - lam)
        rh, rw = int(h * cut), int(w * cut)
        y0, y1 = max(params.cy - rh // 2, 0), min(params.cy + rh // 2, h)
        x0, x1 = max(params.cx - rw // 2, 0), min(params.cx + rw // 2, w)
        ys = torch.arange(h, device=images.device)
        xs = torch.arange(w, device=images.device)
        mask = (((ys >= y0) & (ys < y1))[:, None]
                & ((xs >= x0) & (xs < x1))[None, :])
        shape = [1, 1, 1, 1]
        shape[hax], shape[wax] = h, w
        mixed = torch.where(mask.reshape(shape), flipped, images)
        lam = 1.0 - ((y1 - y0) * (x1 - x0)) / float(h * w)
    else:
        mixed = (lam * images.float()
                 + (1.0 - lam) * flipped.float()).to(images.dtype)
    soft = lam * onehot + (1.0 - lam) * onehot.flip(0)
    return mixed, soft


def device_mixup_cutmix(
    generator: torch.Generator,
    images: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
    *,
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    prob: float = 1.0,
    switch_prob: float = 0.5,
):
    """Mixup/CutMix of a batch where it lies (the card in training): the
    parameters drawn on the host from ``generator`` (:func:`draw_mix_params`),
    then applied (:func:`apply_mixup_cutmix`). ``labels`` int [B] → returns
    ``(mixed_images, soft_labels[B, C])``. ``Trainer(mixup=...)`` runs it
    in front of each step."""
    h, w, _, _ = _image_hw(images)
    params = draw_mix_params(generator, h, w, mixup_alpha=mixup_alpha,
                             cutmix_alpha=cutmix_alpha, prob=prob,
                             switch_prob=switch_prob)
    return apply_mixup_cutmix(images, labels, num_classes, params)


# ---------------------------------------------------------------------------
# The composed pipeline
# ---------------------------------------------------------------------------


def _augment_one(im: np.ndarray, img_seed, *, img_size, rrc_scale,
                 rrc_ratio, hflip, randaugment) -> np.ndarray:
    """Geometric + RandAugment transforms for ONE image; returns HWC,
    **pre-normalize** (uint8 when RandAugment ran — 4x less IPC traffic
    from pool workers than fp32 — else fp32 bilinear output). The caller
    normalizes the stacked batch in one vectorized op."""
    r = np.random.default_rng(img_seed)
    im = random_resized_crop(r, im, img_size, scale=rrc_scale,
                             ratio=rrc_ratio)
    im = random_hflip(r, im, hflip)
    if randaugment is not None:
        im = rand_augment(r, _to_u8(im), num_ops=randaugment[0],
                          magnitude=randaugment[1])
    return im


# Fork-based pool plumbing: the dataset is inherited copy-on-write at fork
# time (initargs are passed in-memory under the fork start method, never
# pickled); each map task carries only (index, seed) and returns one image.
_WORKER_STATE: Optional[tuple] = None


def _augment_worker_init(images: np.ndarray, aug_kw: dict) -> None:
    global _WORKER_STATE
    _WORKER_STATE = (images, aug_kw)


def _augment_worker_one(task: tuple) -> np.ndarray:
    images, aug_kw = _WORKER_STATE
    i, img_seed = task
    return _augment_one(images[i], img_seed, **aug_kw)


def augmented_dataset(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    num_classes: int,
    *,
    img_size: int = 224,
    epochs: Optional[int] = 1,
    seed: int = 0,
    hflip: float = 0.5,
    rrc_scale: Tuple[float, float] = (0.08, 1.0),
    rrc_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    randaugment: Optional[Tuple[int, float]] = (2, 9.0),
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    mix_prob: float = 1.0,
    switch_prob: float = 0.5,
    mean: np.ndarray = IMAGENET_MEAN,
    std: np.ndarray = IMAGENET_STD,
    drop_last: bool = True,
    mix: str = "host",
    workers: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The DeiT-style training input pipeline over an in-memory dataset of
    **raw uint8 HWC images** [N, H, W, 3]:

        shuffle → RandomResizedCrop(img_size) → flip → RandAugment →
        normalize(NCHW fp32) → Mixup/CutMix → (batch, soft_labels)

    Host-side and fully deterministic in ``seed`` (one Generator stream per
    epoch, same convention as :func:`data.memory_dataset`). Feed the result
    to :class:`data.DevicePrefetcher`; pair with
    ``make_train_step``'s soft-label loss path.

    Set ``randaugment=None`` to disable it; ``mixup_alpha=cutmix_alpha=0``
    for plain geometric augmentation (labels still arrive one-hot).

    ``mix`` places the batch mix: ``"host"`` (soft labels out, NumPy lerp
    here), or ``"device"`` — yield *int* labels and let the training step
    run :func:`device_mixup_cutmix` on the card (``Trainer(mixup=...)``).

    ``workers > 1`` spreads the per-image augments over a **fork-based
    process pool** — the per-image ops (crop geometry, RandAugment's
    small-array NumPy) are Python/GIL-bound, so threads cannot scale them
    (the JAX package measured 2–8 threads slower than 1). Fork
    shares the uint8 dataset copy-on-write (no per-task pickling of the
    source images); each task ships back one augmented image and the parent
    normalizes the whole batch in a single vectorized op. Results are
    bit-identical for any worker count because each image draws from its
    own seeded Generator. Platforms without ``fork`` fall back to a thread
    pool (correct, but not faster).
    """
    n = images.shape[0]
    if images.dtype != np.uint8 or images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(
            "augmented_dataset takes raw uint8 HWC images [N, H, W, 3]; "
            f"got {images.dtype} {images.shape}. For pre-normalized tensors "
            "use data.memory_dataset (no pixel-space augments possible)."
        )
    if labels.shape[0] != n:
        raise ValueError(f"images ({n}) / labels ({labels.shape[0]}) mismatch")
    if mix not in ("host", "device"):
        raise ValueError(f"mix must be 'host' or 'device', got {mix!r}")
    mean_c = mean.reshape(1, 1, 3).astype(np.float32) * 255.0
    inv_std_c = 1.0 / (std.reshape(1, 1, 3).astype(np.float32) * 255.0)
    aug_kw = dict(img_size=img_size, rrc_scale=rrc_scale,
                  rrc_ratio=rrc_ratio, hflip=hflip, randaugment=randaugment)

    pool = thread_pool = None
    if workers > 1:
        import multiprocessing as mp

        if "fork" in mp.get_all_start_methods():
            # Fork AFTER `images` exists: children inherit the dataset
            # copy-on-write; tasks carry only (index, seed).
            pool = mp.get_context("fork").Pool(
                workers, initializer=_augment_worker_init,
                initargs=(images, aug_kw))
        else:  # pragma: no cover — non-fork platform fallback
            from concurrent.futures import ThreadPoolExecutor

            thread_pool = ThreadPoolExecutor(max_workers=workers)
    try:
        epoch = 0
        while epochs is None or epoch < epochs:
            rng = np.random.default_rng(seed + epoch)
            order = rng.permutation(n)
            # Pre-drawn per-image seeds: augment randomness is a function
            # of (seed, epoch, position), independent of worker count.
            img_seeds = rng.integers(0, 2**63, size=n)
            stop = n - batch_size + 1 if drop_last else n
            for lo in range(0, max(stop, 0), batch_size):
                idx = order[lo : lo + batch_size]
                seeds = img_seeds[lo : lo + len(idx)]
                if pool is not None:
                    outs = pool.map(
                        _augment_worker_one, list(zip(idx, seeds)),
                        chunksize=max(1, len(idx) // (workers * 2)))
                elif thread_pool is not None:  # pragma: no cover
                    outs = list(thread_pool.map(
                        lambda a: _augment_one(images[a[0]], a[1], **aug_kw),
                        zip(idx, seeds)))
                else:
                    outs = [_augment_one(images[i], s, **aug_kw)
                            for i, s in zip(idx, seeds)]
                # One vectorized normalize + NCHW transpose for the whole
                # batch (elementwise, so bit-identical to the per-image
                # form).
                hwc = np.stack(outs).astype(np.float32, copy=False)
                batch = np.ascontiguousarray(
                    ((hwc - mean_c) * inv_std_c).transpose(0, 3, 1, 2))
                if mix == "device":
                    yield batch, labels[idx]
                else:
                    yield mixup_cutmix(
                        rng, batch, labels[idx], num_classes,
                        mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                        prob=mix_prob, switch_prob=switch_prob,
                    )
            epoch += 1
    finally:
        if pool is not None:
            pool.terminate()
        if thread_pool is not None:  # pragma: no cover
            thread_pool.shutdown(wait=False)

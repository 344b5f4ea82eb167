"""On-card DeiT augmentation: RandomResizedCrop → flip → RandAugment →
normalize over a raw uint8 batch, as plain PyTorch ops on the card.

Counterpart of ``vit_with_opencl_tpu/augment_device.py``. The host loader
(:func:`raw_batches`) only shuffles and slices raw uint8 HWC batches, which
:class:`data.DevicePrefetcher` uploads as uint8 (a third of the bytes of
fp32); :func:`device_augment` then turns them into normalized NCHW fp32 on
the card. ``Trainer(device_augment=...)`` runs it in front of each step.

Draw on the host, compute on the card. Each image's parameters are a few
numbers (the crop box, the flip, and for each RandAugment op its index,
magnitude and sign), drawn from a CPU ``torch.Generator``
(:func:`draw_augment_params`). The host then plans the batch: the crop's
source rows and columns with their bilinear weights (the flip folded into
the column order), and for each op every image's op argument and which
family of ops it drew. The card runs every image through each family, with
its own op or the family's exact identity: the six ops that map a pixel
through a per-image table of 256 levels (identity, autocontrast, equalize,
posterize, solarize, brightness, contrast) as one table lookup, color and
sharpness under a mask, and the five affine ops as JAX's three fused warp
passes. So the shapes are fixed and nothing is read back from the card:
on the card the pipeline is captured once as a CUDA graph and each batch
costs one upload of its plan and one replay. (A form that ran each op on
the images that drew it, by ``index_select`` and ``index_copy_``, launched
about 800 small ops a batch; on an H100's host they took 15-21 ms, a third
of a ViT-B step. The replayed graph's extra arithmetic is a few passes over
the batch.)

The op semantics are the JAX package's device twins one for one: the same
op table and order (:data:`DEVICE_RAND_AUGMENT_OPS`), magnitude mapping,
timm's mirror of the enhance factors around 1, PIL's blend and equalize
arithmetic, rounding to the uint8 grid after every op (``_q8``: round half
to even, then clip), bilinear resampling with ``align_corners=False``, and
rotation as Paeth's three shears (x, y, x), each a single-axis 2-tap warp
with gray fill 128. The crop is resampled with a 4-tap gather, not JAX's
pair of one-hot products, so no matrix product (and no TF32) touches the
pixels. Only the draws differ from the JAX package: it draws from
``jax.random`` keys, which torch cannot reproduce, so the tests hold each
op to JAX's on the same drawn parameters.
"""
from __future__ import annotations

import math
import threading
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .io.preprocess import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["DEVICE_RAND_AUGMENT_OPS", "AugmentParams", "draw_augment_params",
           "apply_augment", "device_augment", "raw_batches",
           "step_generators", "release_graphs"]

_GRAY = (0.299, 0.587, 0.114)  # PIL L-mode weights
_FILL = 128.0


def _q8(x: torch.Tensor) -> torch.Tensor:
    """uint8 quantization in float (every host op rounds through uint8):
    round half to even, then clip to [0, 255]."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def _divide(x: torch.Tensor, by: float) -> torch.Tensor:
    """x / by, correctly rounded on every device (on the card PyTorch
    multiplies by the reciprocal of a Python-number divisor)."""
    return x / torch.full((), by, dtype=x.dtype, device=x.device)


def _blend(img, other, factor):
    """PIL ImageEnhance blend: other + factor·(img − other), u8-rounded."""
    return _q8(other + factor.reshape(-1, 1, 1, 1) * (img - other))


# ---------------------------------------------------------------------------
# RandAugment ops: img fp32 [n, H, W, 3] on the u8 grid, v fp32 [n] (one
# argument an image, on img's device)
# ---------------------------------------------------------------------------

# Six ops map each pixel through a function of its value, its channel and its
# image's statistics: each is a table of 256 levels an image and channel
# ([n, 3, 256]), built with the op's own arithmetic on the levels and applied
# by one gather (the same bits as the op on each pixel).


def _levels(img) -> torch.Tensor:
    return torch.arange(256, dtype=img.dtype, device=img.device)


def _apply_lut(img, lut):
    """out[n, y, x, c] = lut[n, c, img[n, y, x, c]]."""
    n, h, w, c = img.shape
    return lut[:, None, None].expand(n, h, w, c, 256).gather(
        -1, img.to(torch.int64)[..., None])[..., 0]


def _per_channel(lut_n: torch.Tensor, c: int = 3) -> torch.Tensor:
    """[n, 256] → [n, c, 256]."""
    return lut_n[:, None].expand(-1, c, -1)


def _lut_autocontrast(img, _v):
    lo = img.amin(dim=(1, 2))[..., None]  # [n, 3, 1]
    hi = img.amax(dim=(1, 2))[..., None]
    span = torch.clamp(hi - lo, min=1.0)
    levels = _levels(img)
    scaled = _q8((levels - lo) * (torch.full_like(span, 255.0) / span))
    return torch.where(hi <= lo, levels, scaled)  # a flat channel stays


def _lut_equalize(img, _v):
    """PIL ImageOps.equalize per image and channel: the 256-bin histogram
    (``scatter_add_`` on offset indices), PIL's step/offset LUT in integer
    arithmetic. Exact."""
    n, h, w, c = img.shape
    pix = img.to(torch.int64).permute(0, 3, 1, 2).reshape(n * c, h * w)
    offset = torch.arange(n * c, device=img.device)[:, None] * 256
    hist = torch.zeros(n * c * 256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(0, (pix + offset).reshape(-1),
                      torch.ones(pix.numel(), dtype=torch.int64,
                                 device=img.device))
    hist = hist.view(n * c, 256)
    nz = hist > 0
    bins = torch.arange(256, device=img.device)
    last = torch.where(nz, bins, -1).argmax(-1, keepdim=True)
    last_nz = hist.gather(1, last)  # the count of the last nonzero bin
    step = torch.div(h * w - last_nz, 255, rounding_mode="floor")
    lut = torch.div(hist.cumsum(-1) - hist + torch.div(step, 2,
                                                       rounding_mode="floor"),
                    torch.clamp(step, min=1), rounding_mode="floor")
    keep = (nz.sum(-1, keepdim=True) <= 1) | (step == 0)
    lut = torch.where(keep, bins, torch.clamp(lut, 0, 255)).to(img.dtype)
    return lut.view(n, c, 256)


def _lut_posterize(img, bits):
    """v & uint8(256 − 2^(8 − b)), b = round(bits) in [0, 8]; b = 8 is the
    identity."""
    b = torch.clamp(torch.round(bits).to(torch.int32), 0, 8)[:, None]
    mask = torch.bitwise_and(
        256 - torch.bitwise_left_shift(torch.ones_like(b), 8 - b), 0xFF)
    levels = _levels(img)
    out = torch.bitwise_and(levels.to(torch.int32), mask).to(img.dtype)
    return _per_channel(torch.where(b >= 8, levels, out), img.shape[-1])


def _lut_solarize(img, threshold):
    levels = _levels(img)
    return _per_channel(torch.where(levels >= threshold[:, None],
                                    255.0 - levels, levels), img.shape[-1])


def _lut_blend(img, other, factor):
    """PIL ImageEnhance blend against a per-image level ``other`` [n]:
    other + factor·(v − other), u8-rounded."""
    other = other[:, None]
    return _per_channel(_q8(other + factor[:, None] * (_levels(img) - other)),
                        img.shape[-1])


def _lut_brightness(img, factor):
    return _lut_blend(img, torch.zeros_like(factor), factor)


def _gray(img):
    """PIL's L conversion: the channels weighted by _GRAY → [n, H, W]."""
    return (img[..., 0] * _GRAY[0] + img[..., 1] * _GRAY[1]
            + img[..., 2] * _GRAY[2])


def _lut_contrast(img, factor):
    return _lut_blend(img, _q8(_gray(img).mean(dim=(1, 2))), factor)


def _lut_identity(img, _v):
    return _levels(img).expand(img.shape[0], img.shape[-1], 256)


# In table order (ops 0-6); each takes (img, v) → [n, 3, 256] tables.
_LUT_OPS = (_lut_identity, _lut_autocontrast, _lut_equalize, _lut_posterize,
            _lut_solarize, _lut_brightness, _lut_contrast)


def _identity(img, _v):
    return img


def _autocontrast(img, v):
    return _apply_lut(img, _lut_autocontrast(img, v))


def _equalize(img, v):
    return _apply_lut(img, _lut_equalize(img, v))


def _posterize(img, bits):
    return _apply_lut(img, _lut_posterize(img, bits))


def _solarize(img, threshold):
    return _apply_lut(img, _lut_solarize(img, threshold))


def _brightness(img, factor):
    return _apply_lut(img, _lut_brightness(img, factor))


def _contrast(img, factor):
    return _apply_lut(img, _lut_contrast(img, factor))


def _photometric(img, sel, v):
    """Each image through its own table op: ``sel`` (int64 [n]) indexes
    _LUT_OPS (0, the identity, for an image whose op is another).
    Every table op runs on all images, then each image's table is picked."""
    luts = torch.stack([table(img, v) for table in _LUT_OPS])
    n = img.shape[0]
    lut = luts.gather(0, sel.view(1, n, 1, 1).expand(1, n, 3, 256))[0]
    return _apply_lut(img, lut)


def _color(img, factor):
    return _blend(img, _q8(_gray(img))[..., None], factor)


def _sharpness(img, factor):
    """PIL SMOOTH kernel ([[1,1,1],[1,5,1],[1,1,1]]/13), borders kept."""
    pad = torch.nn.functional.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                  mode="replicate").permute(0, 2, 3, 1)
    sm = _divide(pad[:, :-2, :-2] + pad[:, :-2, 1:-1] + pad[:, :-2, 2:]
                 + pad[:, 1:-1, :-2] + 5.0 * img + pad[:, 1:-1, 2:]
                 + pad[:, 2:, :-2] + pad[:, 2:, 1:-1] + pad[:, 2:, 2:], 13.0)
    h, w = img.shape[1:3]
    ys = torch.arange(h, device=img.device)[:, None, None]
    xs = torch.arange(w, device=img.device)[None, :, None]
    border = (ys == 0) | (ys == h - 1) | (xs == 0) | (xs == w - 1)
    return _blend(img, _q8(torch.where(border, img, sm)), factor)


# -- the affine ops: three single-axis warps -------------------------------


def _warp_taps(slope: np.ndarray, const: np.ndarray, other: int) -> list:
    """One warp pass's offsets per image and line (planned on the host, in
    fp32): off(t) = slope·(t − centre) + const for the ``other`` lines →
    [the integer shift (int64), the second tap's weight]."""
    t = np.arange(other, dtype=np.float32) - np.float32((other - 1) / 2.0)
    off = slope[:, None] * t[None, :] + const[:, None]  # [n, other]
    base = np.floor(off)
    return [base.astype(np.int64), off - base]


def _warp(img, base, f, axis: int):
    """``axis`` 2 (x): out[y, x] = bilinear(img[y], x + off(y)); axis 1
    (y): out[y, x] = bilinear(img[:, x], y + off(x)); taps outside the image
    gray. The exact single-axis form of a bilinear affine warp whose map has
    a unit diagonal (shears, translations, Paeth's rotation passes). The
    image is padded with one gray line at each end and the taps clamped into
    the padding, so any shift works (JAX's twin clips the shift to a budget
    that the ops' magnitude range never reaches)."""
    n, h, w, c = img.shape
    size = img.shape[axis]
    pad = (0, 0, 1, 1) if axis == 2 else (0, 0, 0, 0, 1, 1)
    padded = torch.nn.functional.pad(img, pad, value=_FILL)
    line = torch.arange(1, size + 1, device=img.device)  # padded positions
    if axis == 2:  # [n, y, x]: x + off(y)
        src, f = base[:, :, None] + line[None, None, :], f[:, :, None, None]
    else:  # [n, y, x]: y + off(x)
        src, f = base[:, None, :] + line[None, :, None], f[:, None, :, None]

    def tap(s):
        idx = torch.clamp(s, 0, size + 1)[..., None].expand(n, h, w, c)
        return padded.gather(axis, idx)

    return (1.0 - f) * tap(src) + f * tap(src + 1)


_GEOM_BASE = 9  # table rows 9-13: shear_x, shear_y, translate_x/y, rotate


def _geometry_passes(op: np.ndarray, v: np.ndarray, h: int, w: int) -> tuple:
    """Per image (slope, const) of the three passes x, y, x that every
    geometric op is (JAX's ``_geom_apply``): shear_x and translate_x are the
    first, shear_y and translate_y the second, rotate all three (Paeth: α
    = −tan(θ/2), β = sin θ, by torch's fp32 functions); a pass an op does
    not use has zero parameters, an exact identity."""
    g = op - _GEOM_BASE
    zero = np.zeros_like(v)
    r = torch.from_numpy(v * np.float32(math.pi / 180.0))
    alpha, beta = (-torch.tan(r / 2.0)).numpy(), torch.sin(r).numpy()
    k1 = np.where(g == 0, -v, np.where(g == 4, alpha, zero))
    t1 = np.where(g == 2, -v * np.float32(w), zero)
    k2 = np.where(g == 1, -v, np.where(g == 4, beta, zero))
    t2 = np.where(g == 3, -v * np.float32(h), zero)
    k3 = np.where(g == 4, alpha, zero)
    return (k1, t1), (k2, t2), (k3, zero)


_PASS_AXES = (2, 1, 2)


def _geometry_taps(op: np.ndarray, v: np.ndarray, h: int, w: int) -> list:
    """The three passes' taps (``_warp_taps``): [base, f] x 3."""
    taps = []
    for (slope, const), axis in zip(_geometry_passes(op, v, h, w), _PASS_AXES):
        taps += _warp_taps(slope, const, h if axis == 2 else w)
    return taps


def _geometry(img, *taps):
    """The three passes, each rounded to the u8 grid."""
    for i, axis in enumerate(_PASS_AXES):
        img = _q8(_warp(img, taps[2 * i], taps[2 * i + 1], axis))
    return img


def _geometric(img, k: int, v):
    """Table op ``k`` (9-13) on every image of ``img``, its taps planned on
    the host from ``v`` (read back, where it lies on the card: the
    pipeline plans them from host numbers and never does)."""
    v = v.detach().cpu().numpy()
    taps = _geometry_taps(np.full(v.shape, k), v, img.shape[1], img.shape[2])
    return _geometry(img, *(torch.from_numpy(t).to(img.device) for t in taps))


def _shear_x(img, v):
    return _geometric(img, 9, v)


def _shear_y(img, v):
    return _geometric(img, 10, v)


def _translate_x(img, v):
    return _geometric(img, 11, v)


def _translate_y(img, v):
    return _geometric(img, 12, v)


def _rotate(img, deg):
    """Paeth's rotation, R(θ) = Sx(α)·Sy(β)·Sx(α) with α = −tan(θ/2), β =
    sin θ: three single-axis passes, each u8-rounded (the JAX package's
    device rotation, not the host's single resample)."""
    return _geometric(img, 13, deg)


class _Level(NamedTuple):
    """A magnitude map: m in [0, 10] → lo + (hi − lo)·m/10."""

    lo: float
    hi: float

    def __call__(self, m):
        return self.lo + (self.hi - self.lo) * (m / 10.0)


# Same table and order as the JAX package's DEVICE_RAND_AUGMENT_OPS (and the
# host's RAND_AUGMENT_OPS), so op indices mean the same thing:
# (name, op, magnitude map, signed).
DEVICE_RAND_AUGMENT_OPS = (
    ("identity", _identity, _Level(0, 0), False),
    ("autocontrast", _autocontrast, _Level(0, 0), False),
    ("equalize", _equalize, _Level(0, 0), False),
    ("posterize", _posterize, _Level(8, 4), False),
    ("solarize", _solarize, _Level(256, 0), False),
    ("brightness", _brightness, _Level(1.0, 1.9), True),
    ("contrast", _contrast, _Level(1.0, 1.9), True),
    ("color", _color, _Level(1.0, 1.9), True),
    ("sharpness", _sharpness, _Level(1.0, 1.9), True),
    ("shear_x", _shear_x, _Level(0.0, 0.3), True),
    ("shear_y", _shear_y, _Level(0.0, 0.3), True),
    ("translate_x", _translate_x, _Level(0.0, 0.45), True),
    ("translate_y", _translate_y, _Level(0.0, 0.45), True),
    ("rotate", _rotate, _Level(0.0, 30.0), True),
)
_ENHANCE_IDX = (5, 6, 7, 8)  # brightness/contrast/color/sharpness
# The table as arrays over op indices: each map's lo and hi − lo (taken in
# Python's doubles, then fp32, as the map's own arithmetic rounds it),
# signed, and mirrored (timm's enhance factors: 2 − v for the negative sign).
_LO = np.array([row[2].lo for row in DEVICE_RAND_AUGMENT_OPS], np.float32)
_SPAN = np.array([row[2].hi - row[2].lo for row in DEVICE_RAND_AUGMENT_OPS],
                 np.float32)
_SIGNED = np.array([row[3] for row in DEVICE_RAND_AUGMENT_OPS])
_MIRRORED = np.array([k in _ENHANCE_IDX
                      for k in range(len(DEVICE_RAND_AUGMENT_OPS))])


def op_arguments(op_idx: np.ndarray, magnitude: np.ndarray,
                 sign: np.ndarray) -> np.ndarray:
    """Each image's op argument (host arrays): its op's magnitude map at
    ``magnitude`` (fp32), then for signed ops the ``sign``, which timm
    applies to the enhance factors as a mirror around 1 (2 − v)."""
    v = _LO[op_idx] + _SPAN[op_idx] * (np.asarray(magnitude, np.float32)
                                       / np.float32(10.0))
    flipped = np.where(_MIRRORED[op_idx], np.float32(2.0) - v, -v)
    return np.where(np.asarray(sign) & _SIGNED[op_idx], flipped, v)


# ---------------------------------------------------------------------------
# The draws
# ---------------------------------------------------------------------------


class AugmentParams(NamedTuple):
    """One batch's drawn parameters, CPU tensors: the crop box (``top``,
    ``left``, ``ch``, ``cw``: int64 [B]), ``flip`` (bool [B]) and, for each
    of the RandAugment ops, ``op_idx`` (int64 [num_ops, B]), ``magnitude``
    (fp32 [num_ops, B]) and ``sign`` (bool [num_ops, B])."""

    top: torch.Tensor
    left: torch.Tensor
    ch: torch.Tensor
    cw: torch.Tensor
    flip: torch.Tensor
    op_idx: torch.Tensor
    magnitude: torch.Tensor
    sign: torch.Tensor


def _rrc_box(generator: torch.Generator, batch: int, h: int, w: int,
             scale, ratio, attempts: int = 10) -> tuple:
    """torchvision RandomResizedCrop boxes for ``batch`` images: ``attempts``
    (area, log-ratio) draws an image, the first valid one taken, else the
    host's center fallback (the largest crop at the nearest in-range
    ratio). Returns (top, left, ch, cw), int64 [batch] each."""
    area = float(h * w)
    ta = area * torch.empty((batch, attempts)).uniform_(
        scale[0], scale[1], generator=generator)
    log_r = (math.log(ratio[0]), math.log(ratio[1]))
    aspect = torch.exp(torch.empty((batch, attempts)).uniform_(
        log_r[0], log_r[1], generator=generator))
    cw = torch.round(torch.sqrt(ta * aspect)).to(torch.int64)
    ch = torch.round(torch.sqrt(ta / aspect)).to(torch.int64)
    u_top, u_left = torch.rand((2, batch), generator=generator)
    valid = (cw > 0) & (cw <= w) & (ch > 0) & (ch <= h)
    first = valid.to(torch.int8).argmax(-1, keepdim=True)
    cw_s, ch_s = cw.gather(1, first)[:, 0], ch.gather(1, first)[:, 0]
    top = torch.floor(u_top * (h - ch_s + 1).to(torch.float32))
    left = torch.floor(u_left * (w - cw_s + 1).to(torch.float32))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        fw, fh = w, min(h, int(round(w / ratio[0])))
    elif in_ratio > ratio[1]:
        fw, fh = min(w, int(round(h * ratio[1]))), h
    else:
        fw, fh = w, h
    ok = valid.any(-1)
    return (torch.where(ok, top.to(torch.int64), (h - fh) // 2),
            torch.where(ok, left.to(torch.int64), (w - fw) // 2),
            torch.where(ok, ch_s, fh), torch.where(ok, cw_s, fw))


def draw_augment_params(
    generator: torch.Generator,
    batch: int,
    h: int,
    w: int,
    *,
    rrc_scale: Tuple[float, float] = (0.08, 1.0),
    rrc_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    hflip: float = 0.5,
    randaugment: Optional[Tuple[int, float]] = (2, 9.0),
    magnitude_std: float = 0.5,
) -> AugmentParams:
    """Draw a batch's parameters from a CPU ``generator``: the crop boxes
    (:func:`_rrc_box`), the flips (probability ``hflip``), and for each of
    ``randaugment[0]`` ops an op index uniform over the table, a magnitude
    ``randaugment[1]`` jittered by N(0, ``magnitude_std``) and clipped to
    [0, 10], and a fair sign."""
    top, left, ch, cw = _rrc_box(generator, batch, h, w, rrc_scale, rrc_ratio)
    flip = torch.rand(batch, generator=generator) < hflip
    num_ops, magnitude = (int(randaugment[0]), float(randaugment[1])) \
        if randaugment is not None else (0, 0.0)
    n = len(DEVICE_RAND_AUGMENT_OPS)
    op_idx = torch.randint(0, n, (num_ops, batch), generator=generator)
    noise = torch.randn((num_ops, batch), generator=generator)
    mag = torch.full((num_ops, batch), magnitude, dtype=torch.float32)
    if magnitude_std > 0:
        mag = torch.clamp(magnitude + magnitude_std * noise, 0.0, 10.0)
    sign = torch.rand((num_ops, batch), generator=generator) < 0.5
    return AugmentParams(top, left, ch, cw, flip, op_idx, mag, sign)


# ---------------------------------------------------------------------------
# The plan (host) and its application (card)
# ---------------------------------------------------------------------------


def _axis_taps(start: np.ndarray, c: np.ndarray, out_size: int, n: int,
               reverse: Optional[np.ndarray] = None) -> list:
    """One axis of the crop's bilinear resample, per image, planned on the
    host: the two source indices and the weight of the second
    (align_corners=False, coordinates clipped to the crop), as JAX's
    ``_cr_weights`` computes them in fp32. ``reverse`` (bool [B]) reverses
    the output order of those images (the flip)."""
    u = np.arange(out_size, dtype=np.float32)
    s = ((u[None, :] + np.float32(0.5)) * c[:, None].astype(np.float32)
         / np.float32(out_size) - np.float32(0.5))
    s0 = np.minimum(np.maximum(np.floor(s).astype(np.int64), 0), c[:, None] - 1)
    s1 = np.minimum(s0 + 1, c[:, None] - 1)
    f = np.clip(s - s0.astype(np.float32), np.float32(0.0), np.float32(1.0))
    a0 = np.clip(start[:, None] + s0, 0, n - 1)
    a1 = np.clip(start[:, None] + s1, 0, n - 1)
    if reverse is not None:
        r = reverse[:, None]
        a0, a1, f = (np.where(r, t[:, ::-1], t) for t in (a0, a1, f))
    return [a0, a1, f]


def _plan(params: AugmentParams, h: int, w: int, img_size: int,
          mean, std) -> list:
    """The batch's plan on the host, CPU tensors of fixed shapes for a batch
    size: the crop's taps, the normalization constants, and for each
    RandAugment op every image's table op (0, the identity, for the ops
    outside the six table ops), argument, color and sharpness masks, and
    the three affine passes' taps (zero, an exact identity, outside the
    affine ops)."""
    p = AugmentParams(*(t.numpy() for t in params))
    arrays = [*_axis_taps(p.top, p.ch, img_size, h),
              *_axis_taps(p.left, p.cw, img_size, w, reverse=p.flip),
              np.asarray(mean, np.float32) * np.float32(255.0),
              np.asarray(std, np.float32) * np.float32(255.0)]
    for op, m, sign in zip(p.op_idx, p.magnitude, p.sign):
        v = op_arguments(op, m, sign)
        arrays += [np.where(op < len(_LUT_OPS), op, 0), v,
                   (op == 7).reshape(-1, 1, 1, 1), (op == 8).reshape(-1, 1, 1, 1),
                   *_geometry_taps(op, v, img_size, img_size)]
    return [np.ascontiguousarray(a) for a in arrays]


def _crop_resize(images, a0y, a1y, fy, a0x, a1x, fx):
    """Bilinear resample of each image's crop box: rows, then columns (4
    taps, fp32) → [B, S, S, 3] in [0, 255]."""
    b, _, w, c = images.shape
    s = a0y.shape[1]

    def rows(a):
        return images.gather(1, a[:, :, None, None].expand(b, s, w, c)).to(
            torch.float32)

    fy = fy[:, :, None, None]
    t = (1.0 - fy) * rows(a0y) + fy * rows(a1y)

    def cols(a):
        return t.gather(2, a[:, None, :, None].expand(b, s, s, c))

    fx = fx[:, None, :, None]
    return (1.0 - fx) * cols(a0x) + fx * cols(a1x)


def _augment(images, quantize: bool, a0y, a1y, fy, a0x, a1x, fx, mean, std,
             *steps):
    """The pipeline on the planned tensors: the crop (the flip folded in),
    and with ``quantize`` the u8 grid and each RandAugment op, every image
    through each family of ops with its own op or that family's exact
    identity; then the normalization. Fixed shapes and no host reads, so
    on the card it is captured once as a CUDA graph (``_Replays``)."""
    out = _crop_resize(images, a0y, a1y, fy, a0x, a1x, fx)
    if quantize:
        out = _q8(out)
        for j in range(0, len(steps), _STEP_TENSORS):
            sel, v, color, sharp, *taps = steps[j:j + _STEP_TENSORS]
            out = _photometric(out, sel, v)
            out = torch.where(color, _color(out, v), out)
            out = torch.where(sharp, _sharpness(out, v), out)
            out = _geometry(out, *taps)
    out = (out - mean) / std
    return out.permute(0, 3, 1, 2).contiguous()


_STEP_TENSORS = 10  # a RandAugment op's planned tensors


def _flat(arrays: list) -> dict:
    """The planned arrays concatenated a dtype: {dtype: flat CPU tensor}."""
    return {d: torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays
                                                if a.dtype == d]))
            for d in dict.fromkeys(a.dtype for a in arrays)}


def _views(arrays: list, flats: dict) -> list:
    """``arrays``' shapes as views of ``flats`` (laid out by _flat)."""
    parts = {d: iter(f.split([a.size for a in arrays if a.dtype == d]))
             for d, f in flats.items()}
    return [next(parts[a.dtype]).view(a.shape) for a in arrays]


class _Replay:
    """One captured pipeline: static input, planned tensors (a flat buffer a
    dtype, as _flat lays them out) and output on the card, the CUDA graph
    over them, and the event after its last use."""

    def __init__(self, images: torch.Tensor, tensors: list, quantize: bool):
        self.images = torch.empty_like(images)
        self.flats = {d: torch.empty_like(f, device=images.device)
                      for d, f in _flat(tensors).items()}
        args = (self.images, quantize, *_views(tensors, self.flats))
        self.load(images, _flat(tensors))
        side = torch.cuda.Stream(images.device)
        side.wait_stream(torch.cuda.current_stream(images.device))
        with torch.cuda.stream(side):  # warm-up: the allocations settle
            for _ in range(2):
                _augment(*args)
        torch.cuda.current_stream(images.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = _augment(*args)
        self.done = torch.cuda.Event()

    def load(self, images, flats: dict) -> None:
        self.images.copy_(images)
        for d, f in flats.items():
            self.flats[d].copy_(f.pin_memory(), non_blocking=True)


class _Replays:
    """The captured pipelines by (shape, device, crop size, ops, quantize):
    the host's cost of a batch is one plan, one copy a dtype and one
    replay, not the few hundred launches of the ops. One caller at a time
    (a lock, and each replay's stream waits for the previous use's event);
    the oldest of more than ``keep`` entries is dropped with its memory."""

    def __init__(self, keep: int = 4):
        self.keep = keep
        self.entries: dict = {}
        self.lock = threading.Lock()

    def run(self, images, tensors: list, quantize: bool) -> torch.Tensor:
        key = (tuple(images.shape), images.device, tuple(tensors[0].shape),
               len(tensors), quantize)
        stream = torch.cuda.current_stream(images.device)
        with self.lock:
            entry = self.entries.pop(key, None)
            if entry is None:
                entry = _Replay(images, tensors, quantize)
                while len(self.entries) >= self.keep:
                    self.entries.pop(next(iter(self.entries)))
            else:
                stream.wait_event(entry.done)
                entry.load(images, _flat(tensors))
            self.entries[key] = entry
            entry.graph.replay()
            out = entry.out.clone()
            entry.done.record(stream)
            return out


_REPLAYS = _Replays()


def release_graphs() -> None:
    """Drop the captured pipelines, and with them the card memory their
    graphs hold (the next call on the card captures again)."""
    with _REPLAYS.lock:
        _REPLAYS.entries.clear()


def apply_augment(images: torch.Tensor, params: AugmentParams, *,
                  img_size: int = 224,
                  randaugment: Optional[Tuple[int, float]] = (2, 9.0),
                  mean: Optional[Sequence[float]] = None,
                  std: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Apply drawn parameters to a raw uint8 HWC batch [B, H, W, 3] where
    it lies → normalized NCHW fp32 [B, 3, S, S]: crop-resize (the flip
    folded in), then, when ``randaugment`` is set, the batch rounded to the
    u8 grid and each drawn op, then the normalization. On the card the plan
    goes up in one copy a dtype and the pipeline runs as a captured CUDA
    graph; on the CPU as its ops."""
    _, h, w, _ = images.shape
    tensors = _plan(params, h, w, img_size,
                    IMAGENET_MEAN if mean is None else mean,
                    IMAGENET_STD if std is None else std)
    quantize = randaugment is not None
    if images.device.type == "cuda":
        return _REPLAYS.run(images, tensors, quantize)
    return _augment(images, quantize, *map(torch.from_numpy, tensors))


def device_augment(
    images: torch.Tensor,
    generator: torch.Generator,
    *,
    img_size: int = 224,
    rrc_scale: Tuple[float, float] = (0.08, 1.0),
    rrc_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    hflip: float = 0.5,
    randaugment: Optional[Tuple[int, float]] = (2, 9.0),
    magnitude_std: float = 0.5,
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """RandomResizedCrop → flip → RandAugment → normalize for a raw
    **uint8 HWC batch** [B, H, W, 3] where it lies (the card in training)
    → NCHW fp32 [B, 3, S, S]: the parameters drawn from the CPU
    ``generator`` (:func:`draw_augment_params`), then applied
    (:func:`apply_augment`). Pair with :func:`..augment.device_mixup_cutmix`
    for the DeiT recipe; ``Trainer(device_augment=...)`` runs both."""
    if images.dtype != torch.uint8 or images.ndim != 4 \
            or images.shape[-1] != 3:
        raise ValueError(
            "device_augment takes raw uint8 HWC batches [B, H, W, 3]; got "
            f"{images.dtype} {tuple(images.shape)}")
    params = draw_augment_params(
        generator, images.shape[0], images.shape[1], images.shape[2],
        rrc_scale=rrc_scale, rrc_ratio=rrc_ratio, hflip=hflip,
        randaugment=randaugment, magnitude_std=magnitude_std)
    return apply_augment(images, params, img_size=img_size,
                         randaugment=randaugment, mean=mean, std=std)


def step_generators(seed: int, step: int) -> tuple:
    """The CPU generators of training step ``step`` under ``seed``: (the
    augment's, the mix's). A function of (seed, step) alone, so a resumed
    run draws what the unbroken run drew."""
    states = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    return tuple(torch.Generator().manual_seed(int(s)) for s in states)


def raw_batches(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    *,
    epochs: Optional[int] = 1,
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[tuple]:
    """The loader that pairs with :func:`device_augment`: shuffle and slice
    only, one uint8 gather a batch. Yields ``(uint8 HWC batch, int
    labels)``, shuffled per epoch by NumPy's generator seeded with ``seed +
    epoch`` (the JAX package's order); feed through ``DevicePrefetcher``
    and a Trainer configured with ``device_augment=``/``mixup=``."""
    n = images.shape[0]
    if images.dtype != np.uint8:
        raise ValueError(f"raw_batches ships uint8 (got {images.dtype}); "
                         "3x less host->device traffic than fp32")
    epoch = 0
    while epochs is None or epoch < epochs:
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(n)
        stop = n - batch_size + 1 if drop_last else n
        for lo in range(0, max(stop, 0), batch_size):
            idx = order[lo:lo + batch_size]
            yield images[idx], labels[idx]
        epoch += 1

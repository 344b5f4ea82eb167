"""The port's host augmentation (``augment.py``) against the JAX package's,
and its batch mix on tensors (``device_mixup_cutmix``).

The host pipeline is the JAX package's NumPy code, so for the same seeds
every transform, ``rand_augment``, ``mixup_cutmix`` and ``augmented_dataset``
(both mix placements, 1 and 2 workers) must give the same bits. The batch
mix on tensors draws from a ``torch.Generator``: given the same λ and box it
is ``mixup_cutmix``'s arithmetic (Mixup within 1e-6, CutMix exact), and
given JAX's own draws it is JAX's ``device_mixup_cutmix``. The rest mirrors
``tests/test_augment.py``: seeded determinism, per-op semantics, the label
math, the composed dataset and the recipe through ``Trainer``.

Sizes: 48x64 and 40x40 sources, 24- and 32-pixel crops, tiny configs.
"""
from __future__ import annotations

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu import augment as jaug
from vit_with_opencl_tpu import config as jconfig
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.parallel import spmd as jspmd
from vit_with_opencl_tpu_torch import ViTConfig, augment, optim
from vit_with_opencl_tpu_torch.models import vit
from vit_with_opencl_tpu_torch.parallel import spmd
from vit_with_opencl_tpu_torch.train import Trainer

CPU = "cpu"


def _img(h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


# -- the host transforms, bit-identical to the JAX package's ---------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kw", [{}, {"scale": (0.5, 1.0), "ratio": (0.5, 2.0)},
                                {"scale": (1.0, 1.0), "ratio": (1.0, 4 / 3)}])
def test_rrc_bit_identical_to_jax(seed, kw):
    img = _img(seed=seed)
    got = augment.random_resized_crop(np.random.default_rng(seed), img, 24, **kw)
    want = jaug.random_resized_crop(np.random.default_rng(seed), img, 24, **kw)
    np.testing.assert_array_equal(got, want)
    # The NumPy resize (float input) too.
    img = img.astype(np.float32)
    np.testing.assert_array_equal(
        augment.random_resized_crop(np.random.default_rng(seed), img, 24, **kw),
        jaug.random_resized_crop(np.random.default_rng(seed), img, 24, **kw))


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_hflip_bit_identical_to_jax(p):
    img = _img()
    for seed in range(4):
        np.testing.assert_array_equal(
            augment.random_hflip(np.random.default_rng(seed), img, p),
            jaug.random_hflip(np.random.default_rng(seed), img, p))


# Each op at two arguments of its production range (the sign of a signed op
# negative in the second), on uint8 (PIL's path where PIL decides) and, for
# the affine ops, on float input (their NumPy path).
_OP_ARGS = {
    "identity": (0, 0), "autocontrast": (0, 0), "equalize": (0, 0),
    "posterize": (5.2, 4), "solarize": (128, 0), "brightness": (1.45, 0.55),
    "contrast": (1.9, 0.1), "color": (0.1, 1.63), "sharpness": (1.63, 0.37),
    "shear_x": (0.22, -0.3), "shear_y": (0.15, -0.12),
    "translate_x": (0.3, -0.45), "translate_y": (0.45, -0.12),
    "rotate": (17.0, -30.0),
}


@pytest.mark.parametrize("name", list(_OP_ARGS))
def test_ops_bit_identical_to_jax(name):
    assert list(augment.RAND_AUGMENT_OPS) == list(jaug.RAND_AUGMENT_OPS)
    ours = augment.RAND_AUGMENT_OPS[name][0]
    theirs = jaug.RAND_AUGMENT_OPS[name][0]
    imgs = [_img(seed=4)]
    if name in ("shear_x", "shear_y", "translate_x", "translate_y", "rotate"):
        imgs.append(_img(33, 33, seed=5).astype(np.float32))
    for img in imgs:
        for arg in _OP_ARGS[name]:
            got, want = ours(img, arg), theirs(img, arg)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"num_ops": 3, "magnitude": 5.0},
                                {"magnitude_std": 0.0},
                                {"ops": ("rotate", "equalize", "color")}])
def test_rand_augment_bit_identical_to_jax(kw):
    img = _img(seed=6)
    for seed in range(6):
        np.testing.assert_array_equal(
            augment.rand_augment(np.random.default_rng(seed), img, **kw),
            jaug.rand_augment(np.random.default_rng(seed), img, **kw))


def _batch(b=8, c=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 3, 16, 16)).astype(np.float32),
            rng.integers(0, c, b))


@pytest.mark.parametrize("kw", [{}, {"mixup_alpha": 0.0}, {"cutmix_alpha": 0.0},
                                {"prob": 0.5}, {"switch_prob": 0.9}])
def test_mixup_cutmix_bit_identical_to_jax(kw):
    images, labels = _batch()
    for seed in range(6):
        got = augment.mixup_cutmix(np.random.default_rng(seed), images, labels,
                                   10, **kw)
        want = jaug.mixup_cutmix(np.random.default_rng(seed), images, labels,
                                 10, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    nhwc = images.transpose(0, 2, 3, 1).copy()  # the NHWC box
    for a, b in zip(augment.mixup_cutmix(np.random.default_rng(1), nhwc, labels,
                                         10, mixup_alpha=0.0),
                    jaug.mixup_cutmix(np.random.default_rng(1), nhwc, labels,
                                      10, mixup_alpha=0.0)):
        np.testing.assert_array_equal(a, b)


def _raw_dataset(n=12, hw=40, c=7, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    labels = rng.integers(0, c, n)
    return images, labels


@pytest.mark.parametrize("mix", ["host", "device"])
@pytest.mark.parametrize("workers", [1, 2])
def test_augmented_dataset_bit_identical_to_jax(mix, workers):
    images, labels = _raw_dataset()
    kw = dict(img_size=24, epochs=2, seed=11, mix=mix)
    got = list(augment.augmented_dataset(images, labels, 4, 7, workers=workers,
                                         **kw))
    want = list(jaug.augmented_dataset(images, labels, 4, 7, **kw))
    assert len(got) == len(want) == 6
    for (xa, ya), (xb, yb) in zip(got, want):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


# -- RandomResizedCrop ------------------------------------------------------


def test_rrc_shape_dtype_and_determinism():
    img = _img()
    a = augment.random_resized_crop(np.random.default_rng(7), img, 32)
    b = augment.random_resized_crop(np.random.default_rng(7), img, 32)
    c = augment.random_resized_crop(np.random.default_rng(8), img, 32)
    assert a.shape == (32, 32, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_rrc_full_scale_is_resize():
    img = _img(40, 40)
    out = augment.random_resized_crop(np.random.default_rng(0), img, 20,
                                      scale=(1.0, 1.0), ratio=(1.0, 1.0))
    np.testing.assert_allclose(out, augment._resize(img, 20))


def test_rrc_fallback_center_crop():
    """Image 2:1, ratio capped at 4:3: the largest center crop at 4:3."""
    img = _img(32, 64)
    out = augment.random_resized_crop(np.random.default_rng(0), img, 16,
                                      scale=(1.0, 1.0), ratio=(1.0, 4.0 / 3.0))
    cw = round(32 * 4.0 / 3.0)
    left = (64 - cw) // 2
    np.testing.assert_allclose(out, augment._resize(img[:, left:left + cw], 16))


def test_hflip_edges():
    img = _img()
    np.testing.assert_array_equal(
        augment.random_hflip(np.random.default_rng(0), img, p=1.0), img[:, ::-1])
    np.testing.assert_array_equal(
        augment.random_hflip(np.random.default_rng(0), img, p=0.0), img)


# -- RandAugment op semantics ----------------------------------------------


def test_identity_points():
    img = _img()
    ops = augment.RAND_AUGMENT_OPS
    np.testing.assert_array_equal(ops["posterize"][0](img, 8), img)
    np.testing.assert_array_equal(ops["solarize"][0](img, 256), img)
    for name in ("brightness", "contrast", "color", "sharpness"):
        np.testing.assert_array_equal(ops[name][0](img, 1.0), img)
    np.testing.assert_array_equal(ops["translate_x"][0](img, 0.0), img)
    np.testing.assert_array_equal(ops["rotate"][0](img, 0.0), img)


def test_photometric_actions():
    img = _img()
    ops = augment.RAND_AUGMENT_OPS
    assert ops["brightness"][0](img, 0.0).max() == 0
    np.testing.assert_array_equal(ops["solarize"][0](img, 0), 255 - img)
    assert (ops["posterize"][0](img, 4) & 0x0F).max() == 0
    shifted = (img // 2 + 64).astype(np.uint8)  # range [64, 191]
    ac = ops["autocontrast"][0](shifted, 0)
    for c in range(3):
        assert ac[..., c].min() == 0 and ac[..., c].max() == 255
    g = ops["color"][0](img, 0.0)
    assert np.array_equal(g[..., 0], g[..., 1])
    assert np.array_equal(g[..., 1], g[..., 2])


def test_equalize_matches_pil():
    from PIL import Image, ImageOps

    rng = np.random.default_rng(0)
    img = ((rng.random((64, 64, 3)) ** 4) * 255).astype(np.uint8)
    eq = augment.RAND_AUGMENT_OPS["equalize"][0](img, 0)
    np.testing.assert_array_equal(eq, np.asarray(ImageOps.equalize(
        Image.fromarray(img))))
    h0 = np.bincount(img[..., 0].ravel(), minlength=256)
    h1 = np.bincount(eq[..., 0].ravel(), minlength=256)
    assert h1[230:].sum() > 3 * h0[230:].sum()


def test_translate_moves_content_exactly():
    img = _img(32, 32)
    out = augment.RAND_AUGMENT_OPS["translate_x"][0](img, 0.25)
    np.testing.assert_array_equal(out[:, 8:], img[:, :-8])
    assert (out[:, :8] == 128).all()


def test_rotate_90_matches_numpy():
    img = _img(33, 33)
    out = augment.RAND_AUGMENT_OPS["rotate"][0](img, 90.0)
    diff = out[1:-1, 1:-1].astype(int) - np.rot90(img)[1:-1, 1:-1].astype(int)
    assert np.abs(diff).max() <= 1


def test_rand_augment_deterministic_and_u8():
    img = _img()
    a = augment.rand_augment(np.random.default_rng(3), img)
    b = augment.rand_augment(np.random.default_rng(3), img)
    c = augment.rand_augment(np.random.default_rng(4), img)
    assert a.dtype == np.uint8 and a.shape == img.shape
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_refusals_match_jax():
    """Bad inputs raise the JAX package's ValueErrors."""
    images, labels = _raw_dataset()
    calls = [
        lambda m: m.rand_augment(np.random.default_rng(0),
                                 _img().astype(np.float32)),
        lambda m: next(iter(m.augmented_dataset(images.astype(np.float32),
                                                labels, 4, 7, img_size=24))),
        lambda m: next(iter(m.augmented_dataset(images, labels[:5], 4, 7,
                                                img_size=24))),
        lambda m: next(iter(m.augmented_dataset(images, labels, 4, 7,
                                                img_size=24, mix="both"))),
    ]
    for call in calls:
        with pytest.raises(ValueError) as theirs:
            call(jaug)
        with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
            call(augment)


# -- Mixup / CutMix ----------------------------------------------------------


def test_mixup_label_math():
    images, labels = _batch()
    mixed, soft = augment.mixup_cutmix(np.random.default_rng(1), images, labels,
                                       10, mixup_alpha=0.8, cutmix_alpha=0.0)
    assert soft.shape == (8, 10)
    np.testing.assert_allclose(soft.sum(-1), 1.0, atol=1e-6)
    lam = (mixed[0] - images[-1]).ravel() @ (images[0] - images[-1]).ravel() \
        / np.sum((images[0] - images[-1]) ** 2)
    onehot = np.eye(10, dtype=np.float32)[labels]
    np.testing.assert_allclose(soft, lam * onehot + (1 - lam) * onehot[::-1],
                               atol=1e-5)
    np.testing.assert_allclose(mixed, lam * images + (1 - lam) * images[::-1],
                               atol=1e-5)


def test_cutmix_box_matches_lambda():
    images, labels = _batch()
    mixed, soft = augment.mixup_cutmix(np.random.default_rng(2), images, labels,
                                       10, mixup_alpha=0.0, cutmix_alpha=1.0)
    changed = np.any(mixed != images, axis=(0, 1))
    onehot = np.eye(10, dtype=np.float32)[labels]
    assert changed.any()
    lam = 1.0 - changed.mean()
    box = np.argwhere(changed)
    (y0, x0), (y1, x1) = box.min(0), box.max(0) + 1
    assert changed[y0:y1, x0:x1].all()
    np.testing.assert_array_equal(mixed[:, :, y0:y1, x0:x1],
                                  images[::-1][:, :, y0:y1, x0:x1])
    np.testing.assert_allclose(soft, lam * onehot + (1 - lam) * onehot[::-1],
                               atol=1e-6)


def test_mix_disabled_returns_onehot():
    images, labels = _batch()
    mixed, soft = augment.mixup_cutmix(np.random.default_rng(0), images, labels,
                                       10, mixup_alpha=0.0, cutmix_alpha=0.0)
    np.testing.assert_array_equal(mixed, images)
    np.testing.assert_array_equal(soft, np.eye(10, dtype=np.float32)[labels])


# -- the batch mix on tensors ---------------------------------------------


def _host_draws(rng, h, w, *, mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0,
                switch_prob=0.5):
    """The draws ``mixup_cutmix`` makes from ``rng``, in its order, as the
    port's parameters."""
    use_cutmix = cutmix_alpha > 0 and (mixup_alpha <= 0
                                       or rng.random() < switch_prob)
    if prob <= 0.0 or rng.random() >= prob or (mixup_alpha <= 0
                                               and cutmix_alpha <= 0):
        return augment.MixParams(False, use_cutmix, 1.0, 0, 0)
    alpha = cutmix_alpha if use_cutmix else mixup_alpha
    lam = float(rng.beta(alpha, alpha))
    cy = cx = 0
    if use_cutmix:
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    return augment.MixParams(True, use_cutmix, lam, cy, cx)


@pytest.mark.parametrize("kw", [{}, {"mixup_alpha": 0.0}, {"cutmix_alpha": 0.0},
                                {"prob": 0.5}])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_mix_apply_equals_host_arithmetic(kw, layout):
    """Given the λ and box ``mixup_cutmix`` drew, the tensor mix is its
    arithmetic: CutMix and the labels exact, Mixup within 1e-6."""
    images, labels = _batch()
    if layout == "nhwc":
        images = images.transpose(0, 2, 3, 1).copy()
    for seed in range(8):
        want_x, want_y = augment.mixup_cutmix(np.random.default_rng(seed),
                                              images, labels, 10, **kw)
        params = _host_draws(np.random.default_rng(seed), 16, 16, **kw)
        got_x, got_y = augment.apply_mixup_cutmix(
            torch.from_numpy(images), torch.from_numpy(labels), 10, params)
        np.testing.assert_array_equal(got_y.numpy(), want_y)
        if params.apply and not params.cutmix:
            np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got_x.numpy(), want_x)


@pytest.mark.parametrize("kw", [{}, {"mixup_alpha": 0.0}, {"cutmix_alpha": 0.0},
                                {"prob": 0.5}])
def test_mix_apply_equals_jax_on_its_draws(kw):
    """JAX's ``device_mixup_cutmix`` on a key, against the port's apply on
    the parameters that key draws (replayed with jax.random, as JAX's
    function splits it)."""
    images, labels = _batch()
    mixup_alpha = kw.get("mixup_alpha", 0.8)
    cutmix_alpha = kw.get("cutmix_alpha", 1.0)
    prob = kw.get("prob", 1.0)
    for seed in range(6):
        key = jax.random.key(seed)
        want_x, want_y = (np.asarray(a) for a in jaug.device_mixup_cutmix(
            key, jnp.asarray(images), jnp.asarray(labels), 10, **kw))
        k_sel, k_lam_m, k_lam_c, k_box, k_prob = jax.random.split(key, 5)
        use_cutmix = (cutmix_alpha > 0 and mixup_alpha <= 0) or (
            cutmix_alpha > 0 and bool(jax.random.bernoulli(k_sel, 0.5)))
        lam = float(jax.random.beta(k_lam_c if use_cutmix else k_lam_m,
                                    cutmix_alpha if use_cutmix else mixup_alpha,
                                    cutmix_alpha if use_cutmix else mixup_alpha))
        cy = int(jax.random.randint(k_box, (), 0, 16))
        cx = int(jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, 16))
        apply = prob >= 1.0 or bool(jax.random.bernoulli(k_prob, prob))
        got_x, got_y = augment.apply_mixup_cutmix(
            torch.from_numpy(images), torch.from_numpy(labels), 10,
            augment.MixParams(apply, use_cutmix, lam, cy, cx))
        if apply and use_cutmix:
            np.testing.assert_array_equal(got_x.numpy(), want_x)
        else:
            np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_y.numpy(), want_y, rtol=0, atol=1e-6)


def test_device_mixup_matches_host_math():
    """Mixup branch: pixel λ equals label λ, soft rows sum to 1, and the
    result is a function of the generator's seed."""
    images, labels = _batch()

    def run(seed):
        x, y = augment.device_mixup_cutmix(
            torch.Generator().manual_seed(seed), torch.from_numpy(images),
            torch.from_numpy(labels), 10, mixup_alpha=0.8, cutmix_alpha=0.0)
        return x.numpy(), y.numpy()

    mixed, soft = run(3)
    np.testing.assert_allclose(soft.sum(-1), 1.0, atol=1e-5)
    lam = (mixed[0] - images[-1]).ravel() @ (images[0] - images[-1]).ravel() \
        / np.sum((images[0] - images[-1]) ** 2)
    onehot = np.eye(10, dtype=np.float32)[labels]
    np.testing.assert_allclose(soft, lam * onehot + (1 - lam) * onehot[::-1],
                               atol=1e-4)
    again = run(3)
    np.testing.assert_array_equal(mixed, again[0])
    np.testing.assert_array_equal(soft, again[1])
    assert not np.array_equal(mixed, run(4)[0])


def test_device_cutmix_box_matches_lambda():
    images, labels = _batch()
    for seed in range(4):
        mixed, soft = (t.numpy() for t in augment.device_mixup_cutmix(
            torch.Generator().manual_seed(seed), torch.from_numpy(images),
            torch.from_numpy(labels), 10, mixup_alpha=0.0, cutmix_alpha=1.0))
        changed = np.any(mixed != images, axis=(0, 1))
        onehot = np.eye(10, dtype=np.float32)[labels]
        lam = 1.0 - changed.mean()
        np.testing.assert_array_equal(
            np.where(changed[None, None], images[::-1], images), mixed)
        np.testing.assert_allclose(soft, lam * onehot + (1 - lam) * onehot[::-1],
                                   atol=1e-5)


def test_mix_draws_are_fixed_in_number():
    """Every draw takes the same share of the generator's stream, so later
    draws do not depend on what an earlier one decided; the gate fires at
    about ``prob``."""
    g, h = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    augment.draw_mix_params(g, 16, 16, prob=0.3)
    augment.draw_mix_params(h, 16, 16, mixup_alpha=0.0)
    assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=h))
    g = torch.Generator().manual_seed(0)
    draws = [augment.draw_mix_params(g, 16, 16, prob=0.5) for _ in range(400)]
    assert 0.4 < np.mean([d.apply for d in draws]) < 0.6
    assert 0.4 < np.mean([d.cutmix for d in draws]) < 0.6
    assert all(0.0 <= d.lam <= 1.0 and 0 <= d.cy < 16 for d in draws)


# -- the composed dataset ----------------------------------------------------


def test_augmented_dataset_shapes_and_determinism():
    images, labels = _raw_dataset()
    kw = dict(img_size=24, epochs=2, seed=11, randaugment=(2, 9.0))
    a = list(augment.augmented_dataset(images, labels, 4, 7, **kw))
    b = list(augment.augmented_dataset(images, labels, 4, 7, **kw))
    assert len(a) == 6
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.shape == (4, 3, 24, 24) and xa.dtype == np.float32
        assert ya.shape == (4, 7)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    assert abs(a[0][0]).max() < 8.0


def test_augmented_dataset_workers_bit_identical():
    images, labels = _raw_dataset()
    kw = dict(img_size=24, epochs=1, seed=2, mixup_alpha=0.0, cutmix_alpha=0.0)
    a = list(augment.augmented_dataset(images, labels, 4, 7, workers=1, **kw))
    b = list(augment.augmented_dataset(images, labels, 4, 7, workers=4, **kw))
    assert len(a) == len(b) == 3
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_augmented_dataset_device_mix_mode():
    images, labels = _raw_dataset()
    x, y = next(iter(augment.augmented_dataset(images, labels, 4, 7,
                                               img_size=24, mix="device")))
    assert y.ndim == 1 and np.issubdtype(y.dtype, np.integer)
    assert x.shape == (4, 3, 24, 24)


# -- the recipe through the Trainer -------------------------------------------

TINY = ViTConfig(name="aug_e2e", img_size=24, patch_size=8, embed_dim=32,
                 depth=2, num_heads=2, num_classes=7)


def test_trainer_deit_recipe_end_to_end():
    """Host augment → soft-label CE → AdamW + EMA: finite loss, fp32 EMA."""
    images, labels = _raw_dataset(n=16, hw=32, c=7, seed=3)
    tr = Trainer(TINY, device=CPU, lr=1e-3, optimizer="adamw", ema_decay=0.9,
                 compute_dtype=torch.float32, log_every=0)
    tr.fit(augment.augmented_dataset(images, labels, 8, 7, img_size=24,
                                     epochs=4, seed=5, randaugment=(1, 5.0)))
    assert tr.step_idx == 8 and np.isfinite(tr.last_loss)
    assert all(t.dtype == torch.float32
               for t in optim.tree_leaves(tr.ema_params))


def test_trainer_device_mixup_end_to_end():
    """mix='device' dataset + Trainer(mixup=...): the mix runs in front of
    the step; the loss is finite and the steps advance."""
    images, labels = _raw_dataset(n=16, hw=32, c=7, seed=4)
    tr = Trainer(TINY, device=CPU, lr=1e-3, optimizer="adamw", log_every=0,
                 compute_dtype=torch.float32,
                 mixup=dict(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5))
    tr.fit(augment.augmented_dataset(images, labels, 8, 7, img_size=24,
                                     epochs=3, seed=6, randaugment=None,
                                     mix="device"))
    assert tr.step_idx == 6 and np.isfinite(tr.last_loss)


SMALL = ViTConfig(name="soft_loss", img_size=16, patch_size=8, embed_dim=32,
                  depth=1, num_heads=2, num_classes=5)
JSMALL = jconfig.ViTConfig(name="soft_loss", img_size=16, patch_size=8,
                           embed_dim=32, depth=1, num_heads=2, num_classes=5)


def _soft_batch(b):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(b, 3, 16, 16)).astype(np.float32),
            rng.dirichlet(np.ones(5), size=b).astype(np.float32))


def test_soft_label_loss_matches_manual_and_jax():
    """The soft-label CE is −mean(Σ soft · log p), as JAX's step computes
    it."""
    images, soft = _soft_batch(4)
    host = jax.tree.map(np.asarray, jvit.random_stacked_params(
        JSMALL, jax.random.key(0), jnp.float32))
    step = spmd.make_train_step(SMALL, device=CPU, lr=0.0, optimizer="sgd")
    _, loss = step(vit.params_from_jax(host, device=CPU),
                   torch.from_numpy(images), torch.from_numpy(soft))
    with torch.no_grad():
        logits = vit.forward(torch.from_numpy(images),
                             vit.params_from_jax(host, device=CPU), SMALL,
                             compute_dtype=torch.float32, return_logits=True)
    expect = -torch.mean(torch.sum(torch.from_numpy(soft)
                                   * torch.log_softmax(logits, -1), -1))
    np.testing.assert_allclose(float(loss), float(expect), rtol=1e-6)
    jstep = jspmd.make_train_step(JSMALL, jspmd.make_mesh(data=1, model=1),
                                  lr=0.0, optimizer="sgd")
    _, jloss = jstep(jax.tree.map(jnp.asarray, host), images, soft)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_soft_labels_through_grad_accum():
    images, soft = _soft_batch(8)
    params = vit.init_params(SMALL, seed=0, device=CPU)
    copy = optim.tree_map(torch.clone, params)
    step1 = spmd.make_train_step(SMALL, device=CPU, lr=1e-2, optimizer="sgd")
    step2 = spmd.make_train_step(SMALL, device=CPU, lr=1e-2, optimizer="sgd",
                                 grad_accum=4)
    p1, l1 = step1(params, torch.from_numpy(images), torch.from_numpy(soft))
    p2, l2 = step2(copy, torch.from_numpy(images), torch.from_numpy(soft))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(optim.tree_leaves(p1), optim.tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-6)


def test_resize_backend_without_pil(monkeypatch):
    """``_resize`` runs PIL where it imports, else the NumPy bilinear
    fallback, and ``resize_backend`` says which."""
    import sys

    from vit_with_opencl_tpu_torch.io.preprocess import _resize_bilinear_np

    img = _img(40, 40)
    assert augment.resize_backend() == "PIL"
    with_pil = augment._resize(img, 20)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now fails
    assert augment.resize_backend() == "NumPy"
    np.testing.assert_array_equal(augment._resize(img, 20),
                                  _resize_bilinear_np(img, 20, 20))
    assert not np.array_equal(with_pil, _resize_bilinear_np(img, 20, 20))

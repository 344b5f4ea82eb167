"""The port's on-card augmentation (``augment_device.py``) on the CPU against
the JAX package's device functions, on the same drawn parameters.

JAX draws from ``jax.random`` keys and the port from ``torch.Generator``s,
so the draws differ by construction; parity is pinned where the draws end.
Every RandAugment op is held to JAX's twin on fixed arguments within JAX's
own bound of one level (``atol=1.0 + 1e-6``, the share of exact pixels
printed); equalize, posterize, solarize and the flip are bit-identical; the
crop resample is within ``rtol=1e-5, atol=1e-3`` of JAX's; the whole pipeline
on a batch's drawn parameters is held to JAX's functions composed on the
same parameters. The rest mirrors ``tests/test_augment_device.py``:
structure, determinism, the box sampler's bounds, the loader.

Sizes: 32x32 and 40x40 sources, 16- to 32-pixel crops.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu import augment as jaug
from vit_with_opencl_tpu import augment_device as jdev
from vit_with_opencl_tpu.io.preprocess import _resize_bilinear_np
from vit_with_opencl_tpu_torch import augment, augment_device
from vit_with_opencl_tpu_torch.io.preprocess import IMAGENET_MEAN, IMAGENET_STD

OP_TOL = 1.0 + 1e-6
EXACT_OPS = {"identity", "equalize", "posterize", "solarize"}


@pytest.fixture(scope="module")
def img_u8():
    rng = np.random.default_rng(7)
    # Gradients and noise, plus saturated patches for autocontrast's edges.
    base = np.linspace(0, 255, 32, dtype=np.float32)
    img = (base[:, None, None] + base[None, :, None] / 2
           + rng.normal(0, 30, (32, 32, 3))).clip(0, 255)
    img[:4, :4] = 255.0
    img[-4:, -4:] = 0.0
    return np.round(img).astype(np.uint8)


def _ours(name, img, arg):
    """The port's op on one image [H, W, 3] with one argument."""
    fn = getattr(augment_device, f"_{name}")
    return fn(torch.from_numpy(np.asarray(img, np.float32))[None],
              torch.tensor([arg], dtype=torch.float32))[0].numpy()


def _held(name, got, want):
    same = float(np.mean(got == want))
    print(f"{name}: max abs err {np.abs(got - want).max():.3g}, "
          f"{same:.4%} of pixels exact")
    if name in EXACT_OPS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


_OP_CASES = [
    ("identity", 0.0), ("autocontrast", 0.0), ("equalize", 0.0),
    ("posterize", 5.2), ("posterize", 4.0), ("solarize", 128.0),
    ("solarize", 0.0), ("brightness", 1.45), ("brightness", 0.55),
    ("contrast", 1.9), ("color", 0.1), ("sharpness", 1.63),
]


@pytest.mark.parametrize("name,arg", _OP_CASES)
def test_photometric_op_twins(img_u8, name, arg):
    """Against JAX's device op, and (as JAX's test holds JAX's) against the
    host op: both round through uint8."""
    got = _ours(name, img_u8, arg)
    _held(name, got, np.asarray(getattr(jdev, f"_{name}")(
        jnp.asarray(img_u8, jnp.float32), arg)))
    host = augment.RAND_AUGMENT_OPS[name][0](img_u8, arg).astype(np.float32)
    np.testing.assert_allclose(got, host, atol=OP_TOL)
    assert np.mean(got != host) < 0.02


@pytest.mark.parametrize("name,arg", [
    ("shear_x", 0.22), ("shear_y", -0.15), ("translate_x", 0.3),
    ("translate_y", -0.12), ("translate_x", -0.45), ("translate_y", 0.45),
    ("rotate", 17.0), ("rotate", -30.0),
])
def test_affine_op_twins(img_u8, name, arg):
    """Against JAX's device op; shears and translations also against the
    host's NumPy ``_affine`` (float input), which the single-axis warp
    computes exactly."""
    got = _ours(name, img_u8, arg)
    _held(name, got, np.asarray(getattr(jdev, f"_{name}")(
        jnp.asarray(img_u8, jnp.float32), arg)))
    if name != "rotate":
        host = augment.RAND_AUGMENT_OPS[name][0](img_u8.astype(np.float32), arg)
        np.testing.assert_allclose(got, host.astype(np.float32), atol=OP_TOL)
        assert np.mean(got != host) < 0.02


def test_rotate_geometry_matches_direct_resample():
    """Paeth's three shears and the host's single resample differ only by
    interpolation: interior pixels agree on smooth content."""
    y, x = np.mgrid[0:32, 0:32].astype(np.float32)
    smooth = np.stack([y * 8, x * 8, (y + x) * 4], axis=-1)
    want = augment.RAND_AUGMENT_OPS["rotate"][0](smooth, 21.0)
    got = _ours("rotate", smooth, 21.0)
    inner = (slice(8, 24), slice(8, 24))
    assert np.abs(got[inner] - want.astype(np.float32)[inner]).mean() < 3.0


@pytest.mark.parametrize("g,m,sign", [
    (0, 9.0, False), (1, 7.0, True), (2, 9.5, False), (3, 6.0, True),
    (4, 10.0, True), (4, 9.0, False),
])
def test_geometric_ops_match_jax_geom_apply(img_u8, g, m, sign):
    """The port's geometric op at (magnitude, sign) against JAX's fused
    parameter-selected warp, its RandAugment path."""
    k = 9 + g
    v = torch.from_numpy(augment_device.op_arguments(
        np.array([k]), np.array([m], np.float32), np.array([sign])))
    got = augment_device.DEVICE_RAND_AUGMENT_OPS[k][1](
        torch.from_numpy(img_u8.astype(np.float32))[None], v)[0].numpy()
    want = np.asarray(jdev._geom_apply(jnp.asarray(img_u8, jnp.float32),
                                       jnp.int32(k), jnp.float32(m),
                                       jnp.asarray(sign)))
    _held(augment_device.DEVICE_RAND_AUGMENT_OPS[k][0], got, want)


def test_op_table_and_arguments_match_jax():
    """The same table order and, for every op, magnitude and sign, the
    argument JAX's RandAugment branch computes."""
    assert [r[0] for r in augment_device.DEVICE_RAND_AUGMENT_OPS] == \
        [r[0] for r in jdev.DEVICE_RAND_AUGMENT_OPS] == list(jaug.RAND_AUGMENT_OPS)
    m = np.array([0.0, 3.3, 9.0, 10.0] * 2, np.float32)
    sign = np.array([False] * 4 + [True] * 4)
    for k, (_, _, lvl, signed) in enumerate(jdev.DEVICE_RAND_AUGMENT_OPS):
        v = lvl(jnp.asarray(m))
        if signed:
            mirrored = 2.0 - v if k in jdev._ENHANCE_IDX else -v
            v = jnp.where(jnp.asarray(sign), mirrored, v)
        np.testing.assert_array_equal(
            augment_device.op_arguments(np.full(8, k), m, sign), np.asarray(v))


def test_batched_ops_equal_one_image_at_a_time(img_u8):
    """Each op on a batch with an argument an image equals the op on each
    image alone; a group of the six table ops (``_photometric``) or of the
    five affine ops (``_geometry``), each image with its own op, equals
    each image's op alone (the groups of a step are such batches)."""
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(np.stack([
        img_u8, img_u8[::-1], img_u8[:, ::-1],
        rng.integers(0, 256, img_u8.shape)]).astype(np.float32))
    m = np.array([9.0, 4.0, 10.0, 1.5], np.float32)
    sign = np.array([False, True, True, False])
    ops = augment_device.DEVICE_RAND_AUGMENT_OPS
    for k, (name, fn, _, _) in enumerate(ops):
        v = torch.from_numpy(augment_device.op_arguments(np.full(4, k), m, sign))
        batched = fn(imgs, v)
        for i in range(4):
            assert torch.equal(batched[i], fn(imgs[i:i + 1], v[i:i + 1])[0]), name
    for drawn in ([1, 2, 3, 4], [5, 6, 0, 1], [9, 10, 11, 12], [13, 9, 13, 10]):
        op = np.array(drawn)
        v = augment_device.op_arguments(op, m, sign)
        if drawn[0] < 9:
            group = augment_device._photometric(imgs, torch.from_numpy(op),
                                                torch.from_numpy(v))
        else:
            group = augment_device._geometry(imgs, *map(
                torch.from_numpy, augment_device._geometry_taps(op, v, 32, 32)))
        v = torch.from_numpy(v)
        for i, k in enumerate(drawn):
            assert torch.equal(group[i], ops[k][1](imgs[i:i + 1], v[i:i + 1])[0]), \
                (drawn, i)


def test_posterize_identity_at_8_bits(img_u8):
    np.testing.assert_array_equal(_ours("posterize", img_u8, 8.0),
                                  img_u8.astype(np.float32))


def test_crop_resize_matches_jax_and_numpy_bilinear(img_u8):
    """A fixed crop box: within rtol 1e-5, atol 1e-3 of JAX's one-hot
    products and of the host's slice + bilinear; the flip (folded into the
    column taps) is JAX's ``out[:, ::-1]`` bit for bit."""
    top, left, ch, cw = 3, 5, 21, 17

    def one(v):
        return np.array([v])

    def taps(*args, **kw):
        return [torch.from_numpy(t) for t in augment_device._axis_taps(*args, **kw)]

    rows = taps(one(top), one(ch), 16, 32)
    got = augment_device._crop_resize(
        torch.from_numpy(img_u8)[None], *rows,
        *taps(one(left), one(cw), 16, 32))[0].numpy()
    want = np.asarray(jdev._crop_resize(jnp.asarray(img_u8), jnp.int32(top),
                                        jnp.int32(left), jnp.int32(ch),
                                        jnp.int32(cw), 16))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    host = _resize_bilinear_np(
        img_u8[top:top + ch, left:left + cw].astype(np.float32), 16, 16)
    np.testing.assert_allclose(got, host, rtol=1e-5, atol=1e-3)
    flipped = augment_device._crop_resize(
        torch.from_numpy(img_u8)[None], *rows,
        *taps(one(left), one(cw), 16, 32, reverse=np.array([True])))[0].numpy()
    np.testing.assert_array_equal(flipped, got[:, ::-1])


def test_rrc_box_bounds_and_coverage():
    """Sampled boxes stay inside the image and follow the scale range; an
    impossible ratio band takes the center fallback."""
    h = w = 64
    top, left, ch, cw = (t.numpy() for t in augment_device._rrc_box(
        torch.Generator().manual_seed(0), 64, h, w, (0.08, 1.0), (3 / 4, 4 / 3)))
    assert ((ch > 0) & (ch <= h) & (cw > 0) & (cw <= w)).all()
    assert ((top >= 0) & (top <= h - ch) & (left >= 0) & (left <= w - cw)).all()
    assert ((cw / ch >= 0.6) & (cw / ch <= 1.7)).all()
    areas = ch * cw / (h * w)
    assert areas.min() < 0.3 and areas.max() > 0.6
    assert len(set(top.tolist())) > 8
    # 32 x 64 with ratios capped at 4:3 and the whole area asked for: no
    # attempt fits, so the 43-wide center crop, as the host falls back.
    box = augment_device._rrc_box(torch.Generator().manual_seed(1), 4, 32, 64,
                                  (1.0, 1.0), (1.0, 4 / 3))
    want = jdev._rrc_box(jax.random.key(1), 32, 64, (1.0, 1.0), (1.0, 4 / 3))
    for t, j in zip(box, want):
        assert (t.numpy() == int(j)).all()


def _jax_chain(img_u8, p, b, img_size):
    """JAX's device functions composed on the port's drawn parameters for
    image ``b``: crop-resize, flip, the u8 grid, each drawn op (the
    geometric ones through ``_geom_apply``)."""
    out = jdev._crop_resize(jnp.asarray(img_u8), jnp.int32(int(p.top[b])),
                            jnp.int32(int(p.left[b])), jnp.int32(int(p.ch[b])),
                            jnp.int32(int(p.cw[b])), img_size)
    if bool(p.flip[b]):
        out = out[:, ::-1]
    out = jdev._q8(out)
    for j in range(p.op_idx.shape[0]):
        k, m, sign = (int(p.op_idx[j, b]), float(p.magnitude[j, b]),
                      bool(p.sign[j, b]))
        if k >= jdev._GEOM_BASE:
            out = jdev._geom_apply(out, jnp.int32(k), jnp.float32(m),
                                   jnp.asarray(sign))
        else:
            _, op, lvl, signed = jdev.DEVICE_RAND_AUGMENT_OPS[k]
            v = lvl(jnp.float32(m))
            if signed:
                v = jnp.where(sign, 2.0 - v if k in jdev._ENHANCE_IDX else -v, v)
            out = op(out, v)
    return np.asarray(out)


def test_pipeline_matches_jax_chain_on_the_same_draws():
    """``apply_augment`` on a batch's drawn parameters against JAX's
    functions composed image by image on the same parameters, before the
    normalization: within one level, nearly every pixel exact; after it,
    JAX's normalization of the same values."""
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (12, 40, 40, 3), dtype=np.uint8)
    p = augment_device.draw_augment_params(torch.Generator().manual_seed(2), 12,
                                           40, 40, randaugment=(3, 9.0))
    got = augment_device.apply_augment(torch.from_numpy(imgs), p, img_size=24,
                                       randaugment=(3, 9.0)).numpy()
    mean = IMAGENET_MEAN * np.float32(255.0)
    std = IMAGENET_STD * np.float32(255.0)
    pixels = got.transpose(0, 2, 3, 1) * std + mean
    want = np.stack([_jax_chain(imgs[b], p, b, 24) for b in range(12)])
    same = float(np.mean(np.abs(pixels - want) < 1e-3))
    print(f"pipeline vs JAX's chain: max abs err "
          f"{np.abs(pixels - want).max():.3g} levels, {same:.4%} exact")
    np.testing.assert_allclose(pixels, want, rtol=0, atol=OP_TOL)
    assert same > 0.99
    assert len(set(p.op_idx.flatten().tolist())) > 8  # most ops drawn


def test_identity_draws_leave_the_crop():
    """Every op drawn as the identity: the pipeline is crop, flip, the u8
    grid and the normalization."""
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    p = augment_device.draw_augment_params(torch.Generator().manual_seed(0), 4,
                                           32, 32)
    p = p._replace(op_idx=torch.zeros_like(p.op_idx))
    got = augment_device.apply_augment(torch.from_numpy(imgs), p, img_size=16)
    plain = augment_device.apply_augment(torch.from_numpy(imgs), p, img_size=16,
                                         randaugment=None)
    mean = torch.from_numpy(IMAGENET_MEAN * np.float32(255.0))[:, None, None]
    std = torch.from_numpy(IMAGENET_STD * np.float32(255.0))[:, None, None]
    np.testing.assert_allclose((got * std + mean).numpy(),
                               torch.round(plain * std + mean).numpy(), atol=1e-3)


def test_device_augment_end_to_end_shapes_and_stats():
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8))
    out = augment_device.device_augment(imgs, torch.Generator().manual_seed(1),
                                        img_size=32)
    assert out.shape == (8, 3, 32, 32) and out.dtype == torch.float32
    arr = out.numpy()
    assert np.isfinite(arr).all() and abs(arr).max() < 8.0
    assert not np.allclose(arr[0], arr[1])
    again = augment_device.device_augment(imgs, torch.Generator().manual_seed(1),
                                          img_size=32)
    np.testing.assert_array_equal(arr, again.numpy())


def test_device_augment_no_randaugment_is_pure_geometry():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (4, 48, 48, 3), dtype=np.uint8))
    out = augment_device.device_augment(imgs, torch.Generator().manual_seed(0),
                                        img_size=32, randaugment=None, hflip=0.0)
    assert out.shape == (4, 3, 32, 32)
    arr = (out.numpy().transpose(0, 2, 3, 1) * (IMAGENET_STD * 255.0)
           + IMAGENET_MEAN * 255.0)
    assert arr.min() > -1e-3 and arr.max() < 255.0 + 1e-3
    assert np.mean(np.abs(arr - np.round(arr)) > 1e-2) > 0.5  # off the u8 grid


def test_device_augment_rejects_bad_input():
    """The JAX package's ValueErrors."""
    for bad in (torch.zeros((2, 8, 8, 3)), torch.zeros((2, 3, 8, 8), dtype=torch.uint8)):
        with pytest.raises(ValueError) as theirs:
            jdev.device_augment(jnp.asarray(bad.numpy()), jax.random.key(0),
                                img_size=8)
        with pytest.raises(ValueError, match="uint8 HWC") as ours:
            augment_device.device_augment(bad, torch.Generator(), img_size=8)
        assert str(ours.value).split(";")[0] == str(theirs.value).split(";")[0]


def test_step_generators_are_a_function_of_seed_and_step():
    a = [torch.rand(3, generator=g) for g in augment_device.step_generators(7, 3)]
    b = [torch.rand(3, generator=g) for g in augment_device.step_generators(7, 3)]
    c = [torch.rand(3, generator=g) for g in augment_device.step_generators(7, 4)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])


def test_raw_batches_loader_matches_jax():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (10, 16, 16, 3), dtype=np.uint8)
    labels = np.arange(10)
    got = list(augment_device.raw_batches(imgs, labels, 4, epochs=2, seed=5))
    want = list(jdev.raw_batches(imgs, labels, 4, epochs=2, seed=5))
    assert len(got) == len(want) == 4
    for (x, y), (xj, yj) in zip(got, want):
        assert x.dtype == np.uint8 and x.shape == (4, 16, 16, 3)
        np.testing.assert_array_equal(x, imgs[y])
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)
    with pytest.raises(ValueError, match="uint8"):
        next(augment_device.raw_batches(imgs.astype(np.float32), labels, 4))

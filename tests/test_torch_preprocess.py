"""The port's image preprocessing (``io/preprocess``) against the JAX
package's, and the CLI's ``--raw-images``, on the CPU.

Mirrors ``tests/test_preprocess.py``: the same seeded arrays and image
files go through both packages' ``preprocess_array`` (PIL's resize and the
NumPy one), ``preprocess_files`` and ``images_to_input_bin``, which must
agree exactly; ``uint8_normalize_constants`` gives JAX's values as tensors;
the engine in uint8 mode gives its float32 mode's answers on the same
pixels normalized on the host.
"""

import os
import sys

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from PIL import Image

from vit_with_opencl_tpu.io import preprocess as jpreprocess
from vit_with_opencl_tpu_torch import ViTConfig, cli
from vit_with_opencl_tpu_torch import config as config_lib
from vit_with_opencl_tpu_torch.engine import InferenceEngine
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.io import binfmt, preprocess

CFG = ViTConfig(name="prep_small", img_size=32, patch_size=8, embed_dim=48,
                depth=1, num_heads=4, num_classes=11)


def _random_image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _smooth_image():
    yy, xx = np.mgrid[0:300, 0:400]
    return np.stack([(yy * 255 / 300), (xx * 255 / 400), ((yy + xx) * 255 / 700)],
                    axis=-1).astype(np.uint8)


CASES = {
    "rgb_260x320": (lambda: _random_image((260, 320, 3), 3), {}),
    "smooth_300x400": (_smooth_image, {}),
    "gray_240": (lambda: _random_image((240, 240), 0), {}),
    "rgba_240": (lambda: _random_image((240, 240, 4), 1), {}),
    "float_250x270": (lambda: _random_image((250, 270, 3), 2).astype(np.float32) * 1.01, {}),
    "384_from_500x400": (lambda: _random_image((500, 400, 3), 7),
                         {"img_size": 384, "resize_size": 438}),
    "32_from_40x50": (lambda: _random_image((40, 50, 3), 8), {"img_size": 32}),
}


@pytest.mark.parametrize("resize", ["pil", "numpy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_array_matches_jax(case, resize, monkeypatch):
    make, kw = CASES[case]
    img = make()
    if resize == "numpy":
        monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import` fails
    got = preprocess.preprocess_array(img, **kw)
    want = jpreprocess.preprocess_array(img, **kw)
    assert got.dtype == np.float32 and got.shape == (3, kw.get("img_size", 224),
                                                     kw.get("img_size", 224))
    np.testing.assert_array_equal(got, want)


def test_numpy_resize_matches_jax():
    img = _random_image((260, 320, 3), 3)
    got = preprocess._resize_bilinear_np(img, 256, 315)
    np.testing.assert_array_equal(got, jpreprocess._resize_bilinear_np(img, 256, 315))
    assert got.shape == (256, 315, 3) and np.isfinite(got).all()


def test_matches_torchvision_semantics():
    """tests/test_preprocess.py's check against torch's interpolate on a
    smooth image (PIL's bilinear and torch's differ per pixel on noise)."""
    img = _smooth_image()
    ours = preprocess.preprocess_array(img)
    t = torch.from_numpy(img.transpose(2, 0, 1)).float()[None]
    resized = torch.nn.functional.interpolate(
        t, size=(256, 341), mode="bilinear", align_corners=False, antialias=False)[0]
    crop = resized[:, 16:240, 58:282] / 255.0
    mean = torch.tensor(preprocess.IMAGENET_MEAN).view(3, 1, 1)
    std = torch.tensor(preprocess.IMAGENET_STD).view(3, 1, 1)
    assert np.abs(ours - ((crop - mean) / std).numpy()).mean() < 0.05


def test_resize_smaller_than_crop_raises_as_jax():
    img = _random_image((40, 40, 3))
    with pytest.raises(ValueError) as port_err:
        preprocess.preprocess_array(img, img_size=32, resize_size=30)
    with pytest.raises(ValueError) as jax_err:
        jpreprocess.preprocess_array(img, img_size=32, resize_size=30)
    assert str(port_err.value) == str(jax_err.value)


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    paths = []
    for i, shape in enumerate([(250, 270, 3), (300, 240, 3), (64, 64, 3)]):
        p = root / f"img{i}.png"
        Image.fromarray(_random_image(shape, seed=20 + i)).save(p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("img_size", [224, 32])
def test_files_and_input_bin_match_jax(pngs, tmp_path, img_size):
    got = preprocess.images_to_input_bin(pngs, tmp_path / "port.bin", img_size)
    want = jpreprocess.images_to_input_bin(pngs, tmp_path / "jax.bin", img_size)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(preprocess.preprocess_files(pngs, img_size), want)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    np.testing.assert_array_equal(binfmt.load_image_data(tmp_path / "port.bin"), got)
    assert got.shape == (3, 3, img_size, img_size) and np.abs(got).max() < 10.0


def test_uint8_normalize_constants_match_jax():
    mean, inv_std = preprocess.uint8_normalize_constants("cpu")
    jmean, jinv_std = jpreprocess.uint8_normalize_constants()
    for got, want in ((mean, jmean), (inv_std, jinv_std)):
        assert got.shape == (1, 3, 1, 1) and got.dtype == torch.float32
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_engine_uint8_mode_equals_float_mode(attention):
    params = fixtures.random_params(CFG, seed=4, scale=0.05)
    raw = _random_image((5, 3, CFG.img_size, CFG.img_size), seed=9)
    mean = preprocess.IMAGENET_MEAN.reshape(1, 3, 1, 1)
    std = preprocess.IMAGENET_STD.reshape(1, 3, 1, 1)
    norm = ((raw.astype(np.float32) / 255.0 - mean) / std).astype(np.float32)
    kw = dict(batch_size=2, device="cpu", attention_impl=attention,
              param_dtype=torch.float32, compute_dtype=torch.float32)
    u8 = InferenceEngine(CFG, params, normalize_uint8=True, **kw).run(raw)
    f32 = InferenceEngine(CFG, params, **kw).run(norm)
    np.testing.assert_allclose(u8, f32, rtol=0, atol=1e-5)
    assert (u8.argmax(-1) == f32.argmax(-1)).all()


@pytest.mark.parametrize("io_flag", [[], ["--pure-python"]], ids=["libvitio", "numpy"])
def test_cli_raw_images_equal_the_input_bin_run(pngs, tmp_path, monkeypatch, capsys,
                                                io_flag):
    """``--raw-images`` on PNGs writes the same result file as the CLI on
    ``images_to_input_bin``'s output of the same files."""
    monkeypatch.setitem(config_lib.PRESETS, CFG.name, CFG)
    params = fixtures.random_params(CFG, seed=5, scale=0.05)
    binfmt.save_weights(tmp_path / "Network",
                        fixtures.params_to_positional(params, CFG), CFG)
    preprocess.images_to_input_bin(pngs, tmp_path / "input.bin", CFG.img_size,
                                   round(CFG.img_size * 256 / 224))
    common = ["--weights", str(tmp_path / "Network"), "--config", CFG.name,
              "--backend", "gpu", "--device", "cpu", "--attention", "flash",
              "--batch-size", "2", *io_flag]
    assert cli.main(["--raw-images", *map(str, pngs),
                     "--output", str(tmp_path / "raw.txt"), *common]) == 0
    assert cli.main(["--input", str(tmp_path / "input.bin"),
                     "--output", str(tmp_path / "bin.txt"), *common]) == 0
    out = capsys.readouterr().out
    assert out.count("loaded 3 images") == 2
    raw = (tmp_path / "raw.txt").read_text()
    assert raw == (tmp_path / "bin.txt").read_text()
    assert len(raw.splitlines()) == 3

"""The port's NaN guard and debug helpers (``vit_with_opencl_tpu_torch.debug``
and ``InferenceEngine(check_numerics=True)``), on the CPU: the mirror of
``tests/test_debug.py``, with ``find_nan``'s report held to the JAX
package's on the same trees."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu.debug import find_nan as jax_find_nan
from vit_with_opencl_tpu_torch import ViTConfig
from vit_with_opencl_tpu_torch.debug import checked_forward, find_nan
from vit_with_opencl_tpu_torch.engine import InferenceEngine
from vit_with_opencl_tpu_torch.harness import fixtures

CFG = ViTConfig(name="dbg", img_size=32, patch_size=8, embed_dim=48, depth=1,
                num_heads=4, num_classes=5)


def _engine(params, **kw):
    return InferenceEngine(CFG, params, batch_size=2, param_dtype=torch.float32,
                           compute_dtype=torch.float32, device="cpu", **kw)


def test_find_nan_clean():
    tree = {"a": torch.ones((3, 3)), "b": torch.zeros(4)}
    assert find_nan(tree) == []


def test_find_nan_reports_leaf():
    tree = {"a": torch.ones(3), "b": torch.tensor([1.0, float("nan"), float("inf")])}
    hits = find_nan(tree, name="params")
    assert len(hits) == 1
    path, nans, infs = hits[0]
    assert "b" in path and nans == 1 and infs == 1


def test_find_nan_matches_jax_on_nested_trees():
    """The same report as the JAX package's: paths in ``keystr`` form,
    counts per leaf, integer and clean leaves skipped."""
    rng = np.random.default_rng(0)
    bad = rng.normal(size=(4, 5)).astype(np.float32)
    bad[1, 2], bad[3, 0], bad[0, 4] = np.nan, np.inf, -np.inf
    tree = {"layers": {"qkv_w": bad, "ln1_w": np.ones(5, np.float32)},
            "steps": np.arange(3), "head": [np.zeros(2, np.float32),
                                            np.array([np.nan], np.float32)]}
    want = jax_find_nan({"layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()},
                         "steps": jnp.asarray(tree["steps"]),
                         "head": [jnp.asarray(v) for v in tree["head"]]},
                        name="params")
    got = find_nan({"layers": {k: torch.from_numpy(v) for k, v in tree["layers"].items()},
                    "steps": torch.from_numpy(tree["steps"]),
                    "head": [torch.from_numpy(v) for v in tree["head"]]},
                   name="params")
    assert got == want
    assert find_nan(tree, name="params") == want  # numpy leaves too


def test_checked_forward_raises():
    f = checked_forward(lambda x: x / 0.0, what="div")
    with pytest.raises(FloatingPointError, match="non-finite"):
        f(torch.ones(4))
    ok = checked_forward(lambda x: x * 2, what="mul")
    np.testing.assert_array_equal(ok(torch.ones(3)).numpy(), 2.0)
    pair = checked_forward(lambda x: (x, {"n": torch.arange(3)}), what="pair")
    assert pair(torch.ones(2))[0].shape == (2,)  # integer leaves are skipped


def test_engine_check_numerics_clean_path():
    params = fixtures.random_params(CFG, seed=0, scale=0.05)
    images = fixtures.random_images(CFG, n=2, seed=0)
    probs = _engine(params, check_numerics=True).run(images)
    assert np.isfinite(probs).all()


def test_engine_check_numerics_catches_bad_weights():
    params = fixtures.random_params(CFG, seed=0, scale=0.05)
    params["heads_head_weight"] = params["heads_head_weight"] * np.float32("inf")
    images = fixtures.random_images(CFG, n=2, seed=0)
    with pytest.raises(FloatingPointError, match="dbg forward"):
        _engine(params, check_numerics=True).run(images)
    # Without the guard the same engine returns the non-finite values.
    assert not np.isfinite(_engine(params).run(images)).all()


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("normalize_uint8", [False, True])
def test_engine_feature_matrix(attention, quantize, normalize_uint8):
    """Engine options compose with the guard: every combination runs and
    stays sane."""
    params = fixtures.random_params(CFG, seed=1, scale=0.05)
    engine = _engine(params, attention_impl=attention, quantize=quantize,
                     normalize_uint8=normalize_uint8, check_numerics=True)
    if normalize_uint8:
        inputs = np.random.default_rng(0).integers(
            0, 256, (3, 3, CFG.img_size, CFG.img_size), np.uint8)
    else:
        inputs = fixtures.random_images(CFG, n=3, seed=0)
    probs = engine.run(inputs)
    assert probs.shape == (3, CFG.num_classes)
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(axis=-1), 1.0, atol=1e-4)

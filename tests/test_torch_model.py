"""The port's forward pass against the JAX package's and the golden oracle.

Small config, CPU tensors: the ``flash`` route runs the kernels' plain
versions, the JAX side runs its Pallas kernels in interpret mode. Both
packages route by their own rules: this small config's whole weight stack
fits the JAX package's on-chip budget, so both run its encoder as the whole
stack (``fused_encoder_stack``), with the residual stream in fp32 across
every layer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_with_opencl_tpu.models import quant as jquant
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.ops import fused_block as jfused
from vit_with_opencl_tpu_torch import ViTConfig
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.models import golden, vit
from vit_with_opencl_tpu_torch.ops import fused_block

CFG = ViTConfig(name="small", img_size=32, patch_size=8, embed_dim=64,
                depth=2, num_heads=4, num_classes=9)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# Probabilities: fp32 tight; bf16 within the reference's 1e-3 parity budget.
PROB_ATOL = {"f32": 1e-5, "bf16": 1e-3}


@pytest.fixture(scope="module")
def setup():
    params = fixtures.random_params(CFG, seed=7, scale=0.05)
    images = fixtures.random_images(CFG, n=3, seed=3)
    return params, images, golden.golden_forward(images, params, CFG)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["xla", "flash"])
def test_forward_matches_jax(setup, route, dtype):
    params, images, ref = setup
    tdt, jdt = DTYPES[dtype]
    stacked = jvit.stack_params(params, CFG, param_dtype=jdt)
    jprobs = np.asarray(jvit.forward(jnp.asarray(images), stacked, CFG,
                                     compute_dtype=jdt,
                                     kernels=jvit.resolve_kernels(route)))
    tparams = vit.params_from_jax(stacked, device="cpu")
    tprobs = vit.forward(torch.from_numpy(images), tparams, CFG,
                         compute_dtype=tdt,
                         kernels=vit.resolve_kernels(route)).numpy()
    assert tprobs.shape == (3, CFG.num_classes)
    np.testing.assert_allclose(tprobs, jprobs, atol=PROB_ATOL[dtype])
    np.testing.assert_allclose(tprobs, ref, atol=PROB_ATOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_weight_forward_matches_jax(setup, dtype):
    """Weight-only int8 from the same stack on both sides: the ``flash``
    forward of each package runs its int8-weight stack (the config is
    stack-class at 1 byte a weight)."""
    params, images, ref = setup
    tdt, jdt = DTYPES[dtype]
    assert jfused.supports_stack(CFG, dtype_bytes=1)
    assert fused_block.supports_stack(CFG, dtype_bytes=1)
    jq = jquant.quantize_stacked_params(jvit.stack_params(params, CFG, param_dtype=jdt),
                                        CFG)
    jprobs = np.asarray(jvit.forward(jnp.asarray(images), jq, CFG, compute_dtype=jdt,
                                     kernels=jvit.resolve_kernels("flash")))
    tprobs = vit.forward(torch.from_numpy(images), vit.params_from_jax(jq, device="cpu"),
                         CFG, compute_dtype=tdt,
                         kernels=vit.resolve_kernels("flash")).numpy()
    np.testing.assert_allclose(tprobs, jprobs, atol=PROB_ATOL[dtype])
    # int8 weights move the probabilities further from the fp32 golden model.
    np.testing.assert_allclose(tprobs, ref, atol=1e-2)
    assert (tprobs.argmax(-1) == ref.argmax(-1)).all()


def test_fused_block_is_a_synonym_of_flash(setup):
    """Both packages accept ``fused_block`` as another name of ``flash``:
    the port's two tables hold the same entries, and a forward through each
    agrees with the JAX package's forward through its own table of that name
    (its whole-stack kernel, as above)."""
    params, images, _ = setup
    flash, alias = vit.resolve_kernels("flash"), vit.resolve_kernels("fused_block")
    assert flash.keys() == alias.keys()
    assert all(flash[k] is alias[k] for k in flash if k not in ("matmul_gelu",))
    stacked = jvit.stack_params(params, CFG, param_dtype=jnp.float32)
    jkernels = jvit.resolve_kernels("fused_block")
    jprobs = np.asarray(jvit.forward(jnp.asarray(images), stacked, CFG,
                                     compute_dtype=jnp.float32, kernels=jkernels))
    tparams = vit.params_from_jax(stacked, device="cpu")
    x = torch.from_numpy(images)
    probs = [vit.forward(x, tparams, CFG, compute_dtype=torch.float32,
                         kernels=k) for k in (flash, alias)]
    torch.testing.assert_close(probs[0], probs[1], rtol=0, atol=0)
    np.testing.assert_allclose(probs[1].numpy(), jprobs, atol=PROB_ATOL["f32"])
    with pytest.raises(ValueError, match="attention_impl"):
        vit.resolve_kernels("pallas")


def test_tanh_gelu_flash_route_matches_jax():
    """A config ``fused_block.supports`` refuses: the flash route sends only
    the attention core to the packed-attention kernel."""
    cfg = ViTConfig(name="tanh", img_size=32, patch_size=8, embed_dim=64,
                    depth=2, num_heads=4, num_classes=9, gelu_approx="tanh")
    params = fixtures.random_params(cfg, seed=8, scale=0.05)
    images = fixtures.random_images(cfg, n=2, seed=8)
    stacked = jvit.stack_params(params, cfg, param_dtype=jnp.float32)
    jprobs = np.asarray(jvit.forward(jnp.asarray(images), stacked, cfg,
                                     compute_dtype=jnp.float32,
                                     kernels=jvit.resolve_kernels("flash")))
    tprobs = vit.forward(torch.from_numpy(images),
                         vit.params_from_jax(stacked, device="cpu"), cfg,
                         compute_dtype=torch.float32,
                         kernels=vit.resolve_kernels("flash")).numpy()
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-5)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_params_from_jax_equals_stack_params(setup, param_dtype):
    params, _, _ = setup
    tdt, jdt = DTYPES[param_dtype]
    from_jax = vit.params_from_jax(jvit.stack_params(params, CFG, param_dtype=jdt),
                                   device="cpu")
    ours = vit.stack_params(params, CFG, param_dtype=tdt, device="cpu")
    flat = lambda p: {**{k: v for k, v in p.items() if k != "layers"},
                      **{"layers." + k: v for k, v in p["layers"].items()}}
    a, b = flat(from_jax), flat(ours)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0, msg=key)


def test_unstack_params_round_trip(setup):
    params, _, _ = setup
    back = vit.unstack_params(
        vit.stack_params(params, CFG, param_dtype=torch.float32, device="cpu"), CFG)
    assert back.keys() == params.keys()
    for key, value in params.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_cheap_stacked_params_match_jax():
    cfg = ViTConfig(name="cheap", img_size=32, patch_size=8, embed_dim=64,
                    depth=2, num_heads=4, num_classes=9)
    ref = jvit.cheap_stacked_params(cfg, param_dtype=jnp.float32)
    ours = vit.cheap_stacked_params(cfg, param_dtype=torch.float32, device="cpu")
    for key in ("patch_w", "pos_emb", "head_w"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))
    for key in ("qkv_w", "fc2_b", "ln1_w"):
        np.testing.assert_array_equal(ours["layers"][key].numpy(),
                                      np.asarray(ref["layers"][key]))


def test_deit_dual_head_and_clip_features_match_golden():
    deit = ViTConfig(name="deit", img_size=32, patch_size=8, embed_dim=64,
                     depth=2, num_heads=4, num_classes=7, num_prefix_tokens=2,
                     head_type="cls+dist")
    clip = ViTConfig(name="clip", img_size=32, patch_size=8, embed_dim=64,
                     depth=2, num_heads=4, head_type="none", pre_norm=True)
    for cfg, seed in ((deit, 5), (clip, 6)):
        params = fixtures.random_params(cfg, seed=seed, scale=0.05)
        images = fixtures.random_images(cfg, n=2, seed=seed)
        tparams = vit.stack_params(params, cfg, param_dtype=torch.float32,
                                   device="cpu")
        x = torch.from_numpy(images)
        kernels = vit.resolve_kernels("flash")
        if cfg.head_type == "none":
            feats = vit.forward_features(x, tparams, cfg,
                                         compute_dtype=torch.float32,
                                         kernels=kernels)
            np.testing.assert_allclose(feats[:, 0].numpy(),
                                       golden.golden_features(images, params, cfg),
                                       atol=1e-5)
            with pytest.raises(ValueError):
                vit.forward(x, tparams, cfg)
        else:
            probs = vit.forward(x, tparams, cfg, compute_dtype=torch.float32,
                                kernels=kernels)
            np.testing.assert_allclose(probs.numpy(),
                                       golden.golden_forward(images, params, cfg),
                                       atol=1e-5)

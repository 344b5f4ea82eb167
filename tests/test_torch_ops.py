"""The port's kernel modules against the JAX package's Pallas kernels.

Each case makes its inputs with numpy from a seed, runs the JAX function
(Pallas in interpret mode on the CPU) and the port's function on CPU tensors
(the kernels' plain versions), and compares at the stated tolerance. On CPU
tensors no kernel may launch, which each case checks through the counters.
"""

import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu import ViTConfig
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.ops import attention as jattention
from vit_with_opencl_tpu.ops import fused_block as jfused
from vit_with_opencl_tpu.ops import layernorm as jlayernorm
from vit_with_opencl_tpu.ops import linear as jlinear
from vit_with_opencl_tpu.harness import fixtures as jfixtures
from vit_with_opencl_tpu_torch.models import vit as tvit
from vit_with_opencl_tpu_torch.ops import attention, fused_block, layernorm, linear

# bf16 comparisons: within about 2 bf16 ulps (bf16 keeps 8 significant bits).
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
# ...and mostly bit-identical: both sides round at the same points, so only
# a different summation order may flip a rounding. Moving a rounding point
# (rounding the fp32 residual to bf16, normalising attention weights before
# the PV product) stays within 2 ulps but leaves half the elements differing.
MIN_IDENTICAL_SHARE = 0.9
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _counts():
    return (layernorm.LAUNCHES, linear.LAUNCHES, attention.LAUNCHES,
            fused_block.LAUNCHES)


@pytest.fixture
def no_launches():
    """Asserts the test launched no kernel: every tensor is on the CPU."""
    before = _counts()
    yield
    assert _counts() == before


def _pair(a: np.ndarray, dtype: str):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _assert_bf16_close(out, ref):
    out, ref = _np(out), _np(ref)
    np.testing.assert_allclose(out, ref, **BF16_TOL)
    assert (out == ref).mean() >= MIN_IDENTICAL_SHARE


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_layer_norm_matches_jax(no_launches, out_dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 1.5, (3, 37, 64)).astype(np.float32)
    w = rng.normal(1.0, 0.1, 64).astype(np.float32)
    b = rng.normal(0.0, 0.1, 64).astype(np.float32)
    ref = jlayernorm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                1e-6, interpret=True)
    out = layernorm.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), 1e-6, out_dtype=out_dtype)
    if out_dtype is None:
        assert out.dtype == torch.float32
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)
    else:  # fp32 in, bf16 out: the chain's LN2
        assert out.dtype == torch.bfloat16
        _assert_bf16_close(out, jnp.asarray(ref, jnp.bfloat16))


@pytest.mark.parametrize("gelu", [False, True], ids=["bias", "bias_gelu"])
def test_fused_linear_matches_jax(no_launches, gelu):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 37, 64)).astype(np.float32)  # M = 74, ragged
    w = rng.normal(0, 0.1, (64, 192)).astype(np.float32)
    b = rng.normal(0, 0.1, 192).astype(np.float32)
    ref = jlinear.fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               fuse_gelu=gelu, interpret=True)
    out = linear.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), fuse_gelu=gelu)
    assert out.shape == (2, 37, 192)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16])
def test_fused_linear_residual_epilogue(no_launches, res_dtype):
    """The port's epilogue extension: residual first, then bias, fp32 out
    (the chain's out-proj), against the JAX GEMM plus the residual."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (74, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, (64, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, 64).astype(np.float32)
    r = torch.from_numpy(rng.normal(0, 1, (74, 64)).astype(np.float32)).to(res_dtype)
    ref = np.asarray(jlinear.fused_linear(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), interpret=True))
    out = linear.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), residual=r,
                              out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), ref + _np(r), atol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_attention_matches_jax(no_launches, dtype):
    rng = np.random.default_rng(3)
    nh, hd, t = 4, 16, 37
    qkv = rng.normal(0, 1, (2, t, 3 * nh * hd)).astype(np.float32)
    tq, jq = _pair(qkv, dtype)
    ref = jattention.packed_fused_attention(jq, num_heads=nh, head_dim=hd,
                                            interpret=True)
    out = attention.packed_fused_attention(tq, num_heads=nh, head_dim=hd)
    assert out.shape == (2, t, nh * hd) and out.dtype == tq.dtype
    if dtype == "f32":
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5)
    else:
        _assert_bf16_close(out, ref)


@pytest.mark.parametrize("t", [197, 1024])
def test_packed_attention_fp32_slab_matches_jax(no_launches, t):
    """fp32 slab packing over every key at ViT-B's T and at the packed
    route's last T: on the card the fp32 slab entry
    (``vit_packed_attention_f32``), here its plain version, against JAX's
    ``_packed_kernel`` in interpret mode. Tolerance: fp32 summation order
    (2e-5 on outputs of unit scale)."""
    rng = np.random.default_rng(t)
    nh, hd = 2, 64
    qkv = rng.normal(0, 1, (1, t, 3 * nh * hd)).astype(np.float32)
    tq, jq = _pair(qkv, "f32")
    assert attention._packed_route(t, "slab", t, torch.float32) == "packed_f32"
    ref = jattention.packed_fused_attention(jq, num_heads=nh, head_dim=hd,
                                            interpret=True)
    out = attention.packed_fused_attention(tq, num_heads=nh, head_dim=hd)
    assert out.shape == (1, t, nh * hd) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5)


def test_packed_attention_unported_options_raise():
    """What the JAX package refuses, the port refuses: per-head packing past
    padded T = 1024 (the blockwise route takes slabs only) and an unknown
    packing. Per-head packing and ``true_seq_len`` below that are ported;
    tests/test_torch_parallel.py holds them to JAX's."""
    with pytest.raises(NotImplementedError, match="slab packing only"):
        attention.packed_fused_attention(torch.zeros(1, 1030, 48), num_heads=2,
                                         head_dim=8, packing="per_head")
    with pytest.raises(ValueError, match="unknown packing"):
        attention.packed_fused_attention(torch.zeros(1, 5, 48), num_heads=2,
                                         head_dim=8, packing="diagonal")


ENC_CFG = ViTConfig(name="enc", img_size=32, patch_size=8, embed_dim=64,
                    depth=2, num_heads=4, num_classes=9)


@pytest.fixture(scope="module")
def encoder_layer_inputs():
    params = jfixtures.random_params(ENC_CFG, seed=4, scale=0.05)
    x = np.random.default_rng(4).normal(0, 0.5, (2, 37, 64)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_encoder_layer_matches_jax(no_launches, encoder_layer_inputs, dtype):
    params, x = encoder_layer_inputs
    tdt, jdt = DTYPES[dtype]
    stacked = jvit.stack_params(params, ENC_CFG, param_dtype=jdt)
    jlp = {k: jnp.asarray(v[1]) for k, v in stacked["layers"].items()}
    tparams = tvit.params_from_jax(stacked, device="cpu")
    tlp = {k: v[1] for k, v in tparams["layers"].items()}
    tx, jx = _pair(x, dtype)
    ref = jfused.fused_encoder_layer(jx, jlp, ENC_CFG, interpret=True)
    out = fused_block.fused_encoder_layer(tx, tlp, ENC_CFG)
    plain = fused_block.fused_encoder_layer_reference(tx, tlp, ENC_CFG)
    assert out.dtype == tdt
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    if dtype == "f32":
        np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)
    else:
        _assert_bf16_close(out, ref)


def test_gelu_fast_matches_jax_and_cuda_source():
    """One polynomial in three places: the JAX package, the port's plain
    version, and the coefficients written out in csrc/epilogue.cuh."""
    x = np.linspace(-8, 8, 2001, dtype=np.float32)
    ref = np.asarray(jfused._gelu_fast(jnp.asarray(x)))
    out = fused_block._gelu_fast(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert fused_block._GELU_P == jfused._GELU_P
    src = (Path(linear.__file__).parent.parent / "csrc" / "epilogue.cuh").read_text()
    body = src[src.index("float p = "):src.index("return 0.5f")]
    coeffs = [float(c) for c in re.findall(r"(-?\d\.\d+e?-?\d*)f", body)]
    assert coeffs == list(fused_block._GELU_P[::-1])


def test_supports_matches_jax():
    from vit_with_opencl_tpu import config as jconfig
    from vit_with_opencl_tpu_torch import config as tconfig

    tanh = tconfig.ViTConfig(name="t", gelu_approx="tanh")
    for name, cfg in jconfig.PRESETS.items():
        assert fused_block.supports(tconfig.PRESETS[name]) == jfused.supports(cfg)
    assert not fused_block.supports(tanh)

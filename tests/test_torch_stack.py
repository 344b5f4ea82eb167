"""The port's whole-encoder stack, layer groups and residual boundary against
the JAX package's ``fused_encoder_stack``, ``fused_encoder_group`` and
``fused_encoder_layer_flat`` (Pallas in interpret mode), and the routing
that reaches them.

Inputs are made with numpy from seeds; the same weights go to both sides
(``params_from_jax``). T = 37 tokens, which the JAX stack pads to 48 and
masks; the port keeps T as it is. On CPU tensors every wrapper computes its
plain version and no kernel launches, which the tests check through the
counters.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu import config as jconfig
from vit_with_opencl_tpu.harness import fixtures as jfixtures
from vit_with_opencl_tpu.models import quant as jquant
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.ops import fused_block as jfused
from vit_with_opencl_tpu_torch import ViTConfig
from vit_with_opencl_tpu_torch import config as tconfig
from vit_with_opencl_tpu_torch.models import vit as tvit
from vit_with_opencl_tpu_torch.ops import fused_block, layernorm, linear

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
T = 37
# Encoder outputs against the JAX kernels, elementwise. fp32: both sides
# round at the same points and sum in another order (XLA's dot against
# torch's matmul): measured up to 3.5e-6 at D = 192, depth 4. bf16: within
# 2 bf16 ulps; one summation-order flip of a rounding spreads through the
# attention to the whole image in the next layer, so after 3 layers at
# D = 192 only about half the outputs stay bit-identical (as in the JAX
# package's own per-layer kernel at that width).
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1.6e-2, atol=1.6e-2)}
# W8A8 adds int8 decisions: an fp32 LN output one ulp away flips one now and
# then, which moves its row by a quantum and, through the attention, its
# image. Measured against JAX after 3 layers at D = 192 over seeds 4-6: max
# 0.048 (fp32) and 0.031 (bf16), mean up to 5.0e-3. The JAX package's own
# group and stack kernels, the same function summed in another order, differ
# by as much from each other there (fp32: max 0.029, mean 2.3e-3).
W8A8_TOL = dict(rtol=1.6e-2, atol=6e-2)
W8A8_MEAN_ABS = 6e-3
# The share of bf16 encoder outputs bit-identical to JAX's stack (D = 64,
# depth 2; see test_stack_keeps_jax_rounding_points).
MIN_IDENTICAL_SHARE = 0.9


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _counts():
    return (layernorm.LAUNCHES, linear.LAUNCHES, linear.LAUNCHES_INT8W,
            linear.LAUNCHES_W8A8, fused_block.LAUNCHES_STACK,
            fused_block.LAUNCHES_STACK_INT8W,
            fused_block.LAUNCHES_STACK_W8A8, fused_block.LAUNCHES_GROUP)


@pytest.fixture
def no_launches():
    """Asserts the test launched no kernel: every tensor is on the CPU."""
    before = _counts()
    yield
    assert _counts() == before


@pytest.fixture
def one_thread():
    """Torch on one CPU thread for the test. On several, the W8A8 stack's
    wrapper and its plain version (the same code on CPU tensors) were seen
    to differ now and then while the JAX reference, dispatched
    asynchronously, ran on the same cores (an int8 decision turns a one-ulp
    difference upstream into a quantum); on one thread they were not."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(d, nh, depth):
    return ViTConfig(name=f"stk{d}", img_size=32, patch_size=8, embed_dim=d,
                     depth=depth, num_heads=nh, num_classes=9)


def _stacked(cfg, dtype, form, seed=4):
    """JAX stacked layers in ``form`` ("fp", "int8w", "w8a8": the same int8
    dicts) and the port's copy of them, value for value."""
    jdt = DTYPES[dtype][1]
    st = jvit.stack_params(jfixtures.random_params(cfg, seed=seed, scale=0.05), cfg,
                           param_dtype=jdt)
    if form != "fp":
        st = jquant.quantize_stacked_params(st, cfg)
    return st["layers"], tvit.params_from_jax(st, device="cpu")["layers"]


def _x(d, dtype, seed=4):
    x = np.random.default_rng(seed).normal(0, 0.5, (2, T, d)).astype(np.float32)
    return torch.from_numpy(x).to(DTYPES[dtype][0]), jnp.asarray(x, DTYPES[dtype][1])


def _assert_plain(out, plain):
    """On CPU tensors a wrapper computes its plain version: the same values."""
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def _assert_close(out, ref, dtype, w8a8):
    out, ref = _np(out), _np(ref)
    if w8a8:
        np.testing.assert_allclose(out, ref, **W8A8_TOL)
        assert np.abs(out - ref).mean() < W8A8_MEAN_ABS
    else:
        np.testing.assert_allclose(out, ref, **TOL[dtype])


@pytest.mark.parametrize("form", ["fp", "int8w", "w8a8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,nh", [(64, 4), (192, 3)])
def test_stack_matches_jax(no_launches, one_thread, d, nh, dtype, form):
    cfg = _cfg(d, nh, depth=3)
    jlayers, tlayers = _stacked(cfg, dtype, form)
    tx, jx = _x(d, dtype)
    w8a8 = form == "w8a8"
    ref = jfused.fused_encoder_stack(jx, jlayers, cfg, w8a8=w8a8, interpret=True)
    out = fused_block.fused_encoder_stack(tx, tlayers, cfg, w8a8=w8a8)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    plain = fused_block.fused_encoder_stack_reference(tx, tlayers, cfg, w8a8=w8a8)
    _assert_plain(out, plain)
    _assert_close(out, ref, dtype, w8a8)


def _calibrated(cfg):
    """JAX's calibrated outlier-aware params from the fp32 stack (numpy)."""
    st = jvit.stack_params(jfixtures.random_params(cfg, seed=6, scale=0.05), cfg,
                           param_dtype=jnp.float32)
    return jquant.calibrate_w8a8(jfixtures.random_images(cfg, n=4, seed=9), st, cfg)


@pytest.mark.parametrize("form", ["fp", "int8w", "w8a8", "outlier"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_group_matches_jax(no_launches, one_thread, dtype, form):
    """Two groups of 2 layers: fp32 inside a group, the activation dtype
    between groups, in all four forms of the JAX package's group kernel."""
    cfg = _cfg(64, 4, depth=4)
    if form == "outlier":
        cal = _calibrated(cfg)
        jlayers = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                       if isinstance(v, dict) else jnp.asarray(v))
                   for k, v in cal["layers"].items()}
        tlayers = tvit.params_from_jax(cal, device="cpu")["layers"]
        assert "hi" in tlayers["qkv_w"]
    else:
        jlayers, tlayers = _stacked(cfg, dtype, form, seed=5)
    tx, jx = _x(64, dtype, seed=5)
    w8a8 = form in ("w8a8", "outlier")
    ref = jfused.fused_encoder_group(jx, jlayers, cfg, group_size=2, w8a8=w8a8,
                                     interpret=True)
    out = fused_block.fused_encoder_group(tx, tlayers, cfg, group_size=2, w8a8=w8a8)
    plain = fused_block.fused_encoder_group_reference(tx, tlayers, cfg, group_size=2,
                                                      w8a8=w8a8)
    assert out.dtype == tx.dtype
    _assert_plain(out, plain)
    _assert_close(out, ref, dtype, w8a8)


def test_group_is_the_stack_per_group(no_launches):
    """A group of the whole depth is the stack's function, and groups of 1
    are the per-layer chain's: the carry is the only difference."""
    cfg = _cfg(64, 4, depth=4)
    _, tlayers = _stacked(cfg, "bf16", "fp", seed=5)
    tx, _ = _x(64, "bf16", seed=5)
    torch.testing.assert_close(
        fused_block.fused_encoder_group(tx, tlayers, cfg, group_size=4),
        fused_block.fused_encoder_stack(tx, tlayers, cfg), rtol=0, atol=0)
    x = tx
    for layer in range(cfg.depth):
        x = fused_block.fused_encoder_layer(x, {k: v[layer] for k, v in tlayers.items()},
                                            cfg)
    torch.testing.assert_close(
        fused_block.fused_encoder_group(tx, tlayers, cfg, group_size=1), x,
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="group_size"):
        fused_block.fused_encoder_group(tx, tlayers, cfg, group_size=3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_flat_matches_jax(no_launches, dtype):
    cfg = _cfg(64, 4, depth=2)
    jlayers, tlayers = _stacked(cfg, dtype, "fp", seed=3)
    tx, jx = _x(64, dtype, seed=3)
    jlp = {k: v[1] for k, v in jlayers.items()}
    tlp = {k: v[1] for k, v in tlayers.items()}
    ref = jfused.fused_encoder_layer_flat(jx, jlp, cfg, interpret=True)
    out = fused_block.fused_encoder_layer_flat(tx, tlp, cfg)
    one = {k: v[1:] for k, v in tlayers.items()}
    torch.testing.assert_close(
        out, fused_block.fused_encoder_stack_reference(tx, one, cfg, num_layers=1),
        rtol=0, atol=0)
    _assert_close(out, ref, dtype, False)


def test_stack_keeps_jax_rounding_points(no_launches):
    """The bf16 encoder output of the port's stack is bit-identical to JAX's
    ``fused_encoder_stack`` almost everywhere (0.967 measured; only
    summation order differs). The per-layer chain that the port ran for
    these configs before the stack was ported rounds the residual stream to
    bf16 at every layer boundary: 0.579 identical here, so this test fails
    on that routing."""
    cfg = _cfg(64, 4, depth=2)
    jlayers, tlayers = _stacked(cfg, "bf16", "fp")
    tx, jx = _x(64, "bf16")
    ref = _np(jfused.fused_encoder_stack(jx, jlayers, cfg, interpret=True))
    params = {"layers": tlayers}
    out = _np(tvit.encoder(tx, params, cfg, tvit.resolve_kernels("flash")))
    assert (out == ref).mean() >= MIN_IDENTICAL_SHARE
    x = tx
    for layer in range(cfg.depth):
        x = fused_block.fused_encoder_layer(x, tvit._layer(params, layer), cfg)
    assert (_np(x) == ref).mean() < MIN_IDENTICAL_SHARE


def test_stack_refuses_outlier_weights(no_launches):
    cfg = _cfg(64, 4, depth=4)
    tlayers = tvit.params_from_jax(_calibrated(cfg), device="cpu")["layers"]
    tx, _ = _x(64, "f32")
    for w8a8 in (False, True):
        for fn in (fused_block.fused_encoder_stack,
                   fused_block.fused_encoder_stack_reference):
            with pytest.raises(ValueError, match="outlier"):
                fn(tx, tlayers, cfg, w8a8=w8a8)
    with pytest.raises(ValueError, match="outlier"):
        fused_block.fused_encoder_layer_flat(tx, tvit._layer({"layers": tlayers}, 0),
                                             cfg)


@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("residual", ["f32", "bf16"])
def test_fused_linear_ln_reference_matches_jax_ln(no_launches, weights, residual):
    """The stack's residual boundary on the plain versions (the GEMM with
    the residual and an fp32 output, then LN of that fp32 stream) against
    the JAX stack's own arithmetic: ``x + a + b`` in fp32 (a the fp32
    product, scaled for int8 weights), then ``_ln`` of it
    (fused_block.py:155), rounded to bf16."""
    rng = np.random.default_rng(11)
    m, k, n = 37, 128, 192
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    b, ln_b = (rng.normal(0, 0.1, n).astype(np.float32) for _ in range(2))
    ln_w = (1 + rng.normal(0, 0.1, n)).astype(np.float32)
    r = rng.normal(0, 2, (m, n)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    kw = {}
    if weights == "int8":
        qw = jquant.quantize_weight(w)
        a = jnp.dot(jx, jnp.asarray(qw["q"]).astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32) * qw["scale"]
        tw = torch.from_numpy(qw["q"])
        kw["w_scale"] = torch.from_numpy(qw["scale"])
    else:
        a = jnp.dot(jx, jw, preferred_element_type=jnp.float32)
        tw = torch.from_numpy(w).to(torch.bfloat16)
    jr = jnp.asarray(r, jnp.bfloat16 if residual == "bf16" else jnp.float32)
    tr = torch.from_numpy(r).to(torch.bfloat16 if residual == "bf16" else torch.float32)
    stream = jr.astype(jnp.float32) + a + b
    ref_ln = jfused._ln(stream, ln_w, ln_b, 1e-6).astype(jnp.bfloat16)
    tb, tln_w, tln_b = (torch.from_numpy(v) for v in (b, ln_w, ln_b))

    def boundary(mm, ln):
        out = mm(tx, tw, tb, residual=tr, out_dtype=torch.float32, **kw)
        return out, ln(out, tln_w, tln_b, 1e-6, out_dtype=torch.bfloat16)

    out, ln = boundary(linear.fused_linear_reference, layernorm.layer_norm_reference)
    assert out.dtype == torch.float32 and ln.dtype == torch.bfloat16
    np.testing.assert_allclose(out.numpy(), np.asarray(stream), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(ln), _np(ref_ln), rtol=1.6e-2, atol=1e-2)
    assert (_np(ln) == _np(ref_ln)).mean() >= 0.99
    # On CPU tensors the wrappers are their plain versions.
    got = boundary(linear.fused_linear, layernorm.layer_norm)
    for g, want in zip(got, (out, ln)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="w_scale"):
        linear.fused_linear(tx, tw, None,
                            w_scale=None if "w_scale" in kw else torch.ones(n))


@pytest.mark.parametrize("dtype_bytes", [1, 2, 4])
def test_supports_match_jax_for_every_preset(dtype_bytes):
    for name, cfg in jconfig.PRESETS.items():
        ours = tconfig.PRESETS[name]
        assert fused_block.supports(ours, dtype_bytes) == jfused.supports(
            cfg, dtype_bytes), name
        assert fused_block.supports_stack(ours, dtype_bytes) == jfused.supports_stack(
            cfg, dtype_bytes), name
    assert fused_block.supports_stack(tconfig.PRESETS["vit_tiny_16_224"], dtype_bytes)
    assert not fused_block.supports_stack(tconfig.PRESETS["vit_b_16_224"], dtype_bytes)


def _route(monkeypatch, cfg, params, kernels):
    """Which of the fused entry points ``encoder`` calls (and how often)."""
    calls = []
    for name in ("fused_encoder_stack", "fused_encoder_group",
                 "fused_encoder_layer"):
        real = getattr(fused_block, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(fused_block, name, spy)
    x = torch.zeros((1, T, cfg.embed_dim))
    tvit.encoder(x, params, cfg, kernels)
    return calls


@pytest.mark.parametrize("case", ["stack", "int8_stack", "w8a8_per_layer", "group",
                                  "group_not_dividing", "forced_block", "big"])
def test_encoder_routes_like_jax(monkeypatch, case):
    """The JAX package's order (models/vit.py:571-635): a forced
    encoder_block; layer groups when fused_group_size divides the depth;
    the stack unless W8A8; the per-layer chain; the per-op path."""
    # "big": a 16-layer D = 256 stack of 50 MB in fp32, past the 44 MB budget.
    d, depth = (256, 16) if case == "big" else (64, 4)
    cfg = ViTConfig(name="route", img_size=32, patch_size=8, embed_dim=d,
                    depth=depth, num_heads=4, num_classes=9)
    params = tvit.stack_params(jfixtures.random_params(cfg, seed=1, scale=0.05), cfg,
                               param_dtype=torch.float32, device="cpu")
    if case in ("int8_stack", "w8a8_per_layer"):
        from vit_with_opencl_tpu_torch.models import quant
        params = quant.quantize_stacked_params(params, cfg)
    kernels = tvit.resolve_kernels("flash", w8a8=case == "w8a8_per_layer")
    if case.startswith("group"):
        kernels["fused_group_size"] = 2 if case == "group" else 3
    if case == "forced_block":
        kernels["encoder_block"] = (
            lambda x, lp, c: fused_block.fused_encoder_layer(x, lp, c))
    want = {"stack": ["fused_encoder_stack"], "int8_stack": ["fused_encoder_stack"],
            "w8a8_per_layer": ["fused_encoder_layer"] * 4,
            "group": ["fused_encoder_group"],
            "group_not_dividing": ["fused_encoder_stack"],
            "forced_block": ["fused_encoder_layer"] * 4,
            "big": ["fused_encoder_layer"] * 16}[case]
    assert jfused.supports_stack(cfg, 4) == (case != "big")
    assert _route(monkeypatch, cfg, params, kernels) == want

"""The port's calibrated outlier-aware W8A8 mode against the JAX package's
(``vit_with_opencl_tpu/models/quant.py:calibrate_w8a8``): the adversarial
fixture, the calibration forward, smoothing, the outlier planners and
quantizers, the device twins, the split and masked quantizes, the outlier
forms of ``matmul_w8a8``, the outlier chain against the JAX fused layer
(Pallas in interpret mode), the forward on both routes, the engine and the
CLI with ``--calibrate``.

The planners argsort calibration stats, and a one-ulp difference between
torch's and XLA's fp32 sums could swap two near-equal channels and change
every int8 code downstream. So the planners and quantizers are held to JAX
bit for bit on JAX's own stats, fed to both sides; the calibration forward
is held separately, to a tolerance. Inputs are made with numpy from seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_with_opencl_tpu.harness import fixtures as jfixtures
from vit_with_opencl_tpu.models import quant as jquant
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.ops import fused_block as jfused
from vit_with_opencl_tpu_torch import ViTConfig, cli
from vit_with_opencl_tpu_torch import config as tconfig
from vit_with_opencl_tpu_torch.engine import InferenceEngine
from vit_with_opencl_tpu_torch.harness import fixtures, results
from vit_with_opencl_tpu_torch.io import binfmt
from vit_with_opencl_tpu_torch.models import golden, quant
from vit_with_opencl_tpu_torch.models import vit as tvit
from vit_with_opencl_tpu_torch.ops import fused_block, linear, quantize

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# The smallest config where the adversarial fixture breaks plain W8A8 (max
# prob error 0.015 against golden and a flipped label, head scaled 6x as in
# tests/test_quant_outlier.py) and the calibrated mode passes (0.003).
CFG = ViTConfig(name="adv_torch", img_size=32, patch_size=8, embed_dim=128,
                depth=4, num_heads=4, num_classes=100)
HEADS = (CFG.num_heads, CFG.head_dim)
HEAD_SCALE = 6.0
GATE = 0.01  # the reference comparator's bound on probabilities
# collect_act_stats: torch's and XLA's fp32 sums differ in order; through
# the adversarial gains (30x LN spikes) that is up to ~2e-6 relative on the
# stats and 1e-4 absolute on the features (tests/test_quant_outlier.py
# holds the JAX mirror to forward_features with the same atol).
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
FEATURES_ATOL = 1e-4
# The outlier layer against the JAX fused layer: elementwise within
# LAYER_TOL, and at least MIN_CLOSE_SHARE of the elements within
# 1e-6 + 1e-6·|ref| (the adversarial layer's outputs reach ~10, where 1e-6
# absolute is a few fp32 ulps). A moved rounding point moves int8 decisions
# by a quantum (~1e-3 relative), far outside that.
LAYER_TOL = {"f32": dict(rtol=0, atol=1e-2), "bf16": dict(rtol=1.6e-2, atol=1.6e-2)}
MIN_CLOSE_SHARE = 0.9
# Forward probabilities against the JAX forward on the same weights.
PROB_TOL_JAX = 5e-4


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _flat(p, prefix=""):
    out = {}
    for key, value in p.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def _assert_same(ours, theirs):
    """Every leaf equal, bit for bit (bf16 leaves compared as fp32 values)."""
    a, b = _flat(ours), _flat(theirs)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(_np(a[key]), _np(b[key]), err_msg=key)


def _adversarial(head_scale=HEAD_SCALE, seed=0):
    pn = jfixtures.adversarial_params(CFG, seed=seed)
    pn["heads_head_weight"] = pn["heads_head_weight"] * head_scale
    return pn


@pytest.fixture(scope="module")
def setup():
    """Adversarial weights, images, calibration images, golden, and JAX's
    own calibration stats and plan on the fp32 stack."""
    pn = _adversarial()
    images = jfixtures.random_images(CFG, n=8, seed=2)
    calib = jfixtures.random_images(CFG, n=16, seed=99)
    jstacked = jvit.stack_params(pn, CFG, param_dtype=jnp.float32)
    stats = jquant.collect_act_stats(calib, jstacked, CFG)
    return dict(pn=pn, images=images, calib=calib,
                golden=golden.golden_forward(images, pn, CFG),
                jstacked=jstacked, stats=stats,
                jplan=jquant.plan_outliers(stats, CFG))


def _tstack(pn, dtype="f32"):
    return tvit.stack_params(pn, CFG, param_dtype=DTYPES[dtype][0], device="cpu")


@pytest.mark.parametrize("seed,kw", [(0, {}), (5, dict(outlier_channels=3, ln_gain=50.0))])
def test_adversarial_params_match_jax(seed, kw):
    ours = fixtures.adversarial_params(CFG, seed=seed, **kw)
    theirs = jfixtures.adversarial_params(CFG, seed=seed, **kw)
    assert ours.keys() == theirs.keys()
    for name in ours:
        assert ours[name].dtype == theirs[name].dtype
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_collect_act_stats_matches_jax(setup, param_dtype):
    tdt, jdt = DTYPES[param_dtype]
    theirs = jquant.collect_act_stats(
        setup["calib"], jvit.stack_params(setup["pn"], CFG, param_dtype=jdt), CFG)
    stacked = _tstack(setup["pn"], param_dtype)
    ours = quant.collect_act_stats(setup["calib"], stacked, CFG)
    assert ours.keys() == theirs.keys()
    d, h, L = CFG.embed_dim, CFG.hidden_dim, CFG.depth
    assert [ours[k].shape for k in ("qkv_in", "out_in", "fc1_in", "fc2_in")] == [
        (L, d), (L, d), (L, d), (L, h)]
    for key in ("qkv_in", "out_in", "fc1_in", "fc2_in"):
        assert ours[key].dtype == np.float32
        np.testing.assert_allclose(ours[key], theirs[key], **STATS_TOL, err_msg=key)
    np.testing.assert_allclose(ours["features"], theirs["features"], atol=FEATURES_ATOL)
    feats = tvit.forward_features(torch.from_numpy(setup["calib"]), stacked, CFG,
                                  compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(ours["features"], feats, atol=FEATURES_ATOL)


def test_merge_act_stats(setup):
    calib = setup["calib"]
    stacked = _tstack(setup["pn"])
    s1 = quant.collect_act_stats(calib[:8], stacked, CFG)
    s2 = quant.collect_act_stats(calib[8:], stacked, CFG)
    merged = quant.merge_act_stats(s1, s2)
    assert "features" not in merged
    full = quant.collect_act_stats(calib, stacked, CFG)
    for k in ("qkv_in", "out_in", "fc1_in", "fc2_in"):
        np.testing.assert_allclose(merged[k], full[k], rtol=1e-6)
        np.testing.assert_array_equal(merged[k], jquant.merge_act_stats(s1, s2)[k])


def test_smoothing_matches_jax_on_its_stats(setup):
    """The scales and the smoothed params, bit for bit, from JAX's stats."""
    stats, jstacked = setup["stats"], setup["jstacked"]
    stacked = _tstack(setup["pn"])
    theirs = jquant.smoothing_scales(stats, jstacked)
    ours = quant.smoothing_scales(stats, stacked)
    for site in quant.SMOOTH_SITES:
        np.testing.assert_array_equal(ours[site], theirs[site], err_msg=site)
    _assert_same(quant.smooth_stacked_params(stacked, ours),
                 jquant.smooth_stacked_params(jstacked, theirs))


def test_smoothing_is_exact_in_fp32(setup):
    sm = quant.smooth_for_w8a8(setup["calib"], _tstack(setup["pn"]), CFG, alpha=0.5)
    probs = tvit.forward(torch.from_numpy(setup["images"]), sm, CFG,
                         compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(probs, setup["golden"], atol=2e-5)
    scales = quant.smoothing_scales(setup["stats"], sm)
    with pytest.raises(ValueError, match="fc2"):
        quant.smooth_stacked_params(sm, scales, sites=("qkv", "fc2"))


@pytest.mark.parametrize("widths", [{}, dict(k_d=32, k_h=64, kh=8)],
                         ids=["default", "explicit"])
def test_plan_outliers_matches_jax(setup, widths):
    ours = quant.plan_outliers(setup["stats"], CFG, **widths)
    theirs = jquant.plan_outliers(setup["stats"], CFG, **widths)
    for field in ("perm_d", "perm_h", "perm_v", "k_d", "k_h", "kh"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
    assert (ours.k_d, ours.k_h, ours.kh) == (
        (16, 128, 4) if not widths else (32, 64, 8))
    with pytest.raises(ValueError, match="widths"):
        quant.plan_outliers(setup["stats"], CFG, kh=CFG.head_dim)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_apply_and_quantize_outlier_match_jax(setup, param_dtype):
    """From JAX's plan: the permuted params and the outlier-quantized ones
    (int8 codes, scales, bf16 "hi" groups made by torch) bit for bit."""
    tdt, jdt = DTYPES[param_dtype]
    plan = setup["jplan"]
    jstacked = jvit.stack_params(setup["pn"], CFG, param_dtype=jdt)
    jperm = jquant.apply_outlier_plan(jstacked, plan, CFG)
    perm = quant.apply_outlier_plan(_tstack(setup["pn"], param_dtype), plan, CFG)
    _assert_same(perm, jperm)
    ours = quant.quantize_stacked_params_outlier(perm, CFG, plan)
    theirs = jquant.quantize_stacked_params_outlier(jperm, CFG, plan)
    _assert_same(ours, theirs)
    lp = ours["layers"]
    d, h, L = CFG.embed_dim, CFG.hidden_dim, CFG.depth
    assert lp["qkv_w"]["q"].shape == (L, d - plan.k_d, 3 * d)
    assert lp["fc2_w"]["q"].shape == (L, h - plan.k_h, d)
    assert lp["out_w"]["hi"].shape == (L, CFG.num_heads * plan.kh, d)
    for key in ("qkv_w", "out_w", "fc1_w", "fc2_w"):
        assert lp[key]["hi"].dtype == torch.bfloat16
        assert lp[key]["q"].dtype == torch.int8
    assert not lp["out_w"]["q"][:, torch.from_numpy(quant._tail_mask(CFG, plan.kh))].any()


def test_outlier_plan_is_exact_in_fp32(setup):
    stacked = _tstack(setup["pn"])
    plan = quant.plan_outliers(setup["stats"], CFG)
    permuted = quant.apply_outlier_plan(stacked, plan, CFG)
    probs = tvit.forward(torch.from_numpy(setup["images"]), permuted, CFG,
                         compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(probs, setup["golden"], atol=2e-5)


def test_device_twins_match_host_and_jax(setup):
    """calibrate_w8a8_device against the host path (the same int8 codes and
    bf16 groups; the scale multiplies by float32(1/127) where the host
    divides), and the torch twins against JAX's on JAX's plan, bit for bit."""
    stacked = _tstack(setup["pn"])
    host = quant.calibrate_w8a8(setup["calib"], stacked, CFG)
    dev = quant.calibrate_w8a8_device(setup["calib"], stacked, CFG)
    for key in ("qkv_w", "out_w", "fc1_w", "fc2_w"):
        hw, dw = host["layers"][key], dev["layers"][key]
        assert dw["q"].dtype == torch.int8 and torch.equal(dw["q"], hw["q"]), key
        assert torch.equal(dw["hi"], hw["hi"]), key
        torch.testing.assert_close(dw["scale"], hw["scale"], rtol=1e-6, atol=0)
    torch.testing.assert_close(dev["layers"]["qkv_b"], host["layers"]["qkv_b"],
                               rtol=0, atol=0)
    plan = setup["jplan"]
    ours = quant.quantize_stacked_params_outlier_device(
        quant.apply_outlier_plan_device(stacked, plan, CFG), CFG, plan)
    theirs = jquant.quantize_stacked_params_outlier_device(
        jquant.apply_outlier_plan_device(setup["jstacked"], plan, CFG), CFG, plan)
    _assert_same(ours, theirs)


def _jax_split(x, m):
    """quant.py:153-157's math (the trailing group)."""
    return (*jquant.quantize_act(x[..., :m]), x[..., m:])


def _jax_masked(x, nh, hd, kh):
    """quant.py:169-184's math (the per-head tails), line for line."""
    din = x.shape[-1]
    mask = np.zeros(din, bool)
    for h in range(nh):
        mask[h * hd + hd - kh:(h + 1) * hd] = True
    keep = jnp.asarray(~mask, jnp.float32)
    xf = x.astype(jnp.float32)
    absmax = jnp.maximum(jnp.max(jnp.abs(xf) * keep, axis=-1, keepdims=True),
                         jnp.float32(2.0 ** -93))
    r = jnp.float32(127.0) / absmax
    xq = jnp.clip(jnp.round(xf * r), -127, 127).astype(jnp.int8)
    x3 = x.reshape(x.shape[:-1] + (nh, hd))
    x_hi = x3[..., hd - kh:].reshape(x.shape[:-1] + (nh * kh,))
    return xq, absmax * jnp.float32(1 / 127), x_hi


def _act(rows=(3, 11), d=128, hot=(5, 70, 127)):
    """Rows with outlier columns (the last of each 32-wide head among them),
    a zero row, and two rows whose absmax is 127 (r = 1: half-way values
    round to even), one with a tail far above it."""
    rng = np.random.default_rng(12)
    x = rng.normal(0.0, 1.0, (*rows, d)).astype(np.float32)
    x[..., list(hot)] *= 60.0
    x[1, 4] = 0.0
    x[2, :2] = 0.0
    x[2, :2, :6] = [127.0, 2.5, 3.5, -2.5, 0.5, -1.5]
    x[2, 0, 31] = 900.0  # a head-0 tail far above the kept absmax: clipped
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_split_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x = _act()
    m = 112
    jq_, js, jhi = _jax_split(jnp.asarray(x, jdt), m)
    before = quantize.LAUNCHES_SPLIT
    for q, s, hi in (quant.quantize_act_split(torch.from_numpy(x).to(tdt), m, tdt),
                     quantize.quantize_rows_split(torch.from_numpy(x).to(tdt), m, tdt)):
        assert q.shape == x.shape[:-1] + (m,) and hi.dtype == tdt
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(_np(hi), _np(jhi))
    assert quantize.LAUNCHES_SPLIT == before
    # fp32 in, bf16 tail: the chain's form, rounded to nearest even.
    _, _, hi = quantize.quantize_rows_split(torch.from_numpy(x), m, torch.bfloat16)
    np.testing.assert_array_equal(
        _np(hi), np.asarray(jnp.asarray(x[..., m:]).astype(jnp.bfloat16), np.float32))
    assert quant.quantize_act_split(torch.from_numpy(x), m, torch.float32)[0][2, 1, :6].tolist() == [
        127, 2, 4, -2, 0, -2]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_masked_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x = _act()
    nh, hd, kh = 4, 32, 4
    jq_, js, jhi = _jax_masked(jnp.asarray(x, jdt), nh, hd, kh)
    before = quantize.LAUNCHES_MASKED
    for q, s, hi in (quant.quantize_act_masked(torch.from_numpy(x).to(tdt), nh, hd, kh),
                     quantize.quantize_rows_masked(torch.from_numpy(x).to(tdt), nh, hd, kh)):
        assert q.shape == x.shape and hi.shape == x.shape[:-1] + (nh * kh,)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(_np(hi), _np(jhi))
    assert quantize.LAUNCHES_MASKED == before
    # The tails were clipped: 900 and 60x-hot values, beyond the kept absmax.
    q = quant.quantize_act_masked(torch.from_numpy(x).to(tdt), nh, hd, kh)[0]
    assert q[2, 0, 31].item() == 127
    assert q[2, 0, :6].tolist() == [127, 2, 4, -2, 0, -2]
    tails = torch.from_numpy(quant._tail_mask_heads(nh, hd, kh))
    assert (q[..., tails].abs() == 127).sum() > 3


def _outlier_weight(rng, k, n, form):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.2
    if form == "trailing":
        return jquant._split_weight(w, 16)
    return jquant._masked_weight(w, jquant._tail_mask(CFG, 4))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["trailing", "masked"])
def test_outlier_matmul_w8a8_matches_jax(dtype, form):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(21)
    x = _act(rows=(3, 9))
    jw = {k: jnp.asarray(v) for k, v in _outlier_weight(rng, 128, 48, form).items()}
    tw = tvit.params_from_jax({"layers": {"w": dict(jw)}}, device="cpu")["layers"]["w"]
    b = rng.standard_normal(48).astype(np.float32)
    ref = jquant.matmul_w8a8(jnp.asarray(x, jdt), jw, jnp.asarray(b), heads=HEADS)
    out = quant.matmul_w8a8(torch.from_numpy(x).to(tdt), tw, torch.from_numpy(b),
                            heads=HEADS)
    assert out.dtype == tdt and out.shape == (3, 9, 48)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6,
                               atol=1e-5 if dtype == "f32" else 0)
    if form == "masked":
        with pytest.raises(ValueError, match="heads"):
            quant.matmul_w8a8(torch.from_numpy(x), tw, None)
    with pytest.raises(ValueError, match="w8a8"):
        quant.matmul_q(torch.from_numpy(x), tw, None)


def test_outlier_gemm_wrapper_matches_plain_on_cpu():
    """On CPU tensors the W8A8 GEMM with a side product computes its plain
    version: matmul_w8a8's trailing form before its cast, no launch."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((7, 128)).astype(np.float32))
    w = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
         _outlier_weight(rng, 128, 32, "trailing").items()}
    w["hi"] = w["hi"].to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    w["q"] = w["q"].to(torch.int8)
    before = (linear.LAUNCHES_W8A8, linear.LAUNCHES_W8A8_HI)
    xq, sx, x_hi = quantize.quantize_rows_split(x, 112, torch.float32)
    out = linear.fused_linear_w8a8(xq, sx, w["q"], w["scale"], b, x_hi=x_hi,
                                   w_hi=w["hi"].float())
    torch.testing.assert_close(out, quant.matmul_w8a8(x, w, b), rtol=0, atol=0)
    assert (linear.LAUNCHES_W8A8, linear.LAUNCHES_W8A8_HI) == before
    with pytest.raises(ValueError, match="together"):
        linear.fused_linear_w8a8(xq, sx, w["q"], w["scale"], b, x_hi=x_hi)


@pytest.fixture(scope="module")
def jax_calibrated(setup):
    """JAX's calibrated outlier params from the fp32 stack, as numpy."""
    return jquant.calibrate_w8a8(setup["calib"], setup["jstacked"], CFG)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_outlier_encoder_layer_matches_jax(setup, jax_calibrated, dtype):
    """One outlier-aware layer (the same dicts on both sides): the port's
    chain, its plain versions on the CPU, against the JAX fused layer with
    outlier=True in interpret mode."""
    tdt, jdt = DTYPES[dtype]
    layer = 2
    jlp = {k: ({kk: jnp.asarray(vv[layer]) for kk, vv in v.items()}
               if isinstance(v, dict) else jnp.asarray(v[layer]))
           for k, v in jax_calibrated["layers"].items()}
    tlp = tvit._layer(tvit.params_from_jax(jax_calibrated, device="cpu"), layer)
    x = np.random.default_rng(4).normal(0, 0.5, (2, CFG.num_tokens, CFG.embed_dim))
    x = x.astype(np.float32)
    ref = jfused.fused_encoder_layer(jnp.asarray(x, jdt), jlp, CFG, w8a8=True,
                                     interpret=True)
    before = fused_block.LAUNCHES_W8A8_OUTLIER
    tx = torch.from_numpy(x).to(tdt)
    out = fused_block.fused_encoder_layer(tx, tlp, CFG, w8a8=True)
    plain = fused_block.fused_encoder_layer_reference(tx, tlp, CFG, w8a8=True)
    assert fused_block.LAUNCHES_W8A8_OUTLIER == before
    assert out.dtype == tdt
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    out, ref = _np(out), _np(ref)
    np.testing.assert_allclose(out, ref, **LAYER_TOL[dtype])
    close = np.abs(out - ref) <= 1e-6 + 1e-6 * np.abs(ref)
    assert close.mean() >= MIN_CLOSE_SHARE
    with pytest.raises(ValueError, match="w8a8"):
        fused_block.fused_encoder_layer(tx, tlp, CFG)


@pytest.mark.parametrize("route", ["xla", "flash"])
def test_outlier_forward_matches_jax_and_passes_gate(setup, jax_calibrated, route):
    """fp32, the same calibrated weights on both sides: within
    PROB_TOL_JAX of the JAX forward (its flash route runs the fused layer in
    interpret mode) and under the 0.01 gate against golden, where plain W8A8
    on the same weights is not."""
    images, ref = setup["images"], setup["golden"]
    kernels = tvit.resolve_kernels(route, w8a8=True, heads=HEADS)
    tq = tvit.params_from_jax(jax_calibrated, device="cpu")
    probs = tvit.forward(torch.from_numpy(images), tq, CFG,
                         compute_dtype=torch.float32, kernels=kernels).numpy()
    jprobs = np.asarray(jvit.forward(
        jnp.asarray(images), jax_calibrated, CFG, compute_dtype=jnp.float32,
        kernels=jvit.resolve_kernels(route, w8a8=True, heads=HEADS)))
    np.testing.assert_allclose(probs, jprobs, atol=PROB_TOL_JAX)
    assert np.abs(probs - ref).max() < GATE
    assert (probs.argmax(-1) == ref.argmax(-1)).all()
    plain = tvit.forward(torch.from_numpy(images),
                         quant.quantize_stacked_params(_tstack(setup["pn"]), CFG),
                         CFG, compute_dtype=torch.float32, kernels=kernels).numpy()
    assert np.abs(plain - ref).max() > GATE


def test_port_calibration_passes_gate_in_bf16(setup):
    """The port's own calibration, bf16 weights and compute through the
    chain (the card's configuration), under the gate with every label."""
    stacked = _tstack(setup["pn"], "bf16")
    qo = quant.calibrate_w8a8(setup["calib"], stacked, CFG)
    probs = tvit.forward(torch.from_numpy(setup["images"]), qo, CFG,
                         kernels=tvit.resolve_kernels("flash", w8a8=True,
                                                      heads=HEADS)).numpy()
    assert np.abs(probs - setup["golden"]).max() < GATE
    assert (probs.argmax(-1) == setup["golden"].argmax(-1)).all()


@pytest.mark.parametrize("mode", ["int8-w8a8", "auto"])
def test_engine_calibrate(setup, mode):
    engine = InferenceEngine(CFG, setup["pn"], batch_size=3, device="cpu",
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32, attention_impl="flash",
                             quantize=mode, calibrate=setup["calib"])
    assert engine.quantize == "int8-w8a8"
    assert "hi" in engine.params["layers"]["qkv_w"]
    probs = engine.run(setup["images"])  # 8 images: the last batch padded
    assert np.abs(probs - setup["golden"]).max() < GATE
    with pytest.raises(ValueError, match="calibrate"):
        InferenceEngine(CFG, setup["pn"], calibrate=setup["calib"], device="cpu")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, setup):
    """A reference-format workspace of the adversarial weights, a
    calibration binary, and the golden answer file. Images whose golden
    top-2 probabilities are within 0.01 are left out: there even the bf16
    path without quantization may swap the label (one of the 8 is 0.002
    apart), and the exact-label gate would test a coin toss."""
    root = tmp_path_factory.mktemp("ws_outlier")
    pn = setup["pn"]
    rounded = {k: binfmt.round_6dp(v) for k, v in pn.items()}
    probs = golden.golden_forward(setup["images"], rounded, CFG)
    top2 = np.sort(probs, axis=-1)[:, -2:]
    keep = top2[:, 1] - top2[:, 0] >= 0.01
    assert keep.sum() >= 4
    binfmt.save_image_data(root / "input.bin", setup["images"][keep])
    binfmt.save_image_data(root / "calib.bin", setup["calib"])
    binfmt.save_weights(root / "Network", fixtures.params_to_positional(pn, CFG), CFG)
    results.write_results(root / "answer.txt", probs[keep])
    return root


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("mode", [[], ["--quantize", "int8-w8a8"], ["--quantize", "auto"]],
                         ids=["implied", "w8a8", "auto"])
def test_cli_calibrate_matches_answer(workspace, monkeypatch, capsys, mode, attention):
    monkeypatch.setitem(tconfig.PRESETS, CFG.name, CFG)
    ws = workspace
    rc = cli.main(["--input", str(ws / "input.bin"), "--weights", str(ws / "Network"),
                   "--output", str(ws / f"result_{attention}_{len(mode)}.txt"),
                   "--answer", str(ws / "answer.txt"), "--config", CFG.name,
                   "--backend", "gpu", "--device", "cpu", "--batch-size", "4",
                   "--attention", attention, *mode,
                   "--calibrate", str(ws / "calib.bin")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "calibration set: 16 images" in out
    assert "Comparator: files match." in out

"""The port's int8 path against the JAX package's: weight quantization, the
activation quantize, the int8 matmuls, the int8 encoder layers (Pallas in
interpret mode) and the W8A8 forward; then the engine and the CLI with
``--quantize`` on the CPU.

Inputs are made with numpy from seeds. On CPU tensors no kernel launches,
which the layer tests check through the counters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_with_opencl_tpu import config as jconfig
from vit_with_opencl_tpu import engine as jengine
from vit_with_opencl_tpu.harness import fixtures as jfixtures
from vit_with_opencl_tpu.models import quant as jquant
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.ops import fused_block as jfused
from vit_with_opencl_tpu_torch import ViTConfig, cli
from vit_with_opencl_tpu_torch import config as tconfig
from vit_with_opencl_tpu_torch import engine as tengine
from vit_with_opencl_tpu_torch.harness import fixtures, results
from vit_with_opencl_tpu_torch.io import binfmt
from vit_with_opencl_tpu_torch.models import golden, quant
from vit_with_opencl_tpu_torch.models import vit as tvit
from vit_with_opencl_tpu_torch.ops import fused_block, linear, quantize

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
CFG = ViTConfig(name="q", img_size=32, patch_size=8, embed_dim=64, depth=2,
                num_heads=4, num_classes=19)
# Both sides compute the integer sums exactly and the same fp32 epilogue;
# fp32 GEMMs (matmul_q) sum in another order (tests/test_quant.py:163).
MATMUL_RTOL = 1e-6
MATMUL_ATOL = 1e-6
# The int8 layers: elementwise within LAYER_TOL of the JAX kernel, and at
# least MIN_CLOSE_SHARE of the elements within 1e-6 of it. fp32 LN sums in
# another order can flip an int8 decision, which moves its row's downstream
# values by about one quantum; a moved rounding point (a bf16 rounding of
# the LN output or of the GELU'd hidden before its quantize) moves half of
# the elements or more.
LAYER_TOL = {"f32": dict(rtol=0, atol=1e-2), "bf16": dict(rtol=1.6e-2, atol=1.6e-2)}
MIN_CLOSE_SHARE = 0.9
# Forward: W8A8 probabilities within 5e-4 of the JAX forward at depth 2,
# within 1e-2 of golden with the same argmax (tests/test_quant.py:109-110).
PROB_TOL_JAX = 5e-4
PROB_TOL_GOLDEN = 1e-2


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _counts():
    return (quantize.LAUNCHES, linear.LAUNCHES, linear.LAUNCHES_INT8W,
            linear.LAUNCHES_W8A8, fused_block.LAUNCHES,
            fused_block.LAUNCHES_INT8W, fused_block.LAUNCHES_W8A8)


def _flat(p):
    """Stacked params → {dotted key: leaf}, quantized dicts opened up."""
    out = {}
    for key, value in p.items():
        if isinstance(value, dict):
            for sub, leaf in _flat(value).items():
                out[f"{key}.{sub}"] = leaf
        else:
            out[key] = value
    return out


def _assert_same_leaves(ours, theirs):
    a, b = _flat(ours), _flat(theirs)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0, msg=key)


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 64, 48)) * 0.3).astype(np.float32)
    w[1, :, 5] = 0.0  # a zero channel: scale 0, made safe
    ours, theirs = quant.quantize_weight(w), jquant.quantize_weight(w)
    for key in ("q", "scale"):
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key])
    np.testing.assert_array_equal(quant.dequantize_weight(ours),
                                  jquant.dequantize_weight(theirs))
    assert quant.is_quantized(ours) and not quant.is_quantized(w)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_quantize_stacked_params_matches_jax(param_dtype):
    """From the weights as stacked to param_dtype (bf16-rounded for bf16),
    both packages give the same int8 weights and scales, bit for bit."""
    tdt, jdt = DTYPES[param_dtype]
    named = fixtures.random_params(CFG, seed=1, scale=0.05)
    theirs = jquant.quantize_stacked_params(
        jvit.stack_params(named, CFG, param_dtype=jdt), CFG)
    ours = quant.quantize_stacked_params(
        tvit.stack_params(named, CFG, param_dtype=tdt, device="cpu"), CFG)
    flat = _flat(ours)
    assert flat["layers.qkv_w.q"].dtype == torch.int8
    assert flat["layers.qkv_w.scale"].shape == (CFG.depth, 1, 3 * CFG.embed_dim)
    assert flat["patch_w.q"].dtype == torch.int8
    for key, leaf in _flat(theirs).items():
        np.testing.assert_array_equal(_np(flat[key]), _np(leaf), err_msg=key)


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_params_from_jax_quantized_equals_port(param_dtype):
    """The JAX package's quantized stacked params, as numpy, become the
    port's layout value for value: int8 as torch.int8, scales as fp32."""
    tdt, jdt = DTYPES[param_dtype]
    named = fixtures.random_params(CFG, seed=2, scale=0.05)
    jq = jquant.quantize_stacked_params(
        jvit.stack_params(named, CFG, param_dtype=jdt), CFG)
    as_numpy = {k: (v if isinstance(v, dict) else np.asarray(v))
                for k, v in jq.items() if k != "layers"}
    as_numpy["layers"] = {k: (v if isinstance(v, dict) else np.asarray(v))
                          for k, v in jq["layers"].items()}
    ours = quant.quantize_stacked_params(
        tvit.stack_params(named, CFG, param_dtype=tdt, device="cpu"), CFG)
    _assert_same_leaves(tvit.params_from_jax(as_numpy, device="cpu"), ours)


def test_quantize_weight_device_matches_jax():
    w = (np.random.default_rng(3).standard_normal((2, 32, 16)) * 0.2).astype(np.float32)
    w[0, :, 3] = 0.0
    ours = quant.quantize_weight_device(torch.from_numpy(w))
    theirs = jquant.quantize_weight_device(jnp.asarray(w))
    for key in ("q", "scale"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]))
    stacked = tvit.stack_params(fixtures.random_params(CFG, seed=3), CFG,
                                param_dtype=torch.float32, device="cpu")
    dev = quant.quantize_stacked_params_device(stacked, CFG)
    assert dev["layers"]["fc1_w"]["q"].dtype == torch.int8


def _act_cases():
    rng = np.random.default_rng(5)
    normal = rng.normal(0.0, 2.0, (5, 7, 48)).astype(np.float32)
    normal[1, 3] = 0.0  # a zero row: the 2^-93 floor
    # absmax 127 gives r = 1: exact half-way values must round to even.
    half = np.zeros((2, 16), np.float32)
    half[0, :6] = [127.0, 2.5, 3.5, -2.5, 0.5, -1.5]
    half[1, :4] = [-127.0, 126.5, -0.5, 1.5]
    return {"normal": normal, "half_way": half}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["normal", "half_way"])
def test_quantize_act_matches_jax(dtype, case):
    tdt, jdt = DTYPES[dtype]
    x = _act_cases()[case]
    jq, js = jquant.quantize_act(jnp.asarray(x, jdt))
    before = quantize.LAUNCHES
    for q, s in (quant.quantize_act(torch.from_numpy(x).to(tdt)),
                 quantize.quantize_rows(torch.from_numpy(x).to(tdt))):
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert s.shape == x.shape[:-1] + (1,)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert quantize.LAUNCHES == before
    if case == "half_way":
        q, _ = quant.quantize_act(torch.from_numpy(x))
        assert q[0, :6].tolist() == [127, 2, 4, -2, 0, -2]
        assert q[1, :4].tolist() == [-127, 126, 0, 2]
    else:
        _, s = quant.quantize_act(torch.from_numpy(x))
        assert s[1, 3, 0].item() == np.float32(2.0 ** -93 / 127)


def _weight_pair(rng, k, n):
    qw = jquant.quantize_weight(rng.standard_normal((k, n)).astype(np.float32) * 0.2)
    return ({key: torch.from_numpy(v) for key, v in qw.items()},
            {key: jnp.asarray(v) for key, v in qw.items()})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fn", ["matmul_w8a8", "matmul_q"])
def test_int8_matmuls_match_jax(dtype, fn):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    tw, jw = _weight_pair(rng, 64, 32)
    b = rng.standard_normal(32).astype(np.float32)
    for bias in (None, b):
        ref = getattr(jquant, fn)(jnp.asarray(x, jdt), jw,
                                  None if bias is None else jnp.asarray(bias))
        out = getattr(quant, fn)(torch.from_numpy(x).to(tdt), tw,
                                 None if bias is None else torch.from_numpy(bias))
        assert out.dtype == tdt and out.shape == (2, 5, 32)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=MATMUL_RTOL,
                                   atol=MATMUL_ATOL if dtype == "f32" else 0)


def test_int8_matmuls_refuse_stacked_and_outlier_weights():
    """Stacked weights are refused by both int8 matmuls. Outlier-aware dicts
    (a bf16 "hi" group) run W8A8 in the trailing and the masked form, as the
    JAX package's matmul_w8a8 does, and are refused by weight-only int8
    (ValueError, as the JAX package's fused layer refuses them)."""
    rng = np.random.default_rng(8)
    tw, _ = _weight_pair(rng, 16, 16)
    x = torch.zeros(3, 16)
    stacked = {k: v[None] for k, v in tw.items()}
    for fn in (quant.matmul_q, quant.matmul_w8a8):
        with pytest.raises(ValueError, match="single layer"):
            fn(x, stacked, None)
    heads = (4, 4)
    xs = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3.0
    w = rng.standard_normal((16, 8)).astype(np.float32) * 0.2
    mask = np.zeros(16, bool)
    mask[3::4] = True  # the last column of each 4-wide head
    for jw in (jquant._split_weight(w, 4), jquant._masked_weight(w, mask)):
        ours = tvit.params_from_jax({"layers": {"w": jw}}, device="cpu")["layers"]["w"]
        assert ours["hi"].dtype == torch.bfloat16
        ref = jquant.matmul_w8a8(jnp.asarray(xs), {k: jnp.asarray(v) for k, v in jw.items()},
                                 None, heads=heads)
        out = quant.matmul_w8a8(torch.from_numpy(xs), ours, None, heads=heads)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=MATMUL_RTOL,
                                   atol=MATMUL_ATOL)
        with pytest.raises(ValueError, match="w8a8"):
            quant.matmul_q(torch.from_numpy(xs), ours, None)
    # fp weights through matmul_w8a8 run as matmul_q, as in the JAX package.
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    torch.testing.assert_close(quant.matmul_w8a8(x, w, None),
                               quant.matmul_q(x, w, None), rtol=0, atol=0)


def test_int8_gemm_wrappers_match_plain_on_cpu():
    """On CPU tensors the two int8 GEMM wrappers compute their plain
    versions: the weight-only form against matmul_q's numbers, the W8A8 form
    against matmul_w8a8's (before its cast)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((7, 64)).astype(np.float32))
    tw, _ = _weight_pair(rng, 64, 32)
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    before = (linear.LAUNCHES_INT8W, linear.LAUNCHES_W8A8)
    out = linear.fused_linear(x, tw["q"], b, w_scale=tw["scale"])
    torch.testing.assert_close(out, quant.matmul_q(x, tw, b), rtol=0, atol=0)
    xq, sx = quant.quantize_act(x)
    out = linear.fused_linear_w8a8(xq, sx, tw["q"], tw["scale"], b)
    torch.testing.assert_close(out, quant.matmul_w8a8(x, tw, b), rtol=0, atol=0)
    assert (linear.LAUNCHES_INT8W, linear.LAUNCHES_W8A8) == before
    with pytest.raises(ValueError, match="w_scale"):
        linear.fused_linear(x, tw["q"], b)


ENC_CFG = ViTConfig(name="enc", img_size=32, patch_size=8, embed_dim=64,
                    depth=2, num_heads=4, num_classes=9)


@pytest.fixture(scope="module")
def encoder_layer_inputs():
    params = jfixtures.random_params(ENC_CFG, seed=4, scale=0.05)
    x = np.random.default_rng(4).normal(0, 0.5, (2, 37, 64)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("w8a8", [False, True], ids=["int8w", "w8a8"])
def test_int8_encoder_layer_matches_jax(encoder_layer_inputs, dtype, w8a8):
    """One quantized layer (the same int8 lp on both sides) against the JAX
    fused layer in interpret mode. The int8-weight and W8A8 stacks, which
    JAX's forward picks for small int8 configs, are held to JAX's
    ``fused_encoder_stack`` in tests/test_torch_stack.py."""
    params, x = encoder_layer_inputs
    tdt, jdt = DTYPES[dtype]
    stacked = jquant.quantize_stacked_params(
        jvit.stack_params(params, ENC_CFG, param_dtype=jdt), ENC_CFG)
    jlp = {k: ({kk: jnp.asarray(vv[1]) for kk, vv in v.items()}
               if isinstance(v, dict) else jnp.asarray(v[1]))
           for k, v in stacked["layers"].items()}
    tlp = tvit._layer(tvit.params_from_jax(stacked, device="cpu"), 1)
    ref = jfused.fused_encoder_layer(jnp.asarray(x, jdt), jlp, ENC_CFG,
                                     w8a8=w8a8, interpret=True)
    before = _counts()
    tx = torch.from_numpy(x).to(tdt)
    out = fused_block.fused_encoder_layer(tx, tlp, ENC_CFG, w8a8=w8a8)
    plain = fused_block.fused_encoder_layer_reference(tx, tlp, ENC_CFG, w8a8=w8a8)
    assert _counts() == before
    assert out.dtype == tdt
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    out, ref = _np(out), _np(ref)
    np.testing.assert_allclose(out, ref, **LAYER_TOL[dtype])
    assert (np.abs(out - ref) <= 1e-6).mean() >= MIN_CLOSE_SHARE


def test_outlier_weights_refused_by_the_chains(encoder_layer_inputs):
    """Calibrated outlier-aware weights: the weight-only chain refuses them
    (ValueError, as the JAX package's _group_call); the W8A8 chain runs its
    outlier form (tests/test_torch_quant_outlier.py holds it to JAX)."""
    params, x = encoder_layer_inputs
    stacked = quant.calibrate_w8a8(
        jfixtures.random_images(ENC_CFG, n=2, seed=1),
        tvit.stack_params(params, ENC_CFG, param_dtype=torch.float32, device="cpu"),
        ENC_CFG)
    lp = tvit._layer(stacked, 0)
    assert "hi" in lp["fc2_w"]
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="w8a8"):
        fused_block.fused_encoder_layer(tx, lp, ENC_CFG)
    out = fused_block.fused_encoder_layer(tx, lp, ENC_CFG, w8a8=True)
    assert out.shape == tx.shape and torch.isfinite(out).all()
    torch.testing.assert_close(
        out, fused_block.fused_encoder_layer_reference(tx, lp, ENC_CFG, w8a8=True),
        rtol=0, atol=0)


@pytest.fixture(scope="module")
def forward_setup():
    params = fixtures.random_params(CFG, seed=9, scale=0.05)
    images = fixtures.random_images(CFG, n=4, seed=9)
    return params, images, golden.golden_forward(images, params, CFG)


@pytest.mark.parametrize("route", ["xla", "flash"])
def test_w8a8_forward_matches_jax(forward_setup, route):
    """fp32 activations and weights, int8 from the same fp32 stack: the
    W8A8 forward of both packages (JAX's flash route runs its fused layer in
    interpret mode, W8A8 never takes its stack kernel)."""
    params, images, ref = forward_setup
    stacked = jvit.stack_params(params, CFG, param_dtype=jnp.float32)
    jq = jquant.quantize_stacked_params(stacked, CFG)
    jprobs = np.asarray(jvit.forward(jnp.asarray(images), jq, CFG,
                                     compute_dtype=jnp.float32,
                                     kernels=jvit.resolve_kernels(route, w8a8=True)))
    tq = tvit.params_from_jax(jq, device="cpu")
    tprobs = tvit.forward(torch.from_numpy(images), tq, CFG,
                          compute_dtype=torch.float32,
                          kernels=tvit.resolve_kernels(route, w8a8=True)).numpy()
    np.testing.assert_allclose(tprobs, jprobs, atol=PROB_TOL_JAX)
    np.testing.assert_allclose(tprobs, ref, atol=PROB_TOL_GOLDEN)
    assert (tprobs.argmax(-1) == ref.argmax(-1)).all()


def test_quantized_params_ignore_a_forced_encoder_block(forward_setup):
    params, images, _ = forward_setup
    tq = quant.quantize_stacked_params(
        tvit.stack_params(params, CFG, param_dtype=torch.float32, device="cpu"), CFG)
    x = torch.from_numpy(images)

    def boom(*_args, **_kw):
        raise AssertionError("a forced encoder_block ran on quantized params")

    kernels = tvit.resolve_kernels("flash", w8a8=True)
    want = tvit.forward(x, tq, CFG, compute_dtype=torch.float32, kernels=kernels)
    got = tvit.forward(x, tq, CFG, compute_dtype=torch.float32,
                       kernels={**kernels, "encoder_block": boom})
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_resolve_quantize_matches_jax():
    for name, cfg in jconfig.PRESETS.items():
        for mode in (None, "int8", "int8-w8a8", "auto"):
            for calibrated in (False, True):
                assert tengine.resolve_quantize(
                    mode, tconfig.PRESETS[name], calibrated=calibrated) == \
                    jengine.resolve_quantize(mode, cfg, calibrated=calibrated), (
                        name, mode, calibrated)
    assert tengine.resolve_quantize("auto", tconfig.VIT_B_16_224) == "int8-w8a8"


E2E_CFG = ViTConfig(name="e2e_quant_torch", img_size=32, patch_size=8,
                    embed_dim=48, depth=2, num_heads=4, num_classes=1000)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A fake reference workspace: input binary + weight dir + answer file."""
    root = tmp_path_factory.mktemp("ws_quant")
    params = fixtures.random_params(E2E_CFG, seed=11, scale=0.05)
    images = fixtures.random_images(E2E_CFG, n=5, seed=5)
    binfmt.save_image_data(root / "input.bin", images)
    binfmt.save_weights(root / "Network", fixtures.params_to_positional(params, E2E_CFG),
                        E2E_CFG)
    rounded = {k: binfmt.round_6dp(v) for k, v in params.items()}
    results.write_results(root / "answer.txt",
                          golden.golden_forward(images, rounded, E2E_CFG))
    return root


def _argv(ws, output, *extra):
    return ["--input", str(ws / "input.bin"), "--weights", str(ws / "Network"),
            "--output", str(ws / output), "--answer", str(ws / "answer.txt"),
            "--config", E2E_CFG.name, "--backend", "gpu", "--device", "cpu",
            "--batch-size", "2", *extra]


@pytest.mark.parametrize("attention", ["xla", "flash"])
@pytest.mark.parametrize("mode", ["int8", "int8-w8a8", "auto"])
def test_cli_quantize_matches_answer(workspace, monkeypatch, capsys, mode, attention):
    monkeypatch.setitem(tconfig.PRESETS, E2E_CFG.name, E2E_CFG)
    rc = cli.main(_argv(workspace, f"result_{mode}_{attention}.txt",
                        "--attention", attention, "--quantize", mode))
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Comparator: files match." in out


def test_engine_quantize_modes(forward_setup):
    params, images, ref = forward_setup
    kw = dict(batch_size=3, param_dtype=torch.float32,
              compute_dtype=torch.float32, attention_impl="flash", device="cpu")
    for mode, want in (("int8", "int8"), ("int8-w8a8", "int8-w8a8"),
                       ("auto", None)):  # CFG is stack-class: auto stays fp
        engine = tengine.InferenceEngine(CFG, params, quantize=mode, **kw)
        assert engine.quantize == want
        assert engine.kernels.get("w8a8", False) == (want == "int8-w8a8")
        probs = engine.run(images)
        np.testing.assert_allclose(probs, ref, atol=PROB_TOL_GOLDEN)
        assert (probs.argmax(-1) == ref.argmax(-1)).all()
    with pytest.raises(ValueError, match="unknown quantize"):
        tengine.InferenceEngine(CFG, params, quantize="int4", **kw)


def test_calibrate_raises_until_ported(forward_setup, workspace, monkeypatch,
                                      capsys):
    """``calibrate=`` ran into NotImplementedError until the outlier-aware
    mode was ported; now it runs the calibrated W8A8 (never plain W8A8 in
    its place), and still raises ValueError without a W8A8 mode."""
    params, images, ref = forward_setup
    for mode in ("auto", "int8-w8a8"):
        engine = tengine.InferenceEngine(CFG, params, quantize=mode,
                                         calibrate=images, device="cpu",
                                         param_dtype=torch.float32,
                                         compute_dtype=torch.float32)
        assert engine.quantize == "int8-w8a8"
        assert "hi" in engine.params["layers"]["qkv_w"]
        probs = engine.run(images)
        np.testing.assert_allclose(probs, ref, atol=PROB_TOL_GOLDEN)
        assert (probs.argmax(-1) == ref.argmax(-1)).all()
    with pytest.raises(ValueError, match="calibrate"):
        tengine.InferenceEngine(CFG, params, calibrate=images, device="cpu")
    monkeypatch.setitem(tconfig.PRESETS, E2E_CFG.name, E2E_CFG)
    rc = cli.main(_argv(workspace, "result_cal.txt", "--calibrate",
                        str(workspace / "input.bin")))
    out = capsys.readouterr().out
    assert rc == 0 and "Comparator: files match." in out, out

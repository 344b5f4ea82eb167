"""Substitution attribution (``perf/profiler.attribute_forward`` and
``kernel_substitutions``) against the JAX package's, on CPU tensors.

Mirrors ``tests/test_perf.py``'s attribution tests (keys, shares in [0, 1],
the state restored, the same GEMM count under every substitution, the
re-entry guard), then holds each substituted forward to JAX's substituted
forward (its Pallas kernels in interpret mode) on the same seeded inputs,
and each stand-in to JAX's: the cheap quantize to ``astype(int8)`` with a
scale of 1, the constant-scale head to ``fake_head``, and every attention
route's plain version, including those that raise on the card.

JAX's kernels pad T where the port's do not, and its ``fake_head`` divides
by the padded T (and, in its whole-encoder stack, averages over the padded
rows as well); the softmax substitution's forwards are therefore compared
on the per-layer route (``supports_stack`` off in both packages, as
``scripts/probe_midsize``'s ``fused`` variant does), and the port's stack
is held in fp32 (where the stack and the per-layer chain are one function)
to JAX's per-layer route. Times here are CPU times, only checked to be
positive.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu.models import quant as jquant
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.ops import attention as jattn
from vit_with_opencl_tpu.ops import fused_block as jfused
from vit_with_opencl_tpu.perf import profiler as jprofiler
from vit_with_opencl_tpu_torch import ViTConfig
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.models import quant, vit
from vit_with_opencl_tpu_torch.ops import attention, fused_block, substitutions
from vit_with_opencl_tpu_torch.perf import profiler

# JAX's attribution test config (tests/test_perf.py:138-183).
CFG = ViTConfig(name="attr", img_size=32, patch_size=8, embed_dim=64, depth=2,
                num_heads=4, num_classes=9)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# Probabilities: the port's PROB_ATOL (tests/test_torch_model.py).
PROB_ATOL = {"f32": 1e-5, "bf16": 1e-3}
COMBOS = [(True, False, False), (False, True, False), (True, True, False)]
W8A8_COMBOS = [(False, False, True), (True, True, True)]
MATMULS = {"matmul", "mm", "bmm", "linear", "__matmul__", "__rmatmul__", "_int_mm",
           "addmm", "baddbmm", "einsum"}


class CountGemms(TorchFunctionMode):
    """Counts the matmul-family calls made while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in MATMULS:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def setup():
    params = fixtures.random_params(CFG, seed=7, scale=0.05)
    images = fixtures.random_images(CFG, n=3, seed=3)
    return params, images


def _restored():
    assert substitutions.state() == (False, False, False)
    assert fused_block._gelu_fast.__name__ == "_gelu_fast"
    assert attention._head_attention.__name__ == "_head_attention"
    assert quant.quantize_act.__name__ == "quantize_act"


def _forward(images, params, dtype, w8a8=False):
    return vit.forward(torch.from_numpy(images), params, CFG, compute_dtype=dtype,
                       kernels=vit.resolve_kernels("flash", w8a8=w8a8))


def _jax_forward(images, params, dtype, w8a8=False):
    return np.asarray(jvit.forward(jnp.asarray(images), params, CFG, compute_dtype=dtype,
                                   kernels=jvit.resolve_kernels("flash", w8a8=w8a8)))


class per_layer:
    """Both packages' ``flash`` route on the per-layer chain (the stack off),
    restored on exit."""

    def __enter__(self):
        self.saved = fused_block.supports_stack, jfused.supports_stack
        fused_block.supports_stack = jfused.supports_stack = lambda *a, **k: False

    def __exit__(self, *exc):
        fused_block.supports_stack, jfused.supports_stack = self.saved


# -- the mirrors of tests/test_perf.py -------------------------------------


def test_attribute_forward_substitution(setup):
    """The real forward and its three substituted forms, timed; the keys
    are JAX's and the shares lie in [0, 1]; everything restored after."""
    params, images = setup
    stacked = vit.stack_params(params, CFG, param_dtype=torch.float32, device="cpu")
    a = profiler.attribute_forward(CFG, stacked, torch.from_numpy(images[:2]),
                                   compute_dtype=torch.float32, iters=1)
    assert set(a) == {"total_ms", "gelu_ms", "softmax_ms", "gemm_skeleton_ms",
                      "gelu_share", "softmax_share", "vpu_share"}
    assert a["total_ms"] > 0 and a["gemm_skeleton_ms"] > 0
    for k in ("gelu_share", "softmax_share", "vpu_share"):
        assert 0.0 <= a[k] <= 1.0
    assert a["gelu_ms"] >= 0 and a["softmax_ms"] >= 0
    _restored()


def test_attribute_forward_w8a8_quantize_share(setup):
    """W8A8 attribution adds the quantize's share and restores the state."""
    params, images = setup
    qparams = quant.quantize_stacked_params(
        vit.stack_params(params, CFG, param_dtype=torch.float32, device="cpu"), CFG)
    a = profiler.attribute_forward(CFG, qparams, torch.from_numpy(images[:2]),
                                   compute_dtype=torch.float32, iters=1,
                                   quant="int8-w8a8")
    assert {"quantize_ms", "quantize_share"} <= set(a)
    assert a["total_ms"] > 0 and a["gemm_skeleton_ms"] > 0
    assert 0.0 <= a["quantize_share"] <= 1.0
    _restored()


def test_kernel_substitutions_preserve_spec_and_gemm_count(setup):
    """Each substitution keeps the output's shape and dtype and the
    forward's matmul count (it removes work around the GEMMs, never a
    GEMM); on exit the real forward comes back, with the same count."""
    params, images = setup
    tparams = vit.stack_params(params, CFG, param_dtype=torch.bfloat16, device="cpu")

    def run():
        with CountGemms() as mode:
            out = _forward(images[:2], tparams, torch.bfloat16)
        return out, mode.n

    base, base_n = run()
    assert base_n > 0
    for combo in COMBOS:
        with profiler.kernel_substitutions(*combo):
            out, n = run()
        assert (out.shape, out.dtype) == (base.shape, base.dtype)
        assert n == base_n, combo
        assert not torch.equal(out, base), combo
    out, n = run()
    assert n == base_n and torch.equal(out, base)
    _restored()


def test_kernel_substitutions_w8a8_quant_cheap(setup):
    params, images = setup
    qparams = quant.quantize_stacked_params(
        vit.stack_params(params, CFG, param_dtype=torch.float32, device="cpu"), CFG)

    def run():
        with CountGemms() as mode:
            out = _forward(images[:2], qparams, torch.bfloat16, w8a8=True)
        return out, mode.n

    base, base_n = run()
    for combo in W8A8_COMBOS:
        with profiler.kernel_substitutions(*combo):
            out, n = run()
        assert (out.shape, out.dtype) == (base.shape, base.dtype)
        assert n == base_n, combo
    # quantize_act's stand-in keeps its output structure (int8 values and a
    # per-row fp32 scale), so the GEMMs after it are the same.
    x = torch.zeros((4, CFG.embed_dim))
    real = quant.quantize_act(x)
    with profiler.kernel_substitutions(False, False, True):
        fake = quant.quantize_act(x)
    assert [(t.shape, t.dtype) for t in real] == [(t.shape, t.dtype) for t in fake]
    _restored()


def test_kernel_substitutions_reentrancy_guard_still_works(setup):
    params, images = setup
    stacked = vit.stack_params(params, CFG, param_dtype=torch.float32, device="cpu")
    assert profiler._ATTRIBUTION_LOCK.acquire(blocking=False)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            profiler.attribute_forward(CFG, stacked, torch.from_numpy(images[:2]),
                                       iters=1)
    finally:
        profiler._ATTRIBUTION_LOCK.release()
    _restored()


def test_kernel_substitutions_restore_when_the_block_raises():
    with pytest.raises(ValueError, match="inside"):
        with profiler.kernel_substitutions(True, True, True):
            assert substitutions.state() == (True, True, True)
            raise ValueError("inside")
    _restored()


# -- the substituted forward against JAX's ---------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "".join("TF"[not v] for v in c))
def test_substituted_forward_matches_jax(setup, combo, dtype):
    """The port's substituted forward equals JAX's under its own
    substitution (the per-layer route in both), and differs from the real
    forward: the swap reached the plain versions."""
    params, images = setup
    tdt, jdt = DTYPES[dtype]
    stacked = jvit.stack_params(params, CFG, param_dtype=jdt)
    tparams = vit.params_from_jax(stacked, device="cpu")
    with per_layer():
        real = _forward(images, tparams, tdt).numpy()
        with jprofiler.kernel_substitutions(*combo):
            want = _jax_forward(images, stacked, jdt)
        with profiler.kernel_substitutions(*combo):
            got = _forward(images, tparams, tdt).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_ATOL[dtype])
    assert np.abs(got - real).max() > 10 * PROB_ATOL[dtype]


@pytest.mark.parametrize("combo", [(True, False, False), (False, True, False)],
                         ids=["gelu", "softmax"])
def test_substituted_stack_matches_jax_per_layer_in_fp32(setup, combo):
    """The port's whole-encoder stack (its default route for this config)
    under a substitution equals JAX's per-layer route under its own: in
    fp32 the stack and the per-layer chain are one function. (JAX's stack
    under the softmax substitution also averages over its 16-row padding.)"""
    params, images = setup
    stacked = jvit.stack_params(params, CFG, param_dtype=jnp.float32)
    tparams = vit.params_from_jax(stacked, device="cpu")
    assert fused_block.supports_stack(CFG)
    before = fused_block.LAUNCHES_STACK
    with profiler.kernel_substitutions(*combo):
        got = _forward(images, tparams, torch.float32).numpy()
    with per_layer(), jprofiler.kernel_substitutions(*combo):
        want = _jax_forward(images, stacked, jnp.float32)
    assert fused_block.LAUNCHES_STACK == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got, want, atol=PROB_ATOL["f32"])


@pytest.mark.parametrize("combo", W8A8_COMBOS, ids=["quant", "all"])
def test_substituted_w8a8_forward_matches_jax(setup, combo):
    """W8A8 under the cheap quantize (alone and with the other two), in
    fp32 as JAX's own W8A8 attribution test runs it: a bf16 rounding before
    the truncation would flip a whole code."""
    params, images = setup
    jq = jquant.quantize_stacked_params(
        jvit.stack_params(params, CFG, param_dtype=jnp.float32), CFG)
    tq = vit.params_from_jax(jq, device="cpu")
    real = _forward(images, tq, torch.float32, w8a8=True).numpy()
    with jprofiler.kernel_substitutions(*combo):
        want = _jax_forward(images, jq, jnp.float32, w8a8=True)
    with profiler.kernel_substitutions(*combo):
        got = _forward(images, tq, torch.float32, w8a8=True).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_ATOL["f32"])
    assert np.abs(got - real).max() > 10 * PROB_ATOL["f32"]


# -- the stand-ins ----------------------------------------------------------


def test_cheap_quantize_is_the_int8_convert():
    """In range: the codes of JAX's ``astype(int8)`` (truncation toward
    zero) bit for bit, the scale 1.0; outside int8's range the port
    saturates; the split form quantizes its leading columns so and rounds
    the rest as the real one does."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((33, 192)) * 40).astype(np.float32)
    x[0, :4] = [127.99, -128.99, 0.999, -0.999]
    with profiler.kernel_substitutions(False, False, True):
        q, s = quant.quantize_act(torch.from_numpy(x))
        q_split, s_split, hi = quant.quantize_act_split(torch.from_numpy(x), 128,
                                                       torch.bfloat16)
        with jprofiler.kernel_substitutions(False, False, True):
            jq, js = jquant.quantize_act(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s.shape == (33, 1) and bool((s == 1.0).all())
    np.testing.assert_array_equal(q_split.numpy(), q.numpy()[:, :128])
    assert bool((s_split == 1.0).all())
    assert torch.equal(hi, torch.from_numpy(x[:, 128:]).to(torch.bfloat16))
    big = torch.tensor([[300.0, -300.0, 128.0, -129.0, 127.5, -128.5, 5.0, -5.0]])
    with profiler.kernel_substitutions(False, False, True):
        qb, _ = quant.quantize_act(big)
    assert qb.tolist() == [[127, -128, 127, -128, 127, -128, 5, -5]]
    _restored()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_const_scale_head_matches_fake_head(dtype):
    """The constant-scale head on [T, hd] equals JAX's ``fake_head`` (what
    its ``_head_attention`` is under the substitution) to fp32 rounding."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((37, 16)).astype(np.float32) for _ in range(3))
    scale = float(1.0 / np.sqrt(16))
    with profiler.kernel_substitutions(False, True):
        got = attention._head_attention(*(torch.from_numpy(z).to(tdt) for z in (q, k, v)),
                                        scale)
    with jprofiler.kernel_substitutions(False, True):
        want, p = jattn._head_attention(*(jnp.asarray(z, jdt) for z in (q, k, v)), scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert attention.const_scale(37) == float(np.float32(1.0 / 37))
    _restored()


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t", [17, 128])
def test_single_pass_plain_follows_jax_stand_in(t):
    """Row 8's plain version (``flash_attention`` on CPU tensors) under the
    substitution: JAX's single-pass kernel pads T to a multiple of 128, and
    its stand-in's weight is 1/T_pad (the padded keys are zeros); the
    port's is 1/T. At T = 128 the two are equal; at T = 17 JAX's is the
    port's times 17/128 (fp32 inputs: no rounding between)."""
    nh, hd = 4, 16
    q, k, v = (_rand((2, nh, t, hd), s) for s in (1, 2, 3))
    with profiler.kernel_substitutions(False, True):
        got = attention.flash_attention(*(torch.from_numpy(z) for z in (q, k, v)),
                                        CFG).numpy()
    with jprofiler.kernel_substitutions(False, True):
        want = np.asarray(jattn.flash_attention(*(jnp.asarray(z) for z in (q, k, v)),
                                                CFG))
    t_pad = max(-(-t // 128) * 128, 128)
    np.testing.assert_allclose(got * (t / t_pad), want, rtol=1e-5, atol=1e-5)
    with profiler.kernel_substitutions(False, True):
        direct = attention.single_pass_attention_reference(
            *(torch.from_numpy(z) for z in (q, k, v)), hd, kv_len=max(1, t - 3))
    np.testing.assert_allclose(direct.numpy(), got, rtol=0, atol=0)  # no mask
    _restored()


@pytest.mark.parametrize("packing,true_seq_len", [("slab", None), ("slab", 13),
                                                  ("per_head", None)])
def test_packed_plain_follows_jax_stand_in(packing, true_seq_len):
    """Row 4's plain version on every entry (the slab entry, the key-count
    entry's ``true_seq_len`` and per-head packing, which raise on the card
    under the substitution) equals JAX's ``packed_fused_attention`` under
    its own: no mask, the weight 1/T."""
    nh, hd, t = 4, 16, 17
    qkv = _rand((2, t, 3 * nh * hd), 4)
    kw = dict(num_heads=nh, head_dim=hd, packing=packing, true_seq_len=true_seq_len)
    with profiler.kernel_substitutions(False, True):
        got = attention.packed_fused_attention(torch.from_numpy(qkv), **kw).numpy()
    with jprofiler.kernel_substitutions(False, True):
        want = np.asarray(jattn.packed_fused_attention(jnp.asarray(qkv), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    real = attention.packed_fused_attention(torch.from_numpy(qkv), **kw).numpy()
    assert np.abs(got - real).max() > 1e-3
    _restored()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_attention_bwd_plain_follows_jax_stand_in(dtype):
    """Row 11's plain version under the substitution: p is the stand-in's
    fp32 scores (JAX's ``fake_head`` returns them as its second output)."""
    tdt, jdt = DTYPES[dtype]
    nh, hd, t = 4, 16, 17
    qkv = _rand((2, t, 3 * nh * hd), 5) * 0.3
    do = _rand((2, t, nh * hd), 6)
    with profiler.kernel_substitutions(False, True):
        got = attention.packed_attention_bwd(torch.from_numpy(qkv).to(tdt),
                                             torch.from_numpy(do).to(tdt), nh, hd)
    with jprofiler.kernel_substitutions(False, True):
        want = jattn.packed_attention_bwd(jnp.asarray(qkv, jdt), jnp.asarray(do, jdt),
                                          nh, hd)
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
    else:
        same = (got.float().numpy() == want).mean()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=1e-2 * scale)
        assert same > 0.9
    real = attention.packed_attention_bwd(torch.from_numpy(qkv).to(tdt),
                                          torch.from_numpy(do).to(tdt), nh, hd)
    assert not torch.equal(real, got)
    _restored()


def test_gelu_identity_reaches_every_plain_gelu():
    """Under ``gelu_identity`` the epilogues of the plain GEMMs and the fc1
    recompute return their pre-activation; the gradient of the GELU stays
    (JAX swaps ``_gelu_fast`` alone)."""
    from vit_with_opencl_tpu_torch.ops import linear

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    plain = x @ w + b
    grad = fused_block._gelu_fast_grad(plain)
    with profiler.kernel_substitutions(True, False):
        assert torch.equal(linear.fused_linear(x, w, b, fuse_gelu=True),
                           linear.fused_linear(x, w, b))
        pre, hid = linear.fused_linear_with_gelu(x, w, b)
        assert torch.equal(pre, hid)
        assert torch.equal(fused_block._gelu_fast_grad(plain), grad)
        with jprofiler.kernel_substitutions(True, False):
            assert np.array_equal(np.asarray(jfused._gelu_fast(jnp.asarray(plain.numpy()))),
                                  plain.numpy())
    _restored()


def test_substitutions_nest_and_restore_the_outer_state():
    with profiler.kernel_substitutions(True, False, False):
        with profiler.kernel_substitutions(False, True, True):
            assert substitutions.state() == (False, True, True)
        assert substitutions.state() == (True, False, False)
    _restored()


def test_jax_stand_ins_were_restored():
    """The JAX package's own context, used beside the port's above, leaves
    its kernels as it found them (the comparisons read its swaps)."""
    assert jattn._head_attention.__name__ == "_head_attention"
    assert jquant.quantize_act.__name__ == "quantize_act"
    assert jfused._gelu_fast.__name__ == "_gelu_fast"
    assert jax.default_backend() == "cpu"

"""The port's training kernels' plain versions against the JAX package's
Pallas kernels (interpret mode on the CPU): the packed-attention backward,
the stages of the fused layer backward (with the H-chunked MLP pair of
ViT-L/H widths), the whole layer backward and the trainable layer and
attention under autograd.

Inputs are made with numpy from seeds and given to both sides. Sizes: D =
64, 4 heads of 16, H = 256, T = 17 (32-pixel images at patch 8), and T = 37
for the attention backward; the attention backward also at the presets'
sequence lengths (T = 577, hd = 64; T = 257, hd = 104) on 1 image, and the
trainable layer at D = 1024, H = 4096 (the narrowest width whose own
H-chunk count is 2) on T = 17. On CPU tensors every wrapper computes its
plain version; no kernel launches, which the tests check through the
counters.
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

from vit_with_opencl_tpu import config as jconfig
from vit_with_opencl_tpu.harness import fixtures as jfixtures
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.ops import attention as jattn
from vit_with_opencl_tpu.ops import fused_block as jfused
from vit_with_opencl_tpu_torch import ViTConfig
from vit_with_opencl_tpu_torch import config as tconfig
from vit_with_opencl_tpu_torch.models import vit as tvit
from vit_with_opencl_tpu_torch.ops import (_build, attention, fused_block,
                                           layernorm, linear)

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
CFG = ViTConfig(name="train_ops", img_size=32, patch_size=8, embed_dim=64,
                depth=1, num_heads=4, num_classes=9, mlp_ratio=4.0)
JCFG = jconfig.ViTConfig(name="train_ops", img_size=32, patch_size=8,
                         embed_dim=64, depth=1, num_heads=4, num_classes=9,
                         mlp_ratio=4.0)
T = CFG.num_tokens  # 17
# fp32: both sides round at the same points and sum in another order (XLA's
# dot and reductions against torch's): measured below 2e-6 relative to each
# output's largest magnitude.
F32_REL = 1e-5
# bf16 activations: the same rounding points, so most bf16 outputs are
# bit-identical to JAX's; a summation-order flip of one bf16 rounding moves
# that element by a bf16 ulp. bf16 outputs are held to 2e-2 of their largest
# magnitude and to a bit-identical share.
BF16_REL = 2e-2
# The fp32 gradients and residuals of a bf16 layer are sums of the same
# products as JAX's: measured within 2.4e-5 of their largest magnitude at
# seeds 20-60 (1e-7 where no bf16 rounding flips upstream). Held to 2e-4,
# which a rounding point moved to another place does not meet (a bias
# gradient summed from the bf16-rounded dqkv instead of the fp32 one:
# PERF.md, mutation checks).
BF16_GRAD_REL = 2e-4


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _rand(shape, seed, std=1.0):
    return np.random.default_rng(seed).normal(0, std, shape).astype(np.float32)


def _pair(a: np.ndarray, tdt, jdt):
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _close(got, want, rel, min_same=None, what=""):
    """|got − want| ≤ rel·max|want| elementwise; optionally a share of
    elements bit-identical. Returns the share."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e} > {rel} x {scale:.3e}"
    same = float((g == w).mean())
    if min_same is not None:
        assert same >= min_same, f"{what}: {same:.3f} bit-identical < {min_same}"
    return same


def _launches():
    return (attention.LAUNCHES, attention.LAUNCHES_BWD, attention.LAUNCHES_FLASH,
            attention.LAUNCHES_FLASH_LSE, attention.LAUNCHES_FLASH_BWD,
            layernorm.LAUNCHES,
            layernorm.LAUNCHES_BWD, layernorm.LAUNCHES_COLSUM, linear.LAUNCHES,
            linear.LAUNCHES_DGRAD, linear.LAUNCHES_WGRAD,
            linear.LAUNCHES_GELU_PAIR, fused_block.LAUNCHES,
            fused_block.LAUNCHES_BWD, fused_block.LAUNCHES_BWD_X2,
            fused_block.LAUNCHES_BWD_MLP, fused_block.LAUNCHES_BWD_MLP_LIGHT,
            fused_block.LAUNCHES_BWD_MLP_WGRAD, fused_block.LAUNCHES_BWD_ATTN)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    before = _launches()
    yield
    assert _launches() == before


def _layer(seed=7):
    """One layer's fp32 params for both sides (the masters of training)."""
    named = jfixtures.random_params(JCFG, seed=seed, scale=0.05)
    stacked = jvit.stack_params(named, JCFG, param_dtype=jnp.float32)
    jlp = {k: jnp.asarray(v[0]) for k, v in stacked["layers"].items()}
    tlp = {k: torch.from_numpy(np.array(v)) for k, v in jlp.items()}
    return tlp, jlp


# -- packed attention backward ---------------------------------------------

# Bit-identical share of the bf16 dqkv against JAX's kernel (measured
# 0.95-0.99 at T = 17 and 37 over these seeds; a ds from rowsum(dO ⊙ O)
# instead of rowsum(dp ⊙ p) drops it below 0.7).
MIN_SAME_ATTN_BWD = 0.9


@pytest.mark.parametrize("t", [17, 37, 197])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_attention_bwd_matches_jax(t, dtype):
    tdt, jdt = DTYPES[dtype]
    nh, hd = 4, 16
    tq, jq = _pair(_rand((2, t, 3 * nh * hd), 1), tdt, jdt)
    td, jd = _pair(_rand((2, t, nh * hd), 2), tdt, jdt)
    want = jattn.packed_attention_bwd(jq, jd, nh, hd)
    got = attention.packed_attention_bwd(tq, td, nh, hd)
    assert got.dtype == tdt
    if dtype == "f32":
        _close(got, want, F32_REL, what="dqkv")
    else:
        _close(got, want, BF16_REL, MIN_SAME_ATTN_BWD, "dqkv")


def test_packed_attention_bwd_fp32_out_is_the_unrounded_dqkv():
    """The fp32 output (the fused layer's bias-gradient input) rounds to the
    bf16 output exactly."""
    tq = torch.from_numpy(_rand((2, 37, 192), 3)).to(torch.bfloat16)
    td = torch.from_numpy(_rand((2, 37, 64), 4)).to(torch.bfloat16)
    f32 = attention.packed_attention_bwd(tq, td, 4, 16, out_dtype=torch.float32)
    bf = attention.packed_attention_bwd(tq, td, 4, 16)
    assert f32.dtype == torch.float32 and torch.equal(f32.to(torch.bfloat16), bf)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_attention_trainable_matches_jax_grad(dtype):
    tdt, jdt = DTYPES[dtype]
    nh, hd = 4, 16
    a = _rand((3, 37, 3 * nh * hd), 5)
    cot = _rand((3, 37, nh * hd), 6)
    tq, jq = _pair(a, tdt, jdt)
    tc, jc = _pair(cot, tdt, jdt)

    def jloss(q):
        out = jattn.packed_fused_attention_trainable(q, nh, hd)
        return jnp.sum(out.astype(jnp.float32) * jc.astype(jnp.float32))

    jv, jg = jax.value_and_grad(jloss)(jq)
    tq.requires_grad_(True)
    out = attention.packed_fused_attention_trainable(tq, nh, hd)
    tv = torch.sum(out.float() * tc.float())
    tv.backward()
    rel = F32_REL if dtype == "f32" else BF16_REL
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=rel)
    _close(tq.grad, jg, rel, what="dqkv")


@pytest.mark.parametrize("t,nh,hd", [(577, 1, 64), (257, 2, 104)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_attention_bwd_at_preset_lengths_matches_jax(t, nh, hd, dtype):
    """The sequence lengths whose backward no longer fits one block's
    shared memory as a whole head (ViT-L/16@384, ViT-G/14): the plain
    version the streamed kernels are held to, against JAX's."""
    tdt, jdt = DTYPES[dtype]
    tq, jq = _pair(_rand((1, t, 3 * nh * hd), 7), tdt, jdt)
    td, jd = _pair(_rand((1, t, nh * hd), 8), tdt, jdt)
    want = jattn.packed_attention_bwd(jq, jd, nh, hd)
    got = attention.packed_attention_bwd(tq, td, nh, hd)
    if dtype == "f32":
        _close(got, want, F32_REL, what="dqkv")
    else:
        _close(got, want, BF16_REL, MIN_SAME_ATTN_BWD, "dqkv")


def test_kernel_bwd_smem_bytes_fits_every_head_dim():
    """The streamed backward's shared memory depends on the head dim alone
    (T is not an argument) and fits a block at every head dim the kernels
    take, which covers every preset's, whatever its T."""
    for hd in range(8, 129, 8):
        assert attention.kernel_bwd_smem_bytes(hd) <= attention.MAX_SMEM_BYTES
    for cfg in tconfig.PRESETS.values():
        assert cfg.head_dim % 8 == 0 and cfg.head_dim <= 128, cfg.name


def test_packed_attention_trainable_refuses_long_sequences():
    """Past SINGLE_PASS_MAX_T the trainable attention no longer refuses (the
    name dates from when it did): it runs the blockwise route, as JAX's,
    and returns JAX's shapes, the context [B, T, D] in qkv's dtype forward
    and dqkv [B, T, 3D] backward (the values are held to JAX's in
    tests/test_torch_long_seq.py)."""
    a = _rand((1, 1025, 48), 9)
    tq, jq = _pair(a, torch.float32, jnp.float32)
    want = jattn.packed_fused_attention_trainable(jq, 1, 16)
    tq.requires_grad_(True)
    out = attention.packed_fused_attention_trainable(tq, 1, 16)
    assert out.shape == want.shape == (1, 1025, 16) and out.dtype == tq.dtype
    out.float().square().sum().backward()
    assert tq.grad.shape == tq.shape and torch.isfinite(tq.grad).all()
    _close(out.detach(), want, F32_REL, what="out")


# -- helpers of the fused backward ----------------------------------------


def test_gelu_fast_grad_matches_jax():
    x = np.linspace(-6.0, 6.0, 997, dtype=np.float32)
    want = np.asarray(jfused._gelu_fast_grad(jnp.asarray(x)))
    got = fused_block._gelu_fast_grad(torch.from_numpy(x)).numpy()
    # tanh from two libraries: near saturation (|x| > 4) XLA's rounds to 1
    # where torch's stays an ulp below, and x·(1 − t²)·(P + 2uP') turns that
    # ulp into up to 4.4e-6 (measured); elsewhere they agree to 1.4e-6.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    inner = np.abs(x) < 4  # measured 1.4e-6
    np.testing.assert_allclose(got[inner], want[inner], rtol=0, atol=3e-6)
    # and the derivative of the forward's polynomial GELU, not of erf-GELU
    xt = torch.from_numpy(x).requires_grad_(True)
    fused_block._gelu_fast(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), got, rtol=0, atol=1e-5)


@pytest.mark.parametrize("in_dtype", ["f32", "bf16"])
def test_ln_bwd_matches_jax(in_dtype):
    tdt, jdt = DTYPES[in_dtype]
    tx, jx = _pair(_rand((2 * T, 64), 8, std=2.0), tdt, jdt)
    dy = _rand((2 * T, 64), 9)
    w = _rand((64,), 10, std=0.1) + 1.0
    b = _rand((64,), 11, std=0.1)
    jxhat, jinv, jout = jfused._ln_fwd_stats(jx.astype(jnp.float32), jnp.asarray(w),
                                             jnp.asarray(b), 1e-6)
    jdx, jdw, jdb = jfused._ln_bwd(jnp.asarray(dy), jxhat, jinv, jnp.asarray(w))
    xhat, inv, out = fused_block._ln_fwd_stats(tx.float(), torch.from_numpy(w),
                                               torch.from_numpy(b), 1e-6)
    dx, dw, db = fused_block._ln_bwd(torch.from_numpy(dy), xhat, inv,
                                     torch.from_numpy(w))
    for got, want, what in ((out, jout, "out"), (dx, jdx, "dx"),
                            (fused_block._csum(dw), jfused._csum(jdw), "dw"),
                            (fused_block._csum(db), jfused._csum(jdb), "db")):
        _close(got, want, F32_REL, what=what)
    # The row kernel's plain version: the same dx (plus a residual) and sums.
    res = _rand((2 * T, 64), 12)
    kdx, kdw, kdb = layernorm.layer_norm_bwd(tx, torch.from_numpy(dy),
                                             torch.from_numpy(w), 1e-6,
                                             residual=torch.from_numpy(res),
                                             out_dtype=torch.float32)
    _close(kdx, np.asarray(jdx) + res, F32_REL, what="layer_norm_bwd dx")
    _close(kdw, jfused._csum(jdw)[0], F32_REL, what="layer_norm_bwd dw")
    _close(kdb, jfused._csum(jdb)[0], F32_REL, what="layer_norm_bwd db")


def test_gemm_forms_match_jnp():
    """dgrad (with the GELU gradient and the bf16 second output), wgrad and
    the fc1 recompute's two outputs against the same products in jnp."""
    x = _rand((2 * T, 64), 13)
    dy = _rand((2 * T, 256), 14)
    w = _rand((64, 256), 15, std=0.05)
    bias = _rand((256,), 16, std=0.1)
    pre = _rand((2 * T, 64), 17)
    bf = torch.bfloat16
    tx, jx = _pair(x, bf, jnp.bfloat16)
    tdy, jdy = _pair(dy, bf, jnp.bfloat16)
    tw, jw = _pair(w, bf, jnp.bfloat16)
    f32 = jnp.float32
    want = jnp.dot(jdy, jw.T, preferred_element_type=f32) * jfused._gelu_fast_grad(
        jnp.asarray(pre))
    got, got_bf = linear.linear_dgrad(tdy, tw, gelu_grad_of=torch.from_numpy(pre),
                                      out2_dtype=bf)
    _close(got, want, F32_REL, what="dgrad")
    _close(got_bf, want.astype(jnp.bfloat16), BF16_REL, 0.97, "dgrad bf16")
    _close(linear.linear_wgrad(tx, tdy),
           jnp.dot(jx.T, jdy, preferred_element_type=f32), F32_REL, what="wgrad")
    jpre = jnp.dot(jx, jw, preferred_element_type=f32) + jnp.asarray(bias)
    tpre, thid = linear.fused_linear_with_gelu(tx, tw, torch.from_numpy(bias))
    _close(tpre, jpre, F32_REL, what="hid_pre")
    _close(thid, jfused._gelu_fast(jpre).astype(jnp.bfloat16), BF16_REL, 0.97,
           "hidc")
    assert thid.dtype == bf


@pytest.mark.parametrize("out2", ["f32", "bf16"])
def test_gemm_forms_fp32_match_jnp(out2):
    """The fp32 GEMM's forms (csrc/gemm_f32.cu on the card, here their
    plain versions) on fp32 operands against the same fp32 products in jnp,
    JAX's ``_dot`` in fp32: dgrad with the GELU gradient and its second
    output in fp32 or bf16, wgrad, and the fc1 recompute with its GELU'd
    second output in fp32 or bf16. fp32 outputs within F32_REL of scale
    (summation order); bf16 ones as the bf16 forms'."""
    x = _rand((2 * T, 64), 23)
    dy = _rand((2 * T, 256), 24)
    w = _rand((64, 256), 25, std=0.05)
    bias = _rand((256,), 26, std=0.1)
    pre = _rand((2 * T, 64), 27)
    f32 = jnp.float32
    tdt, jdt = DTYPES[out2]
    jx, jdy, jw = jnp.asarray(x), jnp.asarray(dy), jnp.asarray(w)
    hi = jax.lax.Precision.HIGHEST
    want = jnp.dot(jdy, jw.T, precision=hi) * jfused._gelu_fast_grad(jnp.asarray(pre))
    got, got2 = linear.linear_dgrad(torch.from_numpy(dy), torch.from_numpy(w),
                                    gelu_grad_of=torch.from_numpy(pre),
                                    out2_dtype=tdt)
    _close(got, want, F32_REL, what="dgrad")
    assert got2.dtype == tdt
    if out2 == "f32":
        torch.testing.assert_close(got2, got, rtol=0, atol=0)
    else:
        _close(got2, want.astype(jdt), BF16_REL, 0.97, "dgrad bf16")
    _close(linear.linear_wgrad(torch.from_numpy(x), torch.from_numpy(dy)),
           jnp.dot(jx.T, jdy, precision=hi), F32_REL, what="wgrad")
    jpre = jnp.dot(jx, jw, precision=hi) + jnp.asarray(bias)
    tpre, thid = linear.fused_linear_with_gelu(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        out2_dtype=tdt)
    _close(tpre, jpre, F32_REL, what="hid_pre")
    assert thid.dtype == tdt and tpre.dtype == torch.float32
    if out2 == "f32":
        _close(thid, jfused._gelu_fast(jpre).astype(f32), F32_REL, what="hid")
    else:
        _close(thid, jfused._gelu_fast(jpre).astype(jdt), BF16_REL, 0.97, "hidc")


# -- the weight gradients' split-K (csrc/gemm_sm90.cuh) ----------------------

# (D, H) of ViT-Ti, -S, -B, -L and -H.
WIDTHS = {"ti": (192, 768), "s": (384, 1536), "b": (768, 3072),
          "l": (1024, 4096), "h": (1280, 5120)}


@pytest.mark.parametrize("batch", [1, 16, 64, 256])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_wgrad_splits_cover_every_token_once(width, batch):
    """The split of each of a layer's four weight gradients over B·197
    tokens on 132 SMs: runs aligned to the 64-deep K slice, every token in
    exactly one run and no run empty, S ≥ 1, whole waves of whole tiles,
    and the split units within the bound the function states."""
    d, h = WIDTHS[width]
    m = batch * 197
    for k, n in ((d, 3 * d), (d, d), (d, h), (h, d)):
        tiles = linear._tiles(k, n)
        full, s, split_k = linear._wgrad_splits(m, k, n, 132)
        assert s >= 1 and split_k > 0 and split_k % 64 == 0, (k, n, s, split_k)
        assert (s - 1) * split_k < m <= s * split_k, (k, n, s, split_k)
        if s == 1:
            assert full == tiles
        else:
            assert full % 132 == 0 and 0 <= full < tiles
            assert (tiles - full) * s <= 132
            assert split_k >= linear._MIN_SPLIT_SLICES * 64


@pytest.mark.parametrize("m,k,n,sms", [(3000, 256, 384, 4), (1000, 128, 256, 8)])
def test_wgrad_split_sum_matches_reference_and_jnp(m, k, n, sms):
    """The CPU twin of the card's split-K wgrad (whole tiles, then each split
    tile's fp32 partials summed s = 0..S-1) against the plain product and
    JAX's ``_dot`` form, on shapes where the split runs: a whole wave of 4
    tiles and 2 split ones on 4 SMs, and 2 split tiles on 8."""
    full, s, split_k = linear._wgrad_splits(m, k, n, sms)
    assert s > 1 and full == linear._tiles(k, n) // sms * sms
    bf = torch.bfloat16
    tx, jx = _pair(_rand((m, k), 30), bf, jnp.bfloat16)
    tdy, jdy = _pair(_rand((m, n), 31), bf, jnp.bfloat16)
    got = linear.linear_wgrad_split_reference(tx, tdy, full, s, split_k)
    _close(got, linear.linear_wgrad_reference(tx, tdy), F32_REL, what="split sum")
    _close(got, jnp.dot(jx.T, jdy, preferred_element_type=jnp.float32), F32_REL,
           what="split sum against jnp")


# -- the three stages and the layer backward --------------------------------

# Bit-identical share of the layer backward's bf16 dx against JAX's
# kernels at D = 64 (measured 1.0 at seeds 20-60).
MIN_SAME_DX = 0.95


def _stage_inputs(dtype, seed=20):
    tdt, jdt = DTYPES[dtype]
    tlp, jlp = _layer()
    tx, jx = _pair(_rand((2, T, 64), seed, std=0.5), tdt, jdt)
    tdo, jdo = _pair(_rand((2, T, 64), seed + 1, std=0.1), tdt, jdt)
    return tlp, jlp, tx, jx, tdo, jdo


def _grads_close(got: dict, want: dict, rel):
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == tuple(np.shape(want[key])), key
        _close(got[key], want[key], rel, what=key)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stage_x2_matches_jax(dtype):
    tlp, jlp, tx, jx, _, _ = _stage_inputs(dtype)
    want = jfused.fused_bwd_stage_x2(jx, jlp, JCFG)
    got = fused_block.fused_bwd_stage_x2(tx, tlp, CFG)
    assert got.dtype == torch.float32
    _close(got, want, F32_REL if dtype == "f32" else BF16_GRAD_REL, what="x2")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stage_mlp_mono_matches_jax(dtype):
    tlp, jlp, tx, jx, tdo, jdo = _stage_inputs(dtype)
    jx2 = jfused.fused_bwd_stage_x2(jx, jlp, JCFG)
    tx2 = torch.from_numpy(np.array(jx2))
    jdx2, jg = jfused.fused_bwd_stage_mlp_mono(jx2, jdo, jlp, JCFG)
    dx2, g = fused_block.fused_bwd_stage_mlp_mono(tx2, tdo, tlp, CFG)
    rel = F32_REL if dtype == "f32" else BF16_GRAD_REL
    assert dx2.dtype == torch.float32
    _close(dx2, jdx2, rel, what="dx2")
    _grads_close(g, jg, rel)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stage_attn_matches_jax(dtype):
    tlp, jlp, tx, jx, _, _ = _stage_inputs(dtype)
    dx2 = _rand((2, T, 64), 30, std=0.1)
    jdx, jg = jfused.fused_bwd_stage_attn(jx, jnp.asarray(dx2), jlp, JCFG)
    dx, g = fused_block.fused_bwd_stage_attn(tx, torch.from_numpy(dx2), tlp, CFG)
    assert dx.dtype == tx.dtype
    rel = F32_REL if dtype == "f32" else BF16_GRAD_REL
    _close(dx, jdx, rel, None if dtype == "f32" else MIN_SAME_DX, "dx")
    _grads_close(g, jg, rel)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_encoder_layer_bwd_matches_jax(dtype):
    tlp, jlp, tx, jx, tdo, jdo = _stage_inputs(dtype, seed=40)
    jdx, jg = jfused.fused_encoder_layer_bwd(jx, jlp, jdo, JCFG)
    dx, g = fused_block.fused_encoder_layer_bwd(tx, tlp, tdo, CFG)
    rel = F32_REL if dtype == "f32" else BF16_GRAD_REL
    _close(dx, jdx, rel, None if dtype == "f32" else MIN_SAME_DX, "dx")
    for key in jg:  # leaf dtypes: the fp32 masters
        assert g[key].dtype == torch.float32
    _grads_close(g, jg, rel)
    # The reference chain on the plain links is the same function.
    rdx, rg = fused_block.fused_encoder_layer_bwd_reference(tx, tlp, tdo, CFG)
    assert torch.equal(rdx, dx) and all(torch.equal(rg[k], g[k]) for k in g)


# -- the H-chunked MLP backward (ViT-L/H widths), forced at D = 64 ----------

# The bf16 streams are roundings of fp32 values that both sides sum in
# their own order (measured 100% bit-identical to JAX's at these seeds).
MIN_SAME_STREAM = 0.97


def _light_inputs(dtype, seed=20):
    tlp, jlp, tx, jx, tdo, jdo = _stage_inputs(dtype, seed)
    jx2 = jfused.fused_bwd_stage_x2(jx, jlp, JCFG)
    return tlp, jlp, torch.from_numpy(np.array(jx2)), jx2, tdo, jdo


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stage_mlp_light_matches_jax(dtype):
    tlp, jlp, tx2, jx2, tdo, jdo = _light_inputs(dtype)
    jdx2, jhid, jdhp, jg = jfused.fused_bwd_stage_mlp_light(jx2, jdo, jlp, JCFG)
    dx2, hid, dhp, g = fused_block.fused_bwd_stage_mlp_light(tx2, tdo, tlp, CFG)
    rel = F32_REL if dtype == "f32" else BF16_GRAD_REL
    assert dx2.dtype == torch.float32 and hid.dtype == dhp.dtype == tdo.dtype
    _close(dx2, jdx2, rel, what="dx2")
    for got, want, what in ((hid, jhid, "hid_s"), (dhp, jdhp, "dhp_s")):
        if dtype == "f32":
            _close(got, want, F32_REL, what=what)
        else:
            _close(got, want, BF16_REL, MIN_SAME_STREAM, what)
    _grads_close(g, jg, rel)


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stage_mlp_wgrad_matches_jax(dtype, chunks):
    """From the same streams (JAX's light stage's), both sides' weight
    gradients; the port's are one GEMM over H whatever ``chunks`` is."""
    tdt = DTYPES[dtype][0]
    tlp, jlp, tx2, jx2, tdo, jdo = _light_inputs(dtype)
    _, jhid, jdhp, _ = jfused.fused_bwd_stage_mlp_light(jx2, jdo, jlp, JCFG)
    thid, tdhp = (torch.from_numpy(np.array(_np(a))).to(tdt)
                  for a in (jhid, jdhp))
    want = jfused.fused_bwd_stage_mlp_wgrad(jx2, jdo, jhid, jdhp, jlp, JCFG,
                                            mlp_chunks=chunks)
    got = fused_block.fused_bwd_stage_mlp_wgrad(tx2, tdo, thid, tdhp, tlp, CFG,
                                                mlp_chunks=chunks)
    rel = F32_REL if dtype == "f32" else BF16_GRAD_REL
    for g, w, what in zip(got, want, ("dfc1_w", "dfc2_w")):
        assert g.dtype == torch.float32
        _close(g, w, rel, what=what)
    other = fused_block.fused_bwd_stage_mlp_wgrad(tx2, tdo, thid, tdhp, tlp,
                                                  CFG, mlp_chunks=1)
    assert all(torch.equal(a, b) for a, b in zip(got, other))


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_layer_bwd_equals_mono(dtype, chunks):
    """The layer backward through light → wgrad equals, bit for bit, the
    mono stage's: the same links on the same values."""
    tlp, _, tx, _, tdo, _ = _stage_inputs(dtype, seed=60)
    dx, g = fused_block.fused_encoder_layer_bwd(tx, tlp, tdo, CFG,
                                                mlp_chunks=chunks)
    x2 = fused_block.fused_bwd_stage_x2(tx, tlp, CFG)
    dx2, mono = fused_block.fused_bwd_stage_mlp_mono(x2, tdo, tlp, CFG)
    mdx, attn_g = fused_block.fused_bwd_stage_attn(tx, dx2, tlp, CFG)
    mono.update(attn_g)
    assert torch.equal(dx, mdx)
    assert set(g) == set(mono)
    assert all(torch.equal(g[k], mono[k][0]) for k in g)


def test_chunked_mlp_refuses_chunks_that_do_not_divide_h():
    tlp, jlp, tx, jx, tdo, jdo = _stage_inputs("f32")
    with pytest.raises(ValueError, match="must divide") as want:
        jfused.fused_encoder_layer_bwd(jx, jlp, jdo, JCFG, mlp_chunks=7)
    with pytest.raises(ValueError, match="must divide") as got:
        fused_block.fused_encoder_layer_bwd(tx, tlp, tdo, CFG, mlp_chunks=7)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_encoder_layer_bwd_chunked_matches_jax(dtype):
    """``mlp_chunks=2`` forced at D = 64, on weights carried across by
    ``params_from_jax``."""
    tdt, jdt = DTYPES[dtype]
    named = jfixtures.random_params(JCFG, seed=9, scale=0.05)
    stacked = jvit.stack_params(named, JCFG, param_dtype=jnp.float32)
    jlp = {k: jnp.asarray(v[0]) for k, v in stacked["layers"].items()}
    tlp = {k: v[0] for k, v in tvit.params_from_jax(
        stacked, device="cpu")["layers"].items()}
    tx, jx = _pair(_rand((2, T, 64), 41, std=0.5), tdt, jdt)
    tdo, jdo = _pair(_rand((2, T, 64), 42, std=0.1), tdt, jdt)
    jdx, jg = jfused.fused_encoder_layer_bwd(jx, jlp, jdo, JCFG, mlp_chunks=2)
    dx, g = fused_block.fused_encoder_layer_bwd(tx, tlp, tdo, CFG, mlp_chunks=2)
    if dtype == "f32":
        _close(dx, jdx, F32_REL, what="dx")
    else:  # a bf16 output: a summation-order flip moves an element by an ulp
        _close(dx, jdx, BF16_REL, MIN_SAME_DX, "dx")
    _grads_close(g, jg, F32_REL if dtype == "f32" else BF16_GRAD_REL)


def test_trainable_gates_match_jax():
    for name in ("vit_b_16_224", "vit_tiny_16_224", "vit_l_16_384",
                 "vit_h_14_224"):
        assert (fused_block.supports_trainable(tconfig.get_config(name))
                == jfused.supports_trainable(jconfig.get_config(name))), name
    for d, h in ((768, 3072), (1024, 4096), (1280, 5120)):
        assert (fused_block._pick_mlp_chunks(d, h, 2)
                == jfused._pick_mlp_chunks(d, h, 2))


def test_train_kernels_send_large_presets_to_the_fused_layer():
    """The fused route trains ViT-L/16@384 and ViT-H/14 through the
    trainable layer (their MLP backward the chunked pair), as ViT-B."""
    from vit_with_opencl_tpu_torch.parallel import spmd

    for name in ("vit_b_16_224", "vit_l_16_384", "vit_h_14_224"):
        kernels = spmd.train_kernels(tconfig.get_config(name), "fused",
                                     torch.bfloat16)
        assert (kernels["encoder_block"]
                is fused_block.fused_encoder_layer_trainable), name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_layer_trainable_matches_jax_value_and_grad(dtype):
    """Autograd through the trainable layer against
    ``jax.value_and_grad(fused_encoder_layer_trainable)``, B = 3."""
    tdt, jdt = DTYPES[dtype]
    tlp, jlp = _layer(seed=8)
    x = _rand((3, T, 64), 50)
    tx, jx = _pair(x, tdt, jdt)

    def jloss(x, lp):
        out = jfused.fused_encoder_layer_trainable(x, lp, JCFG)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jv, (jgx, jglp) = jax.value_and_grad(jloss, argnums=(0, 1))(jx, jlp)
    tx.requires_grad_(True)
    for v in tlp.values():
        v.requires_grad_(True)
    out = fused_block.fused_encoder_layer_trainable(tx, tlp, CFG)
    tv = torch.sum(out.float() ** 2)
    tv.backward()
    rel = F32_REL if dtype == "f32" else BF16_GRAD_REL
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=rel)
    _close(tx.grad, jgx, rel, what="dx")
    _grads_close({k: v.grad for k, v in tlp.items()}, jglp, rel)


# The narrowest width whose own H-chunk count is 2, as ViT-L's and ViT-H's:
# D = 1024, H = 4096, 16 heads of 64, T = 17, one layer.
LCFG = ViTConfig(name="train_ops_l", img_size=32, patch_size=8,
                 embed_dim=1024, depth=1, num_heads=16, num_classes=9,
                 mlp_ratio=4.0)
JLCFG = jconfig.ViTConfig(name="train_ops_l", img_size=32, patch_size=8,
                          embed_dim=1024, depth=1, num_heads=16,
                          num_classes=9, mlp_ratio=4.0)


def test_fused_layer_trainable_chunked_matches_jax_value_and_grad():
    """Autograd through the trainable layer at a width that picks the
    light/wgrad pair itself, against JAX's, B = 2, in fp32. (In bf16 at this
    width the two packages' fp32 sums of 1024 and 4096 terms, taken in
    other orders, flip bf16 roundings that compound through the layer: dx
    77% bit-identical, gradients up to 3.5e-3 of scale, the same for the
    mono and the chunked route, which are bit-identical on the CPU; the
    chunked bf16 route is held to JAX's at D = 64 above.)"""
    assert fused_block._pick_mlp_chunks(1024, 4096, 4) == 2
    assert jfused._pick_mlp_chunks(1024, 4096, 4) == 2
    named = jfixtures.random_params(JLCFG, seed=11, scale=0.02)
    stacked = jvit.stack_params(named, JLCFG, param_dtype=jnp.float32)
    jlp = {k: jnp.asarray(v[0]) for k, v in stacked["layers"].items()}
    tlp = {k: torch.from_numpy(np.array(v)) for k, v in jlp.items()}
    tx, jx = _pair(_rand((2, T, 1024), 51, std=0.5), torch.float32,
                   jnp.float32)

    def jloss(x, lp):
        out = jfused.fused_encoder_layer_trainable(x, lp, JLCFG)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jv, (jgx, jglp) = jax.value_and_grad(jloss, argnums=(0, 1))(jx, jlp)
    tx.requires_grad_(True)
    for v in tlp.values():
        v.requires_grad_(True)
    out = fused_block.fused_encoder_layer_trainable(tx, tlp, LCFG)
    tv = torch.sum(out.float() ** 2)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=F32_REL)
    _close(tx.grad, jgx, F32_REL, what="dx")
    _grads_close({k: v.grad for k, v in tlp.items()}, jglp, F32_REL)


# -- the inference wrappers under autograd ----------------------------------


def test_refuse_autograd_predicate():
    """The check every kernel wrapper runs on the card: grad mode on and a
    tensor that requires grad raise, naming the trainable counterpart;
    no_grad and inference_mode pass, and so do tensors without grad."""
    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    with pytest.raises(RuntimeError, match="fused_encoder_layer_trainable"):
        _build.refuse_autograd("layer_norm", (x, w, None),
                               "fused_encoder_layer_trainable")
    with pytest.raises(RuntimeError, match="trainable"):  # inside a weight dict
        _build.refuse_autograd("fused_encoder_layer", (x, {"q": {"w": w}}),
                               "fused_encoder_layer_trainable")
    _build.refuse_autograd("layer_norm", (x, None), "-")
    with torch.no_grad():
        _build.refuse_autograd("layer_norm", (x, w), "-")
    with torch.inference_mode():
        _build.refuse_autograd("layer_norm", (x, w), "-")


def test_wrappers_on_cpu_stay_differentiable():
    """On CPU tensors the wrappers compute their plain versions, which carry
    the graph: the refusal is for the card's kernels only."""
    x = torch.randn(2, T, 64, requires_grad=True)
    tlp, _ = _layer()
    out = fused_block.fused_encoder_layer(x, tlp, CFG)
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()

"""The port's blockwise (long-sequence) attention against the JAX package's,
on the CPU: the plain versions of the forward (with and without the
log-sum-exp) and of the backward against ``_blockwise_fwd_flat`` and
``blockwise_attention_bwd`` (Pallas in interpret mode), the packed and the
trainable attention past ``SINGLE_PASS_MAX_T``, and the slice as a whole on
a narrow config with 1025 tokens (256-pixel images at patch 8, D = 128, 2
heads, depth 1): the ``flash`` forward and one fp32 AdamW step in the
``flash`` and ``fused`` routes.

Inputs are made with numpy from seeds and given to both sides. On CPU
tensors every wrapper computes its plain version; no kernel launches, which
the tests check through the counters.
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
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.ops import attention as jattn
from vit_with_opencl_tpu.parallel import spmd as jspmd
from vit_with_opencl_tpu_torch import ViTConfig, optim
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.models import vit
from vit_with_opencl_tpu_torch.ops import attention
from vit_with_opencl_tpu_torch.parallel import spmd

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
NH, HD = 2, 64
# fp32: the same arithmetic, summed in another order (measured below 1e-7
# on unit-scale inputs).
F32_ATOL = 1e-5
# bf16 outputs round at the same points as JAX's: a summation-order flip of
# one rounding moves that element by a bf16 ulp (2^-8 of its magnitude at
# most). Measured 99.87% bit-identical at T = 1025.
BF16_REL = 2.0 ** -8
MIN_SAME = 0.99
# The LSE is fp32 on both sides: m + log(l) summed in another order.
LSE_REL = 1e-5
# Gradients: fp32 sums of the same products in another order. In bf16, a
# ds rounded the other way moves its whole term: 2e-2 of scale, as the
# packed backward's (tests/test_torch_train_ops.py).
GRAD_REL = {"f32": 1e-5, "bf16": 2e-2}
MIN_SAME_GRAD = 0.9

# Probabilities of the narrow config's forward. fp32: the same function
# summed in another order. bf16: JAX's fused kernels take the whole-row
# one-shot softmax at T = 1025 and the port's chain the blockwise one, the
# same function with p rounded to bf16 at other values. On this model's
# qkv the two contexts are 86.5% bit-identical and one bf16 ulp apart
# elsewhere, and equally far from the fp32 context (mean 9.6e-5 each);
# this one-layer model's near-uniform attention and its head carry the
# flipped ulps to 1.1e-3 in the probabilities (JAX's own bf16 is 7.7e-4
# from its fp32 here). With the one-shot link the port is 1.8e-4 from JAX.
PROB_ATOL = {"f32": 1e-5, "bf16": 2e-3}

CFG = ViTConfig(name="long_seq", img_size=256, patch_size=8, embed_dim=128,
                depth=1, num_heads=2, num_classes=9)
JCFG = jconfig.ViTConfig(name="long_seq", img_size=256, patch_size=8,
                         embed_dim=128, depth=1, num_heads=2, num_classes=9)


def _rand(shape, seed, std=1.0):
    return np.random.default_rng(seed).normal(0, std, shape).astype(np.float32)


def _np(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _close(got, want, rel, min_same=None, what=""):
    """|got − want| ≤ rel·max|want|; optionally a bit-identical share."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.abs(g - w).max())
    scale = max(float(np.abs(w).max()), 1e-30)
    same = float((g == w).mean())
    print(f"{what}: max abs err {err:.3e} (|want| up to {scale:.3e}), "
          f"{same:.2%} bit-identical")
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"
    if min_same is not None:
        assert same >= min_same, f"{what}: {same:.4f} < {min_same}"


def _jax_flat_fwd(jq, t):
    """JAX's blockwise forward as its trainable route calls it: split,
    padded to 128, ``_blockwise_fwd_flat`` with the LSE; → (out [B, T, D],
    lse [B, H, T], and the flat padded operands for the backward)."""
    b = jq.shape[0]
    t_pad = -(-t // 128) * 128
    pad = ((0, 0), (0, t_pad - t), (0, 0))
    qf, kf, vf = (jnp.pad(x, pad) for x in jattn._packed_split(jq, NH, HD))
    of, lse = jattn._blockwise_fwd_flat(
        qf, kf, vf, scale=float(1.0 / np.sqrt(HD)), seq_len=t, block_q=128,
        block_k=128, interpret=True, return_lse=True)
    out = jattn._packed_merge(of[:, :t], b, NH, HD)
    return out, lse.reshape(b, NH, t_pad)[:, :, :t], (qf, kf, vf, of, lse)


@pytest.mark.parametrize("t,b", [(1025, 2), (1337, 1)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blockwise_forward_matches_jax(t, b, dtype):
    """``_flash_kernel_lse``'s output and LSE, and ``_flash_kernel``'s
    output (the inference route's call, without the LSE)."""
    tdt, jdt = DTYPES[dtype]
    a = _rand((b, t, 3 * NH * HD), 1)
    jout, jlse, _ = _jax_flat_fwd(jnp.asarray(a, jdt), t)
    tq = torch.from_numpy(a).to(tdt)
    out, lse = attention.blockwise_attention_fwd(tq, NH, HD, return_lse=True)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, NH, t)
    if dtype == "f32":
        np.testing.assert_allclose(_np(out), _np(jout), rtol=0, atol=F32_ATOL)
    else:
        _close(out, jout, BF16_REL, MIN_SAME, f"T={t} out")
    _close(lse, jlse, LSE_REL, what=f"T={t} lse")
    plain, none = attention.blockwise_attention_fwd(tq, NH, HD)
    assert none is None
    assert torch.equal(plain, out)


@pytest.mark.parametrize("t", [1025, 1337])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_attention_takes_the_blockwise_route_as_jax(t, dtype):
    """``packed_fused_attention`` past SINGLE_PASS_MAX_T against JAX's,
    which reroutes there to ``_flash_kernel``; the plain version routes the
    same way, and nothing launches on the CPU."""
    tdt, jdt = DTYPES[dtype]
    a = _rand((1, t, 3 * NH * HD), 2)
    want = jattn.packed_fused_attention(jnp.asarray(a, jdt), num_heads=NH,
                                        head_dim=HD, interpret=True)
    tq = torch.from_numpy(a).to(tdt)
    before = (attention.LAUNCHES, attention.LAUNCHES_FLASH)
    got = attention.packed_fused_attention(tq, num_heads=NH, head_dim=HD)
    assert (attention.LAUNCHES, attention.LAUNCHES_FLASH) == before
    assert torch.equal(got, attention.packed_fused_attention_reference(tq, NH, HD))
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    else:
        _close(got, want, BF16_REL, MIN_SAME, f"T={t} packed")


def test_is_long_seq_matches_jax():
    for t in (1, 197, 577, 848, 1023, 1024, 1025, 1152, 1153, 1337, 1370):
        assert attention._is_long_seq(t) == jattn._is_long_seq(t), t
    assert not attention._is_long_seq(1024) and attention._is_long_seq(1025)


@pytest.mark.parametrize("t,b", [(1025, 2), (1337, 1)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blockwise_backward_matches_jax(t, b, dtype):
    """The backward's plain version against ``blockwise_attention_bwd`` on
    the same q, k, v, the forward's own o and lse, and dO."""
    tdt, jdt = DTYPES[dtype]
    a = _rand((b, t, 3 * NH * HD), 3)
    do = _rand((b, t, NH * HD), 4)
    jq, jdo = jnp.asarray(a, jdt), jnp.asarray(do, jdt)
    jout, jlse, (qf, kf, vf, of, lse_flat) = _jax_flat_fwd(jq, t)
    t_pad = of.shape[1]
    dof = jnp.pad(jdo.reshape(b, t, NH, HD).transpose(0, 2, 1, 3)
                  .reshape(b * NH, t, HD), ((0, 0), (0, t_pad - t), (0, 0)))
    dq, dk, dv = jattn.blockwise_attention_bwd(
        qf, kf, vf, of, lse_flat, dof, scale=float(1.0 / np.sqrt(HD)),
        seq_len=t, interpret=True)
    want = jnp.concatenate([jattn._packed_merge(x[:, :t], b, NH, HD)
                            for x in (dq, dk, dv)], axis=-1)
    tq, tdo = torch.from_numpy(a).to(tdt), torch.from_numpy(do).to(tdt)
    # The same residuals as JAX's: its rounded output and its fp32 LSE.
    tout = torch.from_numpy(_np(jout).copy()).to(tdt)
    tlse = torch.from_numpy(_np(jlse).copy())
    before = attention.LAUNCHES_FLASH_BWD
    got = attention.blockwise_attention_bwd(tq, tout, tlse, tdo, NH, HD)
    assert attention.LAUNCHES_FLASH_BWD == before and got.dtype == tdt
    if dtype == "f32":
        _close(got, want, GRAD_REL["f32"], what=f"T={t} dqkv")
    else:
        _close(got, want, GRAD_REL["bf16"], MIN_SAME_GRAD, f"T={t} dqkv")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_trainable_long_route_grad_matches_jax(dtype):
    """``packed_fused_attention_trainable`` at T = 1025 under autograd
    against ``jax.grad`` through JAX's (its blockwise custom VJP): the loss
    and dqkv."""
    tdt, jdt = DTYPES[dtype]
    t = 1025
    a = _rand((1, t, 3 * NH * HD), 5)
    cot = _rand((1, t, NH * HD), 6)
    jq, jc = jnp.asarray(a, jdt), jnp.asarray(cot, jdt)

    def jloss(q):
        out = jattn.packed_fused_attention_trainable(q, NH, HD)
        return jnp.sum(out.astype(jnp.float32) * jc.astype(jnp.float32))

    jv, jg = jax.value_and_grad(jloss)(jq)
    tq = torch.from_numpy(a).to(tdt).requires_grad_(True)
    before = (attention.LAUNCHES_FLASH_LSE, attention.LAUNCHES_FLASH_BWD)
    out = attention.packed_fused_attention_trainable(tq, NH, HD)
    assert out.shape == (1, t, NH * HD) and out.dtype == tdt
    tv = torch.sum(out.float() * torch.from_numpy(cot).to(tdt).float())
    tv.backward()
    assert (attention.LAUNCHES_FLASH_LSE, attention.LAUNCHES_FLASH_BWD) == before
    rel = GRAD_REL[dtype]
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=rel)
    _close(tq.grad, jg, rel, None if dtype == "f32" else MIN_SAME_GRAD, "dqkv")


# -- the slice as a whole: a narrow config with T = 1025 ---------------------


@pytest.fixture(scope="module")
def host_params():
    assert CFG.num_tokens == 1025 and attention._is_long_seq(CFG.num_tokens)
    return fixtures.random_params(CFG, seed=7, scale=0.05)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_long_seq_flash_forward_matches_jax(host_params, dtype):
    """The ``flash`` forward's probabilities against JAX's ``forward``: JAX
    runs this config's encoder in its whole-sequence fused kernels, the port
    its chain, whose attention link takes the blockwise route at T = 1025."""
    tdt, jdt = DTYPES[dtype]
    images = fixtures.random_images(CFG, n=2, seed=3)
    stacked = jvit.stack_params(host_params, JCFG, param_dtype=jdt)
    want = np.asarray(jvit.forward(jnp.asarray(images), stacked, JCFG,
                                   compute_dtype=jdt,
                                   kernels=jvit.resolve_kernels("flash")))
    got = vit.forward(torch.from_numpy(images),
                      vit.params_from_jax(stacked, device="cpu"), CFG,
                      compute_dtype=tdt,
                      kernels=vit.resolve_kernels("flash")).numpy()
    assert got.shape == (2, CFG.num_classes) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=PROB_ATOL[dtype])
    assert (got.argmax(-1) == want.argmax(-1)).all()


def _leaves(tree):
    return [np.asarray(a, np.float32) if not isinstance(a, torch.Tensor)
            else a.detach().float().numpy() for a in optim.tree_leaves(
                {k: (dict(v) if isinstance(v, dict) else v) for k, v in tree.items()})]


@pytest.mark.parametrize("route", ["flash", "fused"])
def test_long_seq_train_step_matches_jax(route):
    """One fp32 AdamW step at T = 1025 against JAX's ``make_train_step`` on
    the same params (carried across by ``params_from_jax``): the loss, and
    the gradients through AdamW's first moment (0.1·g after one step)."""
    jp = jvit.random_stacked_params(JCFG, jax.random.key(5), jnp.float32)
    host = jax.tree.map(np.asarray, jp)
    images = fixtures.random_images(CFG, n=1, seed=6)
    labels = np.array([4])
    mesh = jspmd.make_mesh(data=1, model=1)
    jinit, jstep = jspmd.make_train_step(JCFG, mesh, lr=1e-3,
                                         compute_dtype=jnp.float32,
                                         optimizer="adamw", attention_impl=route)
    _, js, jloss = jstep(host, jinit(host), jnp.asarray(images), jnp.asarray(labels))
    tinit, tstep = spmd.make_train_step(CFG, device="cpu", lr=1e-3,
                                        compute_dtype=torch.float32,
                                        optimizer="adamw", attention_impl=route)
    params = vit.params_from_jax(host, device="cpu")
    _, ts, tloss = tstep(params, tinit(params), torch.from_numpy(images),
                         torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for got, want in zip(_leaves(ts["mu"]),
                         [np.asarray(x, np.float32) for x in jax.tree.leaves(js[0].mu)],
                         strict=True):
        assert got.shape == want.shape
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale

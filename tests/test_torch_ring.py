"""The port's ring attention against the JAX package's, on the CPU.

The plain version of the ring step kernel (``blockwise_ring_step``, which
replaces ``_flash_carry_kernel``) against JAX's in interpret mode: bf16 and
fp32, a 64-key block and a ragged whole-shard block, the first rotation and
one carried from a previous step, a bias with a masked tail. Then
``ring_attention`` (einsum and blockwise local steps) on a 4-shard virtual
mesh of CPU devices against JAX's on 4 of its 8 virtual CPU devices and the
exact softmax, and the cross-device rescaling identity of two chained steps
(mirrors of ``tests/test_kernels.py``'s ring tests).

Inputs are made with numpy from seeds and given to both sides. On CPU
tensors the wrappers compute their plain versions; no kernel launches,
which each test checks through the counter.
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

from jax.sharding import Mesh as JMesh

from vit_with_opencl_tpu import ViTConfig as JViTConfig
from vit_with_opencl_tpu.ops import attention as jattn
from vit_with_opencl_tpu.ops import ring_attention as jring
from vit_with_opencl_tpu_torch import ViTConfig
from vit_with_opencl_tpu_torch.ops import attention, ring_attention
from vit_with_opencl_tpu_torch.parallel.mesh import Mesh

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# The step's fp32 outputs: the same arithmetic summed in another order
# (measured within 5e-7 of each output's largest magnitude).
F32_REL = 1e-5
# bf16 q, k, v: m and l stay fp32 sums of the same products; acc sums
# bf16(p)·v, and a score one fp32 ulp off JAX's may round its p the other
# way, which moves that term by a bf16 ulp (measured: 1.1e-3 on an acc of
# magnitude 14, 7.8e-5 of scale), within test_torch_ops.py's BF16_TOL.
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
# ...and m, a max of the same scores, mostly bit-identical (measured
# 0.88-0.95 on these inputs).
MIN_SAME_M = 0.8
# Ring attention against the exact softmax, as JAX's own tests hold it.
RING_ATOL = 2e-5


@pytest.fixture
def no_launches():
    before = attention.LAUNCHES_RING
    yield
    assert attention.LAUNCHES_RING == before


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _ref_attention(q, k, v, hd):
    """Plain-numpy attention (per-head softmax(QK^T/sqrt(hd))V)."""
    s = (q @ np.swapaxes(k, -1, -2)) / np.sqrt(hd)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    return (p / p.sum(axis=-1, keepdims=True)) @ v


def _step_inputs(seed, n, t_loc, hd, masked):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((n, t_loc, hd)).astype(np.float32) for _ in range(3))
    bias = np.zeros((1, t_loc), np.float32)
    if masked:
        bias[0, t_loc - masked:] = jattn.MASK_VALUE
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t_loc,block", [(128, 64), (105, 105)])
@pytest.mark.parametrize("carried", [False, True])
def test_ring_step_matches_jax(no_launches, dtype, t_loc, block, carried):
    """The plain version of the ring step against JAX's kernel (interpret
    mode): the first rotation from (-inf, 0, 0), or a second step carrying
    JAX's (m, l, acc) from a first one; a bias masking the last 7 keys."""
    tdt, jdt = DTYPES[dtype]
    n, hd, scale = 3, 32, 0.17
    q, k, v, bias = _step_inputs(0, n, t_loc, hd, masked=7)
    m = np.full((n, t_loc), -np.inf, np.float32)
    l = np.zeros((n, t_loc), np.float32)
    acc = np.zeros((n, t_loc, hd), np.float32)
    kw = dict(scale=scale, block_q=block, block_k=block)
    if carried:
        _, k0, v0, _ = _step_inputs(1, n, t_loc, hd, masked=0)
        m, l, acc = (np.array(a) for a in jattn.blockwise_ring_step(
            jnp.asarray(q, jdt), jnp.asarray(k0, jdt), jnp.asarray(v0, jdt),
            jnp.zeros((1, t_loc)), jnp.asarray(m), jnp.asarray(l),
            jnp.asarray(acc), **kw))
    want = jattn.blockwise_ring_step(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias),
        jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc), **kw)
    got = attention.blockwise_ring_step(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        *(torch.from_numpy(a) for a in (bias, m, l, acc)), **kw)
    for name, g, w in zip(("m", "l", "acc"), got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == np.float32 and g.shape == w.shape
        if dtype == "bf16" and name == "acc":
            np.testing.assert_allclose(g, w, **BF16_TOL)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_REL * np.abs(w).max(),
                                       err_msg=name)
    if dtype == "bf16":
        assert (_np(got[0]) == _np(want[0])).mean() >= MIN_SAME_M


def test_ring_step_refuses_blocks_that_do_not_divide(no_launches):
    q, k, v, bias = _step_inputs(0, 1, 100, 16, masked=0)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    args += [torch.full((1, 100), -float("inf")), torch.zeros(1, 100),
             torch.zeros(1, 100, 16)]
    with pytest.raises(ValueError, match="must divide"):
        attention.blockwise_ring_step(*args, scale=0.25, block_q=100, block_k=64)


def test_blockwise_ring_step_carries_stats(no_launches):
    """Two chained steps over a split KV == one-shot softmax over the
    concatenated KV (the cross-device rescaling identity; JAX's
    tests/test_kernels.py:934)."""
    r = np.random.default_rng(0)
    t_loc, hd, scale = 128, 32, 0.17
    q = torch.from_numpy(r.standard_normal((1, t_loc, hd)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((1, 2 * t_loc, hd)).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((1, 2 * t_loc, hd)).astype(np.float32))
    m = torch.full((1, t_loc), -float("inf"))
    l = torch.zeros((1, t_loc))
    acc = torch.zeros((1, t_loc, hd))
    bias = torch.zeros((1, t_loc))
    for half in (slice(0, t_loc), slice(t_loc, 2 * t_loc)):
        m, l, acc = attention.blockwise_ring_step(
            q, k[:, half].contiguous(), v[:, half].contiguous(), bias, m, l, acc,
            scale=scale, block_q=64, block_k=64)
    s = (q.numpy() @ np.swapaxes(k.numpy(), -1, -2)) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose((acc / l[..., None]).numpy(), p @ v.numpy(),
                               atol=RING_ATOL)


def _meshes(n=4):
    jmesh = JMesh(np.array(jax.devices()[:n]), axis_names=("model",))
    return jmesh, Mesh(["cpu"] * n, axis_names=("model",))


@pytest.mark.parametrize("t", [197, 64])
def test_ring_attention_matches_reference(no_launches, t):
    """The einsum ring over 4 shards == JAX's == plain attention, at a T
    that divides the ring (64) and one that needs masked padding (197;
    JAX's tests/test_kernels.py:322)."""
    r = np.random.default_rng(0)
    q, k, v = (r.standard_normal((2, 3, t, 32)).astype(np.float32) for _ in range(3))
    kw = dict(name="r", img_size=32, patch_size=8, embed_dim=96, depth=1, num_heads=3)
    jmesh, mesh = _meshes()
    want = np.asarray(jring.ring_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                           JViTConfig(**kw), jmesh))
    got = ring_attention.ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                        ViTConfig(**kw), mesh)
    assert tuple(got.shape) == (2, 3, t, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=RING_ATOL)
    np.testing.assert_allclose(got.numpy(), _ref_attention(q, k, v, 32),
                               atol=RING_ATOL)


@pytest.mark.parametrize("t", [512, 420])
def test_ring_attention_blockwise_matches_einsum(no_launches, t):
    """The ring with the carried blockwise step == the einsum ring == JAX's
    == plain attention: t = 512 takes 128-token shards, one 128-key block
    each; t = 420 ragged 105-token blocks (JAX's
    tests/test_kernels.py:908)."""
    r = np.random.default_rng(0)
    q, k, v = (r.standard_normal((1, 2, t, 64)).astype(np.float32) for _ in range(3))
    kw = dict(name="rb", img_size=32, patch_size=8, embed_dim=256, depth=1,
              num_heads=4)
    jmesh, mesh = _meshes()
    ref = _ref_attention(q, k, v, 64)
    for impl in ("einsum", "blockwise"):
        want = np.asarray(jring.ring_attention(
            *(jnp.asarray(a) for a in (q, k, v)), JViTConfig(**kw), jmesh, impl=impl))
        got = ring_attention.ring_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), ViTConfig(**kw), mesh,
            impl=impl).numpy()
        np.testing.assert_allclose(got, want, atol=RING_ATOL, err_msg=impl)
        np.testing.assert_allclose(got, ref, atol=RING_ATOL, err_msg=impl)


def test_ring_attention_bf16_matches_jax(no_launches):
    """bf16 through the blockwise ring (t = 420: ragged 105-token blocks,
    a masked tail on the last shard's keys): the same rounding points as
    JAX's, so mostly bit-identical and within BF16_TOL."""
    r = np.random.default_rng(1)
    t = 418
    q, k, v = (r.standard_normal((1, 2, t, 64)).astype(np.float32) for _ in range(3))
    kw = dict(name="rb", img_size=32, patch_size=8, embed_dim=256, depth=1,
              num_heads=4)
    jmesh, mesh = _meshes()
    want = _np(jring.ring_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                    JViTConfig(**kw), jmesh, impl="blockwise"))
    got = _np(ring_attention.ring_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        ViTConfig(**kw), mesh, impl="blockwise"))
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert (got == want).mean() >= 0.9


def test_ring_attention_rejects_unknown_impl(no_launches):
    mesh = Mesh(["cpu"] * 2, axis_names=("model",))
    q = torch.zeros((1, 1, 8, 8))
    with pytest.raises(ValueError, match="unknown ring attention impl"):
        ring_attention.ring_attention(q, q, q, ViTConfig(
            name="x", img_size=8, patch_size=8, embed_dim=8, depth=1,
            num_heads=1), mesh, impl="warp")

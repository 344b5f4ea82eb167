"""The kernel layer's public ops against the JAX package's, on the CPU:
``flash_attention`` (the single-pass route, T ≤ 1024, and the blockwise
route past it) against JAX's ``flash_attention`` in interpret mode,
``residual_layer_norm`` against JAX's in interpret mode, ``softmax``, the
generic attention slot of ``resolve_kernels``, and the packed attention's
849-1024 window, which on the card now takes the single-pass kernel.

Inputs are made with numpy from seeds and given to both sides. On CPU
tensors every wrapper computes its plain version; no kernel launches, which
the tests check through the counters.
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
from vit_with_opencl_tpu import ops as jops
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu_torch import ViTConfig, ops
from vit_with_opencl_tpu_torch.models import vit
from vit_with_opencl_tpu_torch.ops import attention, layernorm

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
NH, HD = 2, 64
# JAX's own tolerance for flash_attention in fp32 (tests/test_kernels.py):
# the same arithmetic, summed in another order.
F32_ATOL = 2e-5
# bf16 outputs round at the same points as JAX's (q scaled in bf16, e cast
# to bf16 for the PV product, the output cast once): an fp32 sum taken in
# another order may flip a rounding of e or of the output. Held to 2 bf16
# ulps at the output's scale (its largest magnitude): a flipped e moves its
# row's output by a share of one term, which on an element near 0 can be
# many of that element's own ulps (13 at T = 197, measured; 0.5 at the scale).
BF16_ULPS = 2
MIN_SAME = 0.99
# residual_layer_norm, fp32: JAX's tolerances (tests/test_kernels.py).
SUM_ATOL, LN_ATOL = 1e-6, 1e-5

CFG = ViTConfig(name="ops", img_size=32, patch_size=8, embed_dim=NH * HD,
                depth=1, num_heads=NH, num_classes=5)
JCFG = jconfig.ViTConfig(name="ops", img_size=32, patch_size=8,
                         embed_dim=NH * HD, depth=1, num_heads=NH, num_classes=5)


def _rand(shape, seed, std=1.0):
    return np.random.default_rng(seed).normal(0, std, shape).astype(np.float32)


def _np(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _bf16_close(got, want, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    ulps = np.abs(g - w) / _bf16_ulp(np.abs(w).max())
    same = float((g == w).mean())
    print(f"{what}: at most {ulps.max():.2f} bf16 ulps, {same:.2%} bit-identical")
    assert ulps.max() <= BF16_ULPS, what
    assert same >= MIN_SAME, what


def _counts():
    return (attention.LAUNCHES, attention.LAUNCHES_SINGLE,
            attention.LAUNCHES_FLASH, attention.LAUNCHES_FLASH_SPLIT,
            layernorm.LAUNCHES_RESIDUAL)


def _qkv(shape, seed, dtype):
    tdt, jdt = DTYPES[dtype]
    arrays = [_rand(shape, seed + i) for i in range(3)]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


@pytest.mark.parametrize("t", [64, 128, 197, 384, 1000, 1025])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_jax(t, dtype):
    """Both of JAX's routes: the single-pass kernel up to T = 1024 (1000
    pads to 1024 there, masked), the blockwise kernel at 1025."""
    (q, k, v), (jq, jk, jv) = _qkv((1, NH, t, HD), t, dtype)
    want = jops.flash_attention(jq, jk, jv, JCFG, interpret=True)
    before = _counts()
    got = ops.flash_attention(q, k, v, CFG)
    assert _counts() == before
    assert got.dtype == q.dtype and tuple(got.shape) == (1, NH, t, HD)
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    else:
        _bf16_close(got, want, f"T={t}")


@pytest.mark.parametrize("t", [197, 1025])
def test_flash_attention_scales_as_jax_per_route(t):
    """At hd 48 the scale 1/sqrt(hd) is no power of two, so where it rounds
    shows: the single-pass route multiplies q by the scale rounded to q's
    dtype (``_head_attention``), the blockwise route the fp32 scores by the
    fp32 scale (``_flash_kernel``)."""
    hd = 48
    cfg = ViTConfig(name="hd48", img_size=32, patch_size=8, embed_dim=2 * hd,
                    depth=1, num_heads=2, num_classes=5)
    jcfg = jconfig.ViTConfig(name="hd48", img_size=32, patch_size=8,
                             embed_dim=2 * hd, depth=1, num_heads=2, num_classes=5)
    (q, k, v), (jq, jk, jv) = _qkv((1, 2, t, hd), 13, "bf16")
    want = jops.flash_attention(jq, jk, jv, jcfg, interpret=True)
    _bf16_close(ops.flash_attention(q, k, v, cfg), want, f"hd=48 T={t}")


def test_flash_attention_three_heads_matches_jax():
    """n = B·H = 3, which JAX's heads-per-cell heuristic must divide
    (tests/test_kernels.py's case); the port has no cells."""
    (q, k, v), (jq, jk, jv) = _qkv((1, 3, 197, HD), 7, "f32")
    want = jops.flash_attention(jq, jk, jv, JCFG, interpret=True)
    np.testing.assert_allclose(_np(ops.flash_attention(q, k, v, CFG)),
                               _np(want), rtol=0, atol=F32_ATOL)


def test_flash_attention_blockwise_key_tile_matches_jax():
    """Past T = 1024 the key tile is part of the function (p is rounded to
    bf16 against the running max): the plain version walks JAX's
    ``block_k``, here 256."""
    (q, k, v), (jq, jk, jv) = _qkv((1, NH, 1025, HD), 11, "bf16")
    want = jops.flash_attention(jq, jk, jv, JCFG, block_k=256, interpret=True)
    _bf16_close(ops.flash_attention(q, k, v, CFG, block_k=256), want,
                "T=1025 block_k=256")


def test_flash_attention_takes_strided_views():
    """``profile_ops`` hands the slot the permuted views of a [B, T, 3D]
    GEMM output: the same result as contiguous heads, and the same function
    as the packed route's on those slabs."""
    b, t = 2, 197
    qkv = torch.from_numpy(_rand((b, t, 3 * NH * HD), 3)).to(torch.bfloat16)
    q, k, v = qkv.reshape(b, t, 3, NH, HD).permute(2, 0, 3, 1, 4)
    got = ops.flash_attention(q, k, v, CFG)
    assert torch.equal(got, ops.flash_attention(q.contiguous(), k.contiguous(),
                                                v.contiguous(), CFG))
    packed = attention.packed_fused_attention(qkv, CFG)
    assert torch.equal(got.permute(0, 2, 1, 3).reshape(b, t, NH * HD), packed)


def test_single_pass_masks_keys_past_kv_len():
    """The kernel's key count: keys at and past ``kv_len`` contribute
    nothing, as if the sequence ended there."""
    (q, k, v), _ = _qkv((1, NH, 150, HD), 5, "f32")
    got = attention.single_pass_attention(q, k, v, HD, kv_len=97)
    want = attention.single_pass_attention_reference(q, k[:, :, :97],
                                                     v[:, :, :97], HD)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="kv_len"):
        attention.single_pass_attention(q, k, v, HD, kv_len=151)


def test_packed_window_is_the_single_pass_function():
    """At 849 ≤ T ≤ 1024 (hd 64), the window where the packed kernel's first
    form ran out of shared memory, ``packed_fused_attention`` launches the
    packed kernel on the card again (it streams its K/V tiles): the
    single-pass function, so the single-pass plain version equals the
    packed route's bit for bit."""
    t = 900
    assert attention._packed_route(t, "slab", t, torch.bfloat16) == "packed"
    assert attention._packed_route(848, "slab", 848, torch.bfloat16) == "packed"
    qkv = torch.from_numpy(_rand((1, t, 3 * NH * HD), 9)).to(torch.bfloat16)
    q, k, v = qkv.reshape(1, t, 3, NH, HD).permute(2, 0, 3, 1, 4)
    single = attention.single_pass_attention_reference(q, k, v, HD)
    packed = attention.packed_fused_attention_reference(qkv, NH, HD)
    assert torch.equal(single.permute(0, 2, 1, 3).reshape(1, t, NH * HD), packed)


def test_flash_attention_refuses_mismatched_shapes():
    q = torch.zeros((1, NH, 16, HD))
    with pytest.raises(ValueError, match="shape"):
        ops.flash_attention(q, q[:, :, :8], q, CFG)


@pytest.mark.parametrize("shape", [(197, 128), (2, 197, 768)])
@pytest.mark.parametrize("dtypes", ["f32", "bf16", "bf16+f32"])
def test_residual_layer_norm_matches_jax(shape, dtypes):
    """(normalized, summed) against JAX's ``residual_layer_norm``: the
    statistics of the fp32 sum, both outputs in x's dtype; the residual may
    be fp32 beside a bf16 x, and w, b come in bf16 where x is bf16."""
    x_dt, r_dt = (dtypes.split("+") * 2)[:2]
    d = shape[-1]
    x, r = _rand(shape, 1), _rand(shape, 2)
    w, b = _rand((d,), 3, 0.1) + 1.0, _rand((d,), 4, 0.1)
    w_dt = x_dt
    jout, jsum = jops.residual_layer_norm(
        jnp.asarray(x, DTYPES[x_dt][1]), jnp.asarray(r, DTYPES[r_dt][1]),
        jnp.asarray(w, DTYPES[w_dt][1]), jnp.asarray(b, DTYPES[w_dt][1]),
        1e-6, interpret=True)
    before = _counts()
    out, summed = ops.residual_layer_norm(
        torch.from_numpy(x).to(DTYPES[x_dt][0]), torch.from_numpy(r).to(DTYPES[r_dt][0]),
        torch.from_numpy(w).to(DTYPES[w_dt][0]), torch.from_numpy(b).to(DTYPES[w_dt][0]),
        1e-6)
    assert _counts() == before
    assert out.dtype == summed.dtype == DTYPES[x_dt][0]
    if x_dt == "f32":
        np.testing.assert_allclose(_np(summed), _np(jsum), rtol=0, atol=SUM_ATOL)
        np.testing.assert_allclose(_np(out), _np(jout), rtol=0, atol=LN_ATOL)
    else:
        np.testing.assert_array_equal(_np(summed), _np(jsum))
        _bf16_close(out, jout, f"{shape} {dtypes} normalized")


def test_residual_layer_norm_statistics_of_the_fp32_sum():
    """The LN of the rounded sum is another function: in bf16 the two part
    on a row whose sum carries bits that bf16 drops."""
    x = torch.tensor([[1.0, 2.0 ** -9, 3.0, -4.0]], dtype=torch.bfloat16)
    r = torch.tensor([[2.0 ** -8, 0.0, 1.0, 0.5]], dtype=torch.bfloat16)
    w, b = torch.ones(4), torch.zeros(4)
    out, summed = ops.residual_layer_norm(x, r, w, b)
    assert torch.equal(summed, (x.float() + r.float()).to(torch.bfloat16))
    s = x.float() + r.float()
    want = layernorm.layer_norm_reference(s, w, b, 1e-6).to(torch.bfloat16)
    rounded = layernorm.layer_norm_reference(summed, w, b, 1e-6)
    assert torch.equal(out, want) and not torch.equal(out, rounded)


@pytest.mark.parametrize("shape,axis", [((4, 1000), -1), ((2, 1001), -1),
                                        ((3, 7, 5), 1)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_softmax_matches_jax(shape, axis, dtype):
    """Over 1000+ classes (the reference's kernel stopped at 1024) and over
    another axis: fp32 inside, the input dtype out."""
    tdt, jdt = DTYPES[dtype]
    a = _rand(shape, 6, 4.0)
    want = jops.softmax(jnp.asarray(a, jdt), axis=axis)
    got = ops.softmax(torch.from_numpy(a).to(tdt), axis=axis)
    assert got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)
    else:
        _bf16_close(got, want, f"softmax {shape}")


def test_public_ops_are_jax_s():
    """The kernel layer exports JAX's public ops (``flash_attention_interpret``
    aside: interpret mode has no counterpart here)."""
    public = ("flash_attention", "layer_norm", "residual_layer_norm",
              "fused_linear", "softmax")
    for name in public:
        assert callable(getattr(jops, name)) and callable(getattr(ops, name)), name
    assert not hasattr(ops, "flash_attention_interpret")


# Each slot of the two tables, side by side: key → (JAX's function, the
# port's), by name; None where the slot holds no function.
SLOTS = {
    "xla": {"layer_norm": ("layer_norm", "layer_norm"),
            "matmul": ("_matmul", "matmul_q"),
            "matmul_gelu": ("<lambda>", "<lambda>"),
            "attention": ("xla_attention", "xla_attention")},
}
SLOTS["flash"] = dict(SLOTS["xla"],
                      attention=("flash_attention", "flash_attention"),
                      attention_packed=("packed_fused_attention",
                                        "packed_fused_attention"),
                      _fused_block_if_supported=(None, None))
SLOTS["fused_block"] = SLOTS["flash"]


@pytest.mark.parametrize("impl", ["xla", "flash", "fused_block"])
def test_resolve_kernels_slots_match_jax(impl):
    """Both tables hold the same keys, and each slot the counterpart of
    JAX's function: with ``flash`` the generic ``attention`` slot is the
    split-head ``flash_attention`` (not ``xla_attention``), as JAX's."""
    jk, tk = jvit.resolve_kernels(impl), vit.resolve_kernels(impl)
    assert set(jk) == set(tk) == set(SLOTS[impl])

    def name(f):
        return getattr(f, "__name__", None) if callable(f) else None

    for key, (jname, tname) in SLOTS[impl].items():
        assert (name(jk[key]), name(tk[key])) == (jname, tname), key
    if impl != "xla":
        assert tk["attention"] is attention.flash_attention

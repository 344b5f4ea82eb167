"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no NVIDIA card is present. The shapes
go beyond ViT-B's: ragged rows, K and N that are not multiples of the GEMM
tile, head dims that the attention kernel pads, and a 577-token sequence.
Run on a machine with a card (this file imports no JAX, so the repository's
conftest, which does, is left out):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu_torch import ViTConfig
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.models import quant, vit
from vit_with_opencl_tpu_torch.ops import (_build, attention, fused_block,
                                           layernorm, linear, quantize)

pytestmark = pytest.mark.cuda

# bf16 outputs: within about 2 bf16 ulps, and bit-identical almost
# everywhere (both sides round at the same points; a moved rounding point
# changes about half the elements). fp32 outputs: the kernels sum in another
# order than the plain versions' library calls.
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
MIN_SAME_KERNEL = 0.99
MIN_SAME_CHAIN = 0.7  # the chain compounds the flips of its 7 launches
# The int8 chains against their plain versions. Weight-only int8 rounds as
# the bf16 chain does. W8A8 adds its quantizes: an fp32 LN output or GELU'd
# hidden one ulp away from the plain version's (another summation order, a
# contracted multiply-add) flips an int8 decision now and then, which moves
# its row's products by a quantum: up to 1.8e-2 on outputs that 2 bf16 ulps
# do not cover, hence its own atol. Both chains keep 87-89% of their outputs
# bit-identical at ViT-B shapes (chip_smoke.py phase 2b, H100 80GB HBM3).
MIN_SAME_CHAIN_INT8W = 0.8
MIN_SAME_CHAIN_W8A8 = 0.8
W8A8_CHAIN_TOL = dict(rtol=1.6e-2, atol=3e-2)
# Stacks and groups of several layers carry the fp32 stream across layers: a
# bf16 rounding that another summation order flips moves the stream, and the
# later layers carry the move on. Measured at D = 192, depth 3 and 4 (H100
# 80GB HBM3): 53-57% identical, max abs error 0.023 (bf16, int8 weights)
# and 0.059 (W8A8) on outputs up to about 4; hence a wider atol and a lower
# share than one layer's. At one layer (fused_encoder_layer_flat) the stack
# keeps the per-layer chain's bounds.
STACK_TOL = dict(rtol=1.6e-2, atol=5e-2)
STACK_W8A8_TOL = dict(rtol=1.6e-2, atol=0.12)
MIN_SAME_STACK = 0.4
MIN_SAME_STACK_W8A8 = 0.15
# And the mean abs error of a bf16 or int8-weight stack or group against its
# plain version stays below this share of the distance between the plain
# per-layer chain (the stream rounded at every layer, the fault the stack
# exists to avoid) and the plain stack. Measured on an H100 80GB HBM3 (with
# the first version of the stack): the bf16 stack 0.57, the groups
# 0.62-0.67; a stack whose kernels round the stream 1.0. W8A8 has no such
# bound: its int8 flips alone put ViT-S's W8A8 stack at 0.73 (chip_smoke.py).
STACK_FAULT_SHARE = 0.8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dev, dtype=torch.float32, std=1.0, seed=0):
    a = np.random.default_rng(seed).normal(0, std, shape).astype(np.float32)
    return torch.from_numpy(a).to(dev).to(dtype)


def _close(out, ref, min_same=MIN_SAME_KERNEL, tol=BF16_TOL):
    if out.dtype != torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), **F32_TOL)
        return
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert (out == ref).float().mean().item() >= min_same


# The presets' widths (each a compile-time form of the kernel: 8, 16 or 32
# lanes a row), a width of whole 16-byte vectors that is none of them (64),
# and one whose rows are not 16-byte aligned in bf16 (100); one row, a
# ragged block of rows, and ViT-B's B = 16.
@pytest.mark.parametrize("cols", [64, 100, 192, 384, 768, 1024, 1280, 1664])
@pytest.mark.parametrize("rows", [1, 74, 3152])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
def test_layer_norm_kernel(dev, rows, cols, in_dtype, out_dtype):
    x = _rand((rows, cols), dev, in_dtype, std=2.0)
    w = _rand((cols,), dev, std=0.1, seed=1) + 1.0
    b = _rand((cols,), dev, std=0.1, seed=2)
    before = layernorm.LAUNCHES
    out = layernorm.layer_norm(x, w, b, 1e-6, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert layernorm.LAUNCHES == before + 1 and out.dtype == out_dtype
    _close(out, layernorm.layer_norm_reference(x, w, b, 1e-6, out_dtype=out_dtype))
    assert torch.equal(out, layernorm.layer_norm(x, w, b, 1e-6, out_dtype=out_dtype))


# Beyond ViT-B: the ViT-L and ViT-H widths (K, N = 1024, 4096 and 1280,
# 5120) and ViT-Ti's, whose N or K of 192 is not a multiple of the 128-wide
# tile (16 * 197 rows: B = 16).
WIDE_GEMMS = [(3152, 1024, 4096), (1576, 1280, 5120), (16 * 197, 192, 576),
              (16 * 197, 768, 192)]


@pytest.mark.parametrize("m,k,n", [(74, 64, 192), (394, 768, 2304),
                                   (33, 40, 24), (1, 3072, 768)] + WIDE_GEMMS)
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "res_f32", "res_bf16"])
def test_fused_linear_kernel(dev, m, k, n, epilogue):
    x = _rand((m, k), dev, torch.bfloat16)
    w = _rand((k, n), dev, torch.bfloat16, std=0.05, seed=1)
    b = _rand((n,), dev, std=0.1, seed=2)
    kw = {"fuse_gelu": epilogue == "gelu"}
    if epilogue.startswith("res"):
        rdt = torch.float32 if epilogue == "res_f32" else torch.bfloat16
        kw.update(residual=_rand((m, n), dev, rdt, seed=3), out_dtype=torch.float32)
    before = linear.LAUNCHES
    out = linear.fused_linear(x, w, b, **kw)
    torch.cuda.synchronize()
    assert linear.LAUNCHES == before + 1
    _close(out, linear.fused_linear_reference(x, w, b, **kw))


def test_fused_linear_rejects_fp32(dev):
    """fp32 x runs with an fp32 w (the fp32 GEMM: test_fused_linear_fp32_kernel);
    fp32 x with a bf16 or int8 w, and bf16 x with an fp32 w, raise."""
    x = _rand((4, 8), dev)
    with pytest.raises(NotImplementedError):
        linear.fused_linear(x, _rand((8, 8), dev, torch.bfloat16))
    with pytest.raises(NotImplementedError):
        linear.fused_linear(x.to(torch.bfloat16), _rand((8, 8), dev))
    before = linear.LAUNCHES_F32
    linear.fused_linear(x, _rand((8, 8), dev))
    assert linear.LAUNCHES_F32 == before + 1


@pytest.mark.parametrize("b,t,nh,hd", [(2, 37, 4, 16), (2, 197, 12, 64),
                                       (1, 50, 2, 104), (1, 577, 2, 64)])
def test_packed_attention_kernel(dev, b, t, nh, hd):
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16)
    before = attention.LAUNCHES
    out = attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 1
    _close(out, attention.packed_fused_attention_reference(qkv, nh, hd))


# The Hopper kernels' edges: sequence lengths about their 64-row tiles and
# 256-key single pass, ViT-B's, ViT-L/16@384's, the first form's last (848)
# and the route's last (1024); head dims below one 64-column box, at it, and
# two boxes (ViT-H's 80, ViT-G's 104, 128).
EDGE_TS = (1, 16, 17, 63, 64, 65, 197, 255, 256, 257, 577, 848, 1024)
EDGE_HDS = (16, 64, 80, 104, 128)
EDGE_SHAPES = [(t, hd) for t in EDGE_TS for hd in EDGE_HDS]


@pytest.mark.parametrize("t,hd", EDGE_SHAPES)
def test_packed_attention_kernel_edges(dev, t, hd):
    b, nh = 2, 2
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16, seed=t + hd)
    before = attention.LAUNCHES
    out = attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 1
    _close(out, attention.packed_fused_attention_reference(qkv, nh, hd))


@pytest.mark.parametrize("d,nh,t", [(64, 4, 37), (768, 12, 197)])
def test_encoder_layer_chain(dev, d, nh, t):
    cfg = ViTConfig(name="chain", img_size=32, patch_size=8, embed_dim=d,
                    depth=1, num_heads=nh, num_classes=9)
    params = vit.stack_params(fixtures.random_params(cfg, seed=5), cfg,
                              param_dtype=torch.bfloat16, device=dev)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = _rand((2, t, d), dev, torch.bfloat16, std=0.5, seed=6)
    before = (layernorm.LAUNCHES, linear.LAUNCHES, attention.LAUNCHES)
    out = fused_block.fused_encoder_layer(x, lp, cfg)
    torch.cuda.synchronize()
    assert (layernorm.LAUNCHES, linear.LAUNCHES, attention.LAUNCHES) == (
        before[0] + 2, before[1] + 4, before[2] + 1)
    _close(out, fused_block.fused_encoder_layer_reference(x, lp, cfg),
           min_same=MIN_SAME_CHAIN)


def _with_special_rows(x):
    """Row 3 all zeros (the 2^-93 floor); row 5 with absmax 127, so r = 1
    and the half-way values must round to even."""
    x[3] = 0
    x[5] = 0
    x[5, :5] = torch.tensor([127.0, 2.5, 3.5, -2.5, 0.5])
    return x


# csrc/quantize.cu's compile-time forms (QuantWidths): the presets' D and
# MLP widths. Rows of 3072 and 4096 fp32, 5120 and 8192 bf16 take two
# warps each, 5120 and 8192 fp32 four.
QUANT_WIDTHS = (192, 384, 768, 1024, 1280, 1536, 1664, 3072, 4096, 5120, 8192)
# Each form at 19 ragged rows; the several-warp forms over several blocks,
# at a few rows, and with two rows a block (3152 x 3072, 1100 x 8192 bf16:
# enough rows for blocks of 4 warps); two general widths (112, 400).
QUANT_SHAPES = ([(37, 768), (3152, 768), (197, 3072)]
                + [(19, w) for w in QUANT_WIDTHS]
                + [(197, 5120), (197, 8192), (7, 8192), (3152, 3072), (1100, 8192),
                   (19, 112), (19, 400)])


@pytest.mark.parametrize("rows,cols", QUANT_SHAPES)
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_kernel(dev, rows, cols, in_dtype):
    x = _with_special_rows(_rand((rows, cols), dev, in_dtype, std=2.0))
    before = quantize.LAUNCHES
    q, s = quantize.quantize_rows(x)
    torch.cuda.synchronize()
    assert quantize.LAUNCHES == before + 1
    rq, rs = quantize.quantize_rows_reference(x)
    assert q.dtype == torch.int8 and s.shape == (rows, 1)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert q[5, :5].tolist() == [127, 2, 4, -2, 0] and not q[3].any()


def _int8_weight(k, n, dev, seed=1):
    return quant.quantize_weight_device(_rand((k, n), dev, std=0.05, seed=seed))


def _epilogue_kw(epilogue, m, n, dev):
    kw = {"fuse_gelu": epilogue == "gelu",
          "out_dtype": torch.bfloat16 if epilogue == "bias_bf16" else torch.float32}
    if epilogue.startswith("res"):
        rdt = torch.float32 if epilogue == "res_f32" else torch.bfloat16
        kw["residual"] = _rand((m, n), dev, rdt, seed=3)
    return kw


def _w8a8_weight(k, n, dev, seed=1):
    """An int8 weight in the W8A8 GEMM's layout (K-major) and its scale."""
    w = _int8_weight(k, n, dev, seed)
    return {**w, "q": quant.k_major(w["q"])}


# Ragged M, N and K (K = 64, 48, 640, 672 and 2944 are not multiples of the
# 128-deep int8 slice; TMA zero-fills the rest), M = 1 and N = 16, ViT-B's
# shapes, the TP shards' (out-proj's K = 192 on 4 shards, qkv's N = 576),
# ViT-S's K = 384, and 600 tiles (M = 3152, N = 3072: more than four waves
# of SMs, so the persistent grid wraps).
W8A8_SHAPES = [(74, 64, 192), (3152, 768, 2304), (33, 3072, 768), (1, 48, 16),
               (394, 192, 768), (394, 768, 576), (394, 384, 1536), (74, 640, 256),
               (37, 672, 768), (33, 2944, 768), (1, 672, 16), (3152, 768, 3072)]


@pytest.mark.parametrize("m,k,n", W8A8_SHAPES)
@pytest.mark.parametrize("epilogue", ["bias_bf16", "bias_f32", "res_f32",
                                      "res_bf16", "gelu"])
def test_fused_linear_w8a8_kernel(dev, m, k, n, epilogue):
    """Exact integer sums and the plain version's fp32 epilogue, operation
    for operation: bit-identical without GELU. The GELU's polynomial is
    contracted into multiply-adds in the kernel and not in PyTorch."""
    xq, sx = quant.quantize_act(_rand((m, k), dev))
    w = _w8a8_weight(k, n, dev)
    b = _rand((n,), dev, std=0.1, seed=2)
    kw = _epilogue_kw(epilogue, m, n, dev)
    before = linear.LAUNCHES_W8A8
    out = linear.fused_linear_w8a8(xq, sx, w["q"], w["scale"], b, **kw)
    torch.cuda.synchronize()
    assert linear.LAUNCHES_W8A8 == before + 1
    ref = linear.fused_linear_w8a8_reference(xq, sx, w["q"], w["scale"], b, **kw)
    assert out.dtype == kw["out_dtype"]
    if epilogue != "gelu":
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, **F32_TOL)
        assert (out == ref).float().mean().item() >= MIN_SAME_KERNEL


# Ragged M, N and K (K = 40: one 64-deep slice, zero-filled), M = 1, the
# ViT-Ti/S widths (K = 192 and 384), ViT-B's shapes, and 600 tiles (M = 3152:
# ViT-B at B = 16, N = 3072), more than four waves of SMs, so that the
# persistent grid wraps and the int8 ring's slots are reused across units.
@pytest.mark.parametrize("m,k,n", [(74, 64, 192), (394, 768, 2304),
                                   (33, 40, 32), (1, 3072, 768),
                                   (394, 192, 576), (394, 384, 1536),
                                   (3152, 768, 3072)])
@pytest.mark.parametrize("epilogue", ["bias_bf16", "gelu", "res_f32", "res_bf16",
                                      "res_f32_bf16"])
def test_fused_linear_int8w_kernel(dev, m, k, n, epilogue):
    """The int8-weight GEMM on the Hopper core (w widened to bf16 in shared
    memory) against its plain version, in every epilogue the chains take:
    qkv's bias (TMA-store epilogue), fc1's GELU, out-proj's residual, fc2's
    fp32 residual with bf16 out, and the stack's fp32 stream (res_f32)."""
    x = _rand((m, k), dev, torch.bfloat16)
    w = _int8_weight(k, n, dev)
    b = _rand((n,), dev, std=0.1, seed=2)
    kw = _epilogue_kw("res_f32" if epilogue == "res_f32_bf16" else epilogue, m, n, dev)
    if epilogue in ("gelu", "res_f32_bf16"):
        kw["out_dtype"] = torch.bfloat16
    before = linear.LAUNCHES_INT8W
    out = linear.fused_linear(x, w["q"], b, w_scale=w["scale"], **kw)
    torch.cuda.synchronize()
    assert linear.LAUNCHES_INT8W == before + 1
    _close(out, linear.fused_linear_reference(x, w["q"], b, w_scale=w["scale"], **kw))


def test_int8_wrappers_refuse_shapes(dev):
    """int8 operands move in 16-byte chunks: K and N must be multiples of 16
    (N only, for the int8-weight GEMM). The wrappers raise; they never fall
    back to a plain version."""
    w = _int8_weight(24, 32, dev)
    with pytest.raises(ValueError, match="multiple"):
        quantize.quantize_rows(_rand((4, 24), dev))
    xq = torch.zeros((4, 24), dtype=torch.int8, device=dev)
    sx = torch.ones((4, 1), device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        linear.fused_linear_w8a8(xq, sx, quant.k_major(w["q"]), w["scale"])
    w = _int8_weight(32, 24, dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        linear.fused_linear_w8a8(xq[:, :16].contiguous(), sx,
                                 quant.k_major(w["q"][:16]), w["scale"])
    with pytest.raises(ValueError, match="of 16"):
        linear.fused_linear(_rand((4, 32), dev, torch.bfloat16), w["q"],
                            w_scale=w["scale"])


def test_w8a8_wrapper_refuses_other_weight_layouts(dev):
    """int8 wgmma reads w K-major only, and the wrapper never transposes a
    weight itself: a row-major w, a K-major one whose columns are not
    16-byte-aligned rows apart, and one at a misaligned base raise a
    ValueError and launch nothing; the weight-only GEMM refuses the K-major
    one (the two modes' weights are kept apart)."""
    m, k, n = 8, 64, 32
    xq, sx = quant.quantize_act(_rand((m, k), dev))
    w = _int8_weight(k, n, dev)
    padded = torch.zeros((n, k + 8), dtype=torch.int8, device=dev)
    padded[:, :k] = w["q"].t()
    shifted = torch.zeros((n * k + 16,), dtype=torch.int8, device=dev)
    shifted[8:8 + n * k] = w["q"].t().reshape(-1)
    before = (linear.LAUNCHES_W8A8, linear.LAUNCHES_INT8W)
    for bad in (w["q"], padded[:, :k].t(), shifted[8:8 + n * k].view(n, k).t()):
        assert torch.equal(bad, w["q"])
        with pytest.raises(ValueError, match="K-major"):
            linear.fused_linear_w8a8(xq, sx, bad, w["scale"])
    with pytest.raises(ValueError, match="contiguous"):
        linear.fused_linear(_rand((m, k), dev, torch.bfloat16), quant.k_major(w["q"]),
                            w_scale=w["scale"])
    assert (linear.LAUNCHES_W8A8, linear.LAUNCHES_INT8W) == before
    # A 16-byte row pitch past K (a TP shard's view) is read as it is.
    wide = torch.zeros((n, k + 16), dtype=torch.int8, device=dev)
    wide[:, :k] = w["q"].t()
    out = linear.fused_linear_w8a8(xq, sx, wide[:, :k].t(), w["scale"])
    torch.cuda.synchronize()
    assert torch.equal(out, linear.fused_linear_w8a8_reference(xq, sx, w["q"], w["scale"]))


@pytest.mark.parametrize("d,nh,t", [(64, 4, 37), (768, 12, 197)])
@pytest.mark.parametrize("w8a8", [False, True], ids=["int8w", "w8a8"])
def test_int8_encoder_layer_chain(dev, d, nh, t, w8a8):
    cfg = ViTConfig(name="chain", img_size=32, patch_size=8, embed_dim=d,
                    depth=1, num_heads=nh, num_classes=9)
    params = quant.quantize_stacked_params(
        vit.stack_params(fixtures.random_params(cfg, seed=5), cfg,
                         param_dtype=torch.bfloat16, device=dev), cfg)
    if w8a8:
        params = quant.w8a8_layout(params)
    lp = vit._layer(params, 0)
    x = _rand((2, t, d), dev, torch.bfloat16, std=0.5, seed=6)
    counters = ((layernorm, "LAUNCHES"), (quantize, "LAUNCHES"),
                (linear, "LAUNCHES_W8A8" if w8a8 else "LAUNCHES_INT8W"),
                (attention, "LAUNCHES"),
                (fused_block, "LAUNCHES_W8A8" if w8a8 else "LAUNCHES_INT8W"))
    before = [getattr(mod, name) for mod, name in counters]
    out = fused_block.fused_encoder_layer(x, lp, cfg, w8a8=w8a8)
    torch.cuda.synchronize()
    after = [getattr(mod, name) for mod, name in counters]
    assert [a - b for a, b in zip(after, before)] == (
        [2, 4, 4, 1, 1] if w8a8 else [2, 0, 4, 1, 1])
    _close(out, fused_block.fused_encoder_layer_reference(x, lp, cfg, w8a8=w8a8),
           min_same=MIN_SAME_CHAIN_W8A8 if w8a8 else MIN_SAME_CHAIN_INT8W,
           tol=W8A8_CHAIN_TOL if w8a8 else BF16_TOL)


def test_w8a8_flash_forward_matches_plain_chain(dev, monkeypatch):
    """The W8A8 forward through the kernels against the same forward with
    the chain's links swapped for their plain versions: the 1e-3 budget on
    probabilities."""
    cfg = ViTConfig(name="fwd", img_size=32, patch_size=8, embed_dim=64,
                    depth=2, num_heads=4, num_classes=9)
    params = quant.w8a8_layout(quant.quantize_stacked_params(
        vit.stack_params(fixtures.random_params(cfg, seed=7, scale=0.05), cfg,
                         device=dev), cfg))
    images = torch.from_numpy(fixtures.random_images(cfg, n=3, seed=3)).to(dev)
    kernels = vit.resolve_kernels("flash", w8a8=True)
    before = fused_block.LAUNCHES_W8A8
    probs = vit.forward(images, params, cfg, kernels=kernels)
    torch.cuda.synchronize()
    assert fused_block.LAUNCHES_W8A8 == before + cfg.depth
    monkeypatch.setattr(fused_block, "fused_encoder_layer",
                        fused_block.fused_encoder_layer_reference)
    ref = vit.forward(images, params, cfg, kernels=kernels)
    assert (probs - ref).abs().max().item() < 1e-3


def _outlier_rows(rows, cols, dev, dtype, hot=(5, 63, 700)):
    """Rows with hot columns (60x), a zero row (3), and a row (5) whose
    absmax is 127 with half-way values."""
    x = _rand((rows, cols), dev, std=1.0, seed=8)
    x[:, [c for c in hot if c < cols]] *= 60.0
    x = _with_special_rows(x.to(dtype))
    return x


# The calibrated chains' splits at ViT-B (768/640, 3072/2944), each form
# with its last 128 columns (64 of 192) in the bf16 tail, the several-warp
# forms over several blocks and with two rows a block, and general widths.
SPLIT_SHAPES = ([(37, 768, 640), (3152, 768, 640), (197, 3072, 2944), (6, 64, 48),
                 (50, 512, 496)]
                + [(19, w, w - (64 if w == 192 else 128)) for w in QUANT_WIDTHS]
                + [(197, 8192, 8064), (197, 5120, 4992), (3152, 3072, 2944),
                   (19, 400, 272)])


@pytest.mark.parametrize("rows,cols,m", SPLIT_SHAPES)
def test_quantize_rows_split_kernel(dev, rows, cols, m):
    """Bit-identical to the plain version: codes, scales and the tail (bf16
    rounded to nearest even)."""
    x = _outlier_rows(rows, cols, dev, torch.float32)
    bf = torch.bfloat16
    before = quantize.LAUNCHES_SPLIT
    q, s, hi = quantize.quantize_rows_split(x, m, bf)
    torch.cuda.synchronize()
    assert quantize.LAUNCHES_SPLIT == before + 1
    rq, rs, rhi = quantize.quantize_rows_split_reference(x, m, bf)
    assert q.shape == (rows, m) and hi.shape == (rows, cols - m) and hi.dtype == bf
    assert torch.equal(q, rq) and torch.equal(s, rs) and torch.equal(hi, rhi)
    assert q[5, :5].tolist() == [127, 2, 4, -2, 0] and not q[3].any()


# ViT-B's context at B = 16 and 256; each preset pair (num_heads * hd, hd),
# a form of the kernel, at its default kh (max(2, hd // 8): 8, 10, 13) and
# at tails of 16, 9 (4-byte stores of hi) and 3 heads of 3 (2-byte stores);
# pairs of no preset (the general form): hd 16, 32 and 48.
MASKED_SHAPES = [(37, 12, 64, 8), (3152, 12, 64, 8), (50432, 12, 64, 8),
                 (6, 4, 16, 2), (74, 4, 32, 4), (33, 16, 64, 8), (9, 12, 64, 1),
                 (19, 3, 64, 8), (19, 6, 64, 8), (19, 12, 64, 8), (19, 16, 64, 8),
                 (19, 16, 80, 10), (19, 16, 104, 13), (197, 16, 104, 13),
                 (19, 12, 64, 16), (19, 3, 64, 3), (19, 4, 48, 6)]


@pytest.mark.parametrize("rows,nh,hd,kh", MASKED_SHAPES)
def test_quantize_rows_masked_kernel(dev, rows, nh, hd, kh):
    """Bit-identical to the plain version, with tails above the kept absmax
    clipped to +-127 (not wrapped around)."""
    dtype = torch.bfloat16
    x = _outlier_rows(rows, nh * hd, dev, dtype, hot=(hd - 1, 2 * hd - 1))
    x[5, hd - 1] = 900.0  # far above row 5's kept absmax of 127
    before = quantize.LAUNCHES_MASKED
    q, s, hi = quantize.quantize_rows_masked(x, nh, hd, kh)
    torch.cuda.synchronize()
    assert quantize.LAUNCHES_MASKED == before + 1
    rq, rs, rhi = quantize.quantize_rows_masked_reference(x, nh, hd, kh)
    assert hi.shape == (rows, nh * kh) and hi.dtype == dtype
    assert torch.equal(q, rq) and torch.equal(s, rs) and torch.equal(hi, rhi)
    assert q[5, hd - 1].item() == 127 and q[5, :5].tolist() == [127, 2, 4, -2, 0]
    assert not q[3].any()


# ViT-B's four (K = 640, 768 masked, 640, 2944 against K_hi = 128, 96), a
# ragged K and K_hi (672, 48), ViT-S's K = 384, M = 1 with N = 16, and 600
# tiles (the persistent grid wraps; both warpgroups share each tile).
@pytest.mark.parametrize("m,k,n,k_hi", [(74, 64, 192, 16), (3152, 640, 2304, 128),
                                        (33, 2944, 768, 128), (1, 768, 768, 96),
                                        (394, 768, 768, 96), (74, 672, 768, 48),
                                        (394, 384, 1536, 32), (1, 672, 16, 96),
                                        (3152, 640, 3072, 128)])
@pytest.mark.parametrize("epilogue", ["bias_bf16", "bias_f32", "res_f32",
                                      "res_bf16", "gelu"])
def test_fused_linear_w8a8_side_kernel(dev, m, k, n, k_hi, epilogue):
    """The int8 sums are exact; the bf16 side product sums in another order
    than the plain version's fp32 GEMM, so the outputs are close, not
    identical, and bf16 outputs almost always identical."""
    xq, sx = quant.quantize_act(_rand((m, k), dev))
    w = _w8a8_weight(k, n, dev)
    x_hi = _rand((m, k_hi), dev, torch.bfloat16, std=20.0, seed=4)
    w_hi = _rand((k_hi, n), dev, torch.bfloat16, std=0.05, seed=5)
    b = _rand((n,), dev, std=0.1, seed=2)
    kw = _epilogue_kw(epilogue, m, n, dev)
    before = (linear.LAUNCHES_W8A8, linear.LAUNCHES_W8A8_HI)
    out = linear.fused_linear_w8a8(xq, sx, w["q"], w["scale"], b, x_hi=x_hi,
                                   w_hi=w_hi, **kw)
    torch.cuda.synchronize()
    assert (linear.LAUNCHES_W8A8, linear.LAUNCHES_W8A8_HI) == (before[0], before[1] + 1)
    ref = linear.fused_linear_w8a8_reference(xq, sx, w["q"], w["scale"], b,
                                             x_hi=x_hi, w_hi=w_hi, **kw)
    assert out.dtype == kw["out_dtype"]
    _close(out, ref)


def test_outlier_wrappers_refuse_shapes(dev):
    x, bf = _rand((4, 64), dev), torch.bfloat16
    with pytest.raises(ValueError, match="multiple of 16"):
        quantize.quantize_rows_split(x, 40, bf)
    with pytest.raises(ValueError, match="K - m"):
        quantize.quantize_rows_split(x, 64, bf)
    for x_dtype, hi_dtype in ((bf, bf), (torch.float32, torch.float32)):
        with pytest.raises(TypeError, match="fp32 x"):
            quantize.quantize_rows_split(x.to(x_dtype), 48, hi_dtype)
    with pytest.raises(ValueError, match="num_heads"):
        quantize.quantize_rows_masked(x.to(bf), 4, 8, 2)
    with pytest.raises(TypeError, match="bf16 x"):
        quantize.quantize_rows_masked(x, 4, 16, 2)
    xq, sx = quant.quantize_act(x)
    w = _w8a8_weight(64, 16, dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        linear.fused_linear_w8a8(xq, sx, w["q"], w["scale"],
                                 x_hi=_rand((4, 12), dev, torch.bfloat16),
                                 w_hi=_rand((12, 16), dev, torch.bfloat16))
    with pytest.raises(TypeError, match="x_hi"):
        linear.fused_linear_w8a8(xq, sx, w["q"], w["scale"],
                                 x_hi=_rand((4, 16), dev),
                                 w_hi=_rand((16, 16), dev, torch.bfloat16))


def _calibrated(cfg, dev, seed=5, head_scale=6.0):
    """Adversarial weights, bf16 on the card, calibrated there."""
    pn = fixtures.adversarial_params(cfg, seed=seed)
    pn["heads_head_weight"] = pn["heads_head_weight"] * head_scale
    stacked = vit.stack_params(pn, cfg, device=dev)
    calib = fixtures.random_images(cfg, n=8, seed=99)
    return vit.params_to(quant.calibrate_w8a8(calib, stacked, cfg), dev)


@pytest.mark.parametrize("d,nh,t", [(128, 4, 37), (768, 12, 197)])
def test_outlier_encoder_layer_chain(dev, d, nh, t):
    cfg = ViTConfig(name="chain", img_size=32, patch_size=8, embed_dim=d,
                    depth=1, num_heads=nh, num_classes=9)
    lp = vit._layer(_calibrated(cfg, dev), 0)
    x = _rand((2, t, d), dev, torch.bfloat16, std=0.5, seed=6)
    counters = ((layernorm, "LAUNCHES"), (quantize, "LAUNCHES"),
                (quantize, "LAUNCHES_SPLIT"), (quantize, "LAUNCHES_MASKED"),
                (linear, "LAUNCHES_W8A8"), (linear, "LAUNCHES_W8A8_HI"),
                (attention, "LAUNCHES"), (fused_block, "LAUNCHES_W8A8"),
                (fused_block, "LAUNCHES_W8A8_OUTLIER"))
    before = [getattr(mod, name) for mod, name in counters]
    out = fused_block.fused_encoder_layer(x, lp, cfg, w8a8=True)
    torch.cuda.synchronize()
    after = [getattr(mod, name) for mod, name in counters]
    assert [a - b for a, b in zip(after, before)] == [2, 0, 3, 1, 0, 4, 1, 0, 1]
    _close(out, fused_block.fused_encoder_layer_reference(x, lp, cfg, w8a8=True),
           min_same=MIN_SAME_CHAIN_W8A8, tol=W8A8_CHAIN_TOL)


def test_outlier_flash_forward_matches_plain_chain(dev, monkeypatch):
    """Calibrated outlier-aware W8A8 through the kernels against the same
    forward with the chain's links swapped for their plain versions: the
    1e-3 budget on probabilities."""
    cfg = ViTConfig(name="fwd", img_size=32, patch_size=8, embed_dim=128,
                    depth=2, num_heads=4, num_classes=9)
    params = _calibrated(cfg, dev, seed=7)
    images = torch.from_numpy(fixtures.random_images(cfg, n=3, seed=3)).to(dev)
    kernels = vit.resolve_kernels("flash", w8a8=True,
                                  heads=(cfg.num_heads, cfg.head_dim))
    before = fused_block.LAUNCHES_W8A8_OUTLIER
    probs = vit.forward(images, params, cfg, kernels=kernels)
    torch.cuda.synchronize()
    assert fused_block.LAUNCHES_W8A8_OUTLIER == before + cfg.depth
    monkeypatch.setattr(fused_block, "fused_encoder_layer",
                        fused_block.fused_encoder_layer_reference)
    ref = vit.forward(images, params, cfg, kernels=kernels)
    assert (probs - ref).abs().max().item() < 1e-3


def test_flash_forward_within_parity_budget(dev):
    """bf16 through the kernels against the plain fp32 forward: the
    reference's 1e-3 budget on probabilities."""
    cfg = ViTConfig(name="fwd", img_size=32, patch_size=8, embed_dim=64,
                    depth=2, num_heads=4, num_classes=9)
    params = fixtures.random_params(cfg, seed=7, scale=0.05)
    images = torch.from_numpy(fixtures.random_images(cfg, n=3, seed=3)).to(dev)
    ref = vit.forward(images, vit.stack_params(params, cfg, param_dtype=torch.float32,
                                               device=dev),
                      cfg, compute_dtype=torch.float32)
    probs = vit.forward(images, vit.stack_params(params, cfg, device=dev), cfg,
                        kernels=vit.resolve_kernels("flash"))
    assert (probs - ref).abs().max().item() < 1e-3


def _assert_nearer_than_fault(out, ref, x, layers, cfg):
    """``out`` is nearer the plain stack ``ref`` than the plain per-layer
    chain is, by STACK_FAULT_SHARE, in mean abs error."""
    y = x
    for layer in range(cfg.depth):
        y = fused_block.fused_encoder_layer_reference(
            y, vit._layer({"layers": layers}, layer), cfg)
    fault = (y.float() - ref.float()).abs().mean().item()
    assert (out.float() - ref.float()).abs().mean().item() <= STACK_FAULT_SHARE * fault


def _stack_case(dev, form, depth=3, d=192, nh=3):
    cfg = ViTConfig(name="stack", img_size=32, patch_size=8, embed_dim=d,
                    depth=depth, num_heads=nh, num_classes=9)
    params = vit.stack_params(fixtures.random_params(cfg, seed=5, scale=0.05), cfg,
                              device=dev)
    if form != "bf16":
        params = quant.quantize_stacked_params(params, cfg)
    if form == "w8a8":
        params = quant.w8a8_layout(params)
    x = _rand((2, 197, d), dev, torch.bfloat16, std=0.5, seed=6)
    return cfg, params["layers"], x


@pytest.mark.parametrize("form", ["bf16", "int8w", "w8a8"])
def test_encoder_stack_chain(dev, form):
    """ViT-Ti's width, depth 3: the stack against its plain version, with 7
    launches a layer (bf16, int8 weights) or 11 (W8A8)."""
    cfg, layers, x = _stack_case(dev, form)
    w8a8, depth = form == "w8a8", cfg.depth
    mm_name = {"bf16": "LAUNCHES", "int8w": "LAUNCHES_INT8W",
               "w8a8": "LAUNCHES_W8A8"}[form]
    stack_name = {"bf16": "LAUNCHES_STACK", "int8w": "LAUNCHES_STACK_INT8W",
                  "w8a8": "LAUNCHES_STACK_W8A8"}[form]
    counters = ((layernorm, "LAUNCHES"), (linear, mm_name), (attention, "LAUNCHES"),
                (quantize, "LAUNCHES"), (fused_block, stack_name))
    before = [getattr(mod, name) for mod, name in counters]
    out = fused_block.fused_encoder_stack(x, layers, cfg, w8a8=w8a8)
    torch.cuda.synchronize()
    after = [getattr(mod, name) for mod, name in counters]
    want = [2 * depth, 4 * depth, depth, 4 * depth if w8a8 else 0, 1]
    assert [a - b for a, b in zip(after, before)] == want
    ref = fused_block.fused_encoder_stack_reference(x, layers, cfg, w8a8=w8a8)
    _close(out, ref, min_same=MIN_SAME_STACK_W8A8 if w8a8 else MIN_SAME_STACK,
           tol=STACK_W8A8_TOL if w8a8 else STACK_TOL)
    if not w8a8:
        _assert_nearer_than_fault(out, ref, x, layers, cfg)


def test_encoder_layer_flat_chain(dev):
    """The stack at one layer: 7 launches, held to the per-layer chain's
    bounds (no later layer carries a flip on)."""
    cfg, layers, x = _stack_case(dev, "bf16", depth=1)
    lp = vit._layer({"layers": layers}, 0)
    counters = ((layernorm, "LAUNCHES"), (linear, "LAUNCHES"),
                (attention, "LAUNCHES"), (fused_block, "LAUNCHES_STACK"))
    before = [getattr(mod, name) for mod, name in counters]
    out = fused_block.fused_encoder_layer_flat(x, lp, cfg)
    torch.cuda.synchronize()
    after = [getattr(mod, name) for mod, name in counters]
    assert [a - b for a, b in zip(after, before)] == [2, 4, 1, 1]
    _close(out, fused_block.fused_encoder_stack_reference(x, layers, cfg),
           min_same=MIN_SAME_CHAIN)


@pytest.mark.parametrize("form", ["bf16", "int8w"])
def test_encoder_group_chain(dev, form):
    """Groups of 2 over depth 4 at ViT-Ti's width against the plain groups:
    one group count per group, 7 launches a layer."""
    cfg, layers, x = _stack_case(dev, form, depth=4)
    mm_name = "LAUNCHES_INT8W" if form == "int8w" else "LAUNCHES"
    before = (fused_block.LAUNCHES_GROUP, layernorm.LAUNCHES, getattr(linear, mm_name))
    out = fused_block.fused_encoder_group(x, layers, cfg, group_size=2)
    torch.cuda.synchronize()
    assert (fused_block.LAUNCHES_GROUP, layernorm.LAUNCHES,
            getattr(linear, mm_name)) == (before[0] + 2, before[1] + 8, before[2] + 16)
    ref = fused_block.fused_encoder_group_reference(x, layers, cfg, group_size=2)
    _close(out, ref, min_same=MIN_SAME_STACK, tol=STACK_TOL)
    _assert_nearer_than_fault(out, ref, x, layers, cfg)


# -- training: the backward's kernels and stages ----------------------------

# The backward's fp32 outputs (gradients, dx2) are long sums the kernels take
# in another order than the plain versions' library calls: held to a share
# of each output's largest magnitude. bf16 outputs as elsewhere.
GRAD_REL = 1e-3
MIN_SAME_ATTN_BWD = 0.9


def _rel_close(out, ref, rel=GRAD_REL):
    out, ref = out.float(), ref.float()
    scale = max(float(ref.abs().max()), 1e-30)
    assert float((out - ref).abs().max()) <= rel * scale


@pytest.mark.parametrize("b,t,nh,hd", [(2, 37, 4, 16), (2, 197, 12, 64),
                                       (1, 50, 2, 104), (1, 197, 2, 128),
                                       (1, 577, 2, 64), (1, 257, 2, 104),
                                       (1, 257, 2, 80), (1, 900, 1, 64)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_packed_attention_bwd_kernel(dev, b, t, nh, hd, out_dtype):
    """The streamed kernels at ViT-B's T, the presets' (ViT-L/16@384's 577
    at hd 64, ViT-H/14's and ViT-G/14's 257 at hd 80 and 104) and past
    them: tiles of 64 rows, T not a multiple of them."""
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16)
    do = _rand((b, t, nh * hd), dev, torch.bfloat16, seed=1)
    before = attention.LAUNCHES_BWD
    out = attention.packed_attention_bwd(qkv, do, nh, hd, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_BWD == before + 1 and out.dtype == out_dtype
    ref = attention.packed_attention_bwd_reference(qkv, do, nh, hd,
                                                   out_dtype=out_dtype)
    if out_dtype == torch.bfloat16:
        _close(out, ref, min_same=MIN_SAME_ATTN_BWD,
               tol=dict(rtol=1.6e-2, atol=1e-2 * float(ref.float().abs().max())))
    else:
        _rel_close(out, ref)


@pytest.mark.parametrize("t,hd,out_dtype",
                         [(t, hd, torch.bfloat16) for t, hd in EDGE_SHAPES]
                         + [(1025, 64, torch.float32)])
def test_packed_attention_bwd_kernel_edges(dev, t, hd, out_dtype):
    """The backward at EDGE_SHAPES, and at ViT-L/16@512's T = 1025, where
    the `fused` route's attention stage takes it with fp32 dqkv."""
    b, nh = 1, 2
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16, seed=t + hd)
    do = _rand((b, t, nh * hd), dev, torch.bfloat16, std=0.01, seed=t + hd + 1)
    before = attention.LAUNCHES_BWD
    out = attention.packed_attention_bwd(qkv, do, nh, hd, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_BWD == before + 1 and out.dtype == out_dtype
    ref = attention.packed_attention_bwd_reference(qkv, do, nh, hd, out_dtype=out_dtype)
    if out_dtype == torch.bfloat16:
        _close(out, ref, min_same=MIN_SAME_ATTN_BWD,
               tol=dict(rtol=1.6e-2, atol=1e-2 * float(ref.float().abs().max())))
    else:
        _rel_close(out, ref)


@pytest.mark.parametrize("b,t,nh,hd", [(4, 197, 12, 64), (2, 577, 16, 64),
                                       (2, 257, 16, 104)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_packed_attention_bwd_is_deterministic(dev, b, t, nh, hd, out_dtype):
    """No block sums into another's output: dqkv has the same bits from run
    to run."""
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16, seed=3)
    do = _rand((b, t, nh * hd), dev, torch.bfloat16, std=0.01, seed=4)
    first = attention.packed_attention_bwd(qkv, do, nh, hd, out_dtype=out_dtype)
    for _ in range(3):
        assert torch.equal(attention.packed_attention_bwd(qkv, do, nh, hd,
                                                          out_dtype=out_dtype), first)


def test_packed_attention_bwd_refuses(dev):
    """qkv and dO of two dtypes raise (fp32 ones run on the fp32 kernels:
    test_packed_attention_bwd_fp32_kernel); any T runs (the kernels stream
    their tiles), as JAX's function takes any T."""
    qkv = _rand((1, 8, 3 * 64), dev, torch.bfloat16)
    with pytest.raises(NotImplementedError):
        attention.packed_attention_bwd(qkv.float(), qkv[..., :64].contiguous(), 4, 16)
    before = attention.LAUNCHES_BWD_F32
    attention.packed_attention_bwd(qkv.float(), qkv[..., :64].float(), 4, 16)
    assert attention.LAUNCHES_BWD_F32 == before + 1
    big = _rand((1, 900, 3 * 64), dev, torch.bfloat16)
    do = big[..., :64].contiguous()
    out = attention.packed_attention_bwd(big, do, 1, 64)
    torch.cuda.synchronize()
    ref = attention.packed_attention_bwd_reference(big, do, 1, 64)
    _close(out, ref, min_same=MIN_SAME_ATTN_BWD,
           tol=dict(rtol=1.6e-2, atol=1e-2 * float(ref.float().abs().max())))


# (40, 768, 768): a wgrad over fewer tokens than one split run.
@pytest.mark.parametrize("m,k,n", [(74, 64, 192), (3152, 768, 2304),
                                   (3152, 3072, 768), (33, 40, 24),
                                   (40, 768, 768)] + WIDE_GEMMS)
@pytest.mark.parametrize("form", ["dgrad_bf16", "dgrad_gelu", "wgrad", "fc1"])
def test_grad_gemm_kernels(dev, m, k, n, form):
    """dgrad: dY [m, n] · Wᵀ (W [k, n]); wgrad: Xᵀ [k, m] · dY [m, n]; the
    fc1 recompute: X [m, k] · W2 [k, n] + b with its GELU'd bf16 copy."""
    x = _rand((m, k), dev, torch.bfloat16)
    dy = _rand((m, n), dev, torch.bfloat16, seed=1)
    w = _rand((k, n), dev, torch.bfloat16, std=0.05, seed=2)
    if form == "dgrad_bf16":
        before = linear.LAUNCHES_DGRAD
        out = linear.linear_dgrad(dy, w, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert linear.LAUNCHES_DGRAD == before + 1
        _close(out, linear.linear_dgrad_reference(dy, w, out_dtype=torch.bfloat16))
    elif form == "dgrad_gelu":
        pre = _rand((m, k), dev, seed=3)
        out, out_bf = linear.linear_dgrad(dy, w, gelu_grad_of=pre,
                                          out2_dtype=torch.bfloat16)
        ref, ref_bf = linear.linear_dgrad_reference(dy, w, gelu_grad_of=pre,
                                                    out2_dtype=torch.bfloat16)
        _rel_close(out, ref, 1e-4)
        _close(out_bf, ref_bf)
    elif form == "wgrad":
        before = linear.LAUNCHES_WGRAD
        if k % 8:
            with pytest.raises(ValueError):
                linear.linear_wgrad(x, dy)
            return
        out = linear.linear_wgrad(x, dy)
        torch.cuda.synchronize()
        assert linear.LAUNCHES_WGRAD == before + 1 and out.shape == (k, n)
        _rel_close(out, linear.linear_wgrad_reference(x, dy), 1e-4)
    else:
        b = _rand((n,), dev, std=0.1, seed=4)
        before = linear.LAUNCHES_GELU_PAIR
        pre, hid = linear.fused_linear_with_gelu(x, w, b)
        torch.cuda.synchronize()
        assert linear.LAUNCHES_GELU_PAIR == before + 1
        rpre, rhid = linear.fused_linear_with_gelu_reference(x, w, b)
        _rel_close(pre, rpre, 1e-4)
        _close(hid, rhid)


@pytest.mark.parametrize("k,n", [(768, 768), (3072, 768)])
def test_wgrad_is_deterministic(dev, k, n):
    """The split-K weight gradient at ViT-B's B = 64 (12,608 tokens; out-proj
    all split, fc2 a whole wave and the rest split): the partials are summed
    in a fixed order, so two calls give the same bits."""
    m = 64 * 197
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert linear._wgrad_splits(m, k, n, sms)[1] > 1  # the split path runs
    x = _rand((m, k), dev, torch.bfloat16)
    dy = _rand((m, n), dev, torch.bfloat16, seed=1)
    before = linear.LAUNCHES_WGRAD
    first = linear.linear_wgrad(x, dy)
    second = linear.linear_wgrad(x, dy)
    torch.cuda.synchronize()
    assert linear.LAUNCHES_WGRAD == before + 2
    assert torch.equal(first, second)
    _rel_close(first, linear.linear_wgrad_reference(x, dy), 1e-4)


# The compile-time forms' widths, each at 19 rows (fewer blocks than the
# target, a block's last turn ragged), ViT-B B = 16's tokens and B = 64's
# plus 3 (the target count of blocks, runs of 23 and 24 rows); two widths of
# the general form.
LN_BWD_SHAPES = ([(74, 64), (3152, 768)]
                 + [(r, c) for c in (192, 384, 768, 1024, 1280, 1664)
                    for r in (19, 3152, 12611)]
                 + [(19, 100), (3152, 520)])


@pytest.mark.parametrize("rows,cols", LN_BWD_SHAPES)
@pytest.mark.parametrize("x_dtype,g_dtype,out_dtype", [
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, None, torch.float32)])
def test_layer_norm_bwd_kernel(dev, rows, cols, x_dtype, g_dtype, out_dtype):
    """Within the plain version's tolerances; a second call gives the same
    bits (the partial rows and their sums in an order fixed by the shape)."""
    x = _rand((rows, cols), dev, x_dtype, std=2.0)
    dy = _rand((rows, cols), dev, seed=1)
    w = _rand((cols,), dev, std=0.1, seed=2) + 1.0
    g = None if g_dtype is None else _rand((rows, cols), dev, g_dtype, seed=3)
    before = (layernorm.LAUNCHES_BWD, layernorm.LAUNCHES_COLSUM)
    dx, dw, db = layernorm.layer_norm_bwd(x, dy, w, 1e-6, residual=g,
                                          out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (layernorm.LAUNCHES_BWD, layernorm.LAUNCHES_COLSUM) == (
        before[0] + 1, before[1] + 2)
    rdx, rdw, rdb = layernorm.layer_norm_bwd_reference(
        x, dy, w, 1e-6, residual=g, out_dtype=out_dtype)
    if out_dtype == torch.bfloat16:
        _close(dx, rdx)
    else:
        _rel_close(dx, rdx, 1e-4)
    _rel_close(dw, rdw, 1e-4)
    _rel_close(db, rdb, 1e-4)
    again = layernorm.layer_norm_bwd(x, dy, w, 1e-6, residual=g, out_dtype=out_dtype)
    assert all(torch.equal(a, b) for a, b in zip((dx, dw, db), again))


# One row; the LN backward's partial rows at ViT-B B = 16 (50) and 64 (197)
# and the one-pass limit's neighbours; ViT-B B = 64's tokens (two passes);
# widths that are not whole 16-byte vectors (7, 24), ViT-B's D, 3D and H.
COLSUM_SHAPES = ([(r, c) for r in (1, 50, 63, 64, 65, 197, 12608)
                  for c in (7, 768, 2304, 3072)]
                 + [(256, 768), (257, 768), (3152, 2304), (70, 24)])


@pytest.mark.parametrize("rows,cols", COLSUM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_sum_kernel(dev, rows, cols, dtype):
    x = _rand((rows, cols), dev, dtype)
    before = layernorm.LAUNCHES_COLSUM
    out = layernorm.column_sum(x)
    torch.cuda.synchronize()
    assert layernorm.LAUNCHES_COLSUM == before + 1
    _rel_close(out, layernorm.column_sum_reference(x), 1e-5)
    assert torch.equal(out, layernorm.column_sum(x))  # no atomics


# The blockwise (long-sequence) kernels: the forward's bf16 output as the
# packed forward's, its LSE to fp32 summation order, the backward's dqkv as
# the packed backward's.
LSE_REL = 1e-5
# ... and more (image, head, 64-row tile) units than the card has SMs
# (ViT-L/16@512's heads at B = 4), and T = 1153 with 8 heads of 128.
FLASH_SHAPES = [(2, 1025, 2, 64), (1, 1370, 2, 80), (1, 1337, 1, 64),
                (1, 300, 1, 128), (2, 37, 2, 16), (1, 200, 1, 104),
                (4, 1025, 16, 64), (1, 1153, 8, 128)]


@pytest.mark.parametrize("b,t,nh,hd", FLASH_SHAPES)
@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_attention_fwd_kernel(dev, b, t, nh, hd, return_lse):
    """ViT-L/16@512's T = 1025 at hd 64, ViT-H/14@518's T = 1370 at hd 80,
    JAX's own odd tail (1337), and shorter or wider heads."""
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16)
    counter = "LAUNCHES_FLASH_LSE" if return_lse else "LAUNCHES_FLASH"
    before = getattr(attention, counter)
    out, lse = attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=return_lse)
    torch.cuda.synchronize()
    assert getattr(attention, counter) == before + 1
    ref, ref_lse = attention.blockwise_attention_fwd_reference(
        qkv, nh, hd, return_lse=return_lse)
    _close(out, ref)
    if return_lse:
        assert lse.shape == (b, nh, t) and lse.dtype == torch.float32
        _rel_close(lse, ref_lse, LSE_REL)
    else:
        assert lse is None


@pytest.mark.parametrize("b,t,nh,hd", FLASH_SHAPES)
def test_flash_attention_bwd_kernel(dev, b, t, nh, hd):
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16)
    do = _rand((b, t, nh * hd), dev, torch.bfloat16, seed=1)
    out, lse = attention.blockwise_attention_fwd_reference(qkv, nh, hd,
                                                           return_lse=True)
    before = attention.LAUNCHES_FLASH_BWD
    dqkv = attention.blockwise_attention_bwd(qkv, out, lse, do, nh, hd)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_FLASH_BWD == before + 1 and dqkv.dtype == torch.bfloat16
    ref = attention.blockwise_attention_bwd_reference(qkv, out, lse, do, nh, hd)
    _close(dqkv, ref, min_same=MIN_SAME_ATTN_BWD,
           tol=dict(rtol=1.6e-2, atol=1e-2 * float(ref.float().abs().max())))
    assert torch.equal(dqkv, attention.blockwise_attention_bwd(qkv, out, lse, do,
                                                               nh, hd))  # no atomics


KEY_COUNT_CASES = [(t, kv_len, packing)
                   for t, kv_len in ((200, 197), (264, 257), (1024, 1000), (197, 197))
                   for packing in ("per_head", "slab")
                   if packing == "per_head" or kv_len < t]


@pytest.mark.parametrize("t,kv_len,packing", KEY_COUNT_CASES)
def test_packed_attention_key_count_entry_is_the_single_pass_function(dev, t, kv_len,
                                                                      packing):
    """The packed kernel's entry with a key count and a packing (per-head
    packing, the TP layout; true_seq_len, a padded token axis) gives the
    single-pass kernel's bits on the same strided views of the packed
    buffer, one pass (<= 256 keys) or two, and counts under LAUNCHES."""
    b, nh, hd = 2, 4, 64
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16, seed=t + kv_len)
    before = (attention.LAUNCHES, attention.LAUNCHES_SINGLE)
    out = attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd, packing=packing,
                                           true_seq_len=kv_len)
    torch.cuda.synchronize()
    assert (attention.LAUNCHES, attention.LAUNCHES_SINGLE) == (before[0] + 1, before[1])
    q, k, v = attention._packed_heads(qkv, nh, hd, packing)
    single = attention.single_pass_attention(q, k, v, hd, kv_len=kv_len)
    assert torch.equal(out, single.permute(0, 2, 1, 3).reshape(b, t, nh * hd))
    _close(out, attention.packed_fused_attention_reference(qkv, nh, hd, packing=packing,
                                                            true_seq_len=kv_len))


def test_long_sequences_route_to_the_flash_kernels(dev):
    """Past SINGLE_PASS_MAX_T the packed and the trainable attention launch
    the blockwise kernels and not the packed ones, in bf16 and in fp32 (the
    blockwise kernels' fp32 forms, each against its plain version and the
    same bits over two calls); mixed dtypes raise. In the window of
    849-1024 tokens at hd 64, where JAX keeps the one-shot route and the
    packed kernel's first form ran out of shared memory, the packed kernel
    runs (this test raised there before any kernel took it), and fp32 runs
    on the fp32 slab entry."""
    qkv = _rand((1, 1025, 3 * 64), dev, torch.bfloat16)
    counts = lambda: (attention.LAUNCHES, attention.LAUNCHES_BWD,  # noqa: E731
                      attention.LAUNCHES_FLASH, attention.LAUNCHES_FLASH_LSE,
                      attention.LAUNCHES_FLASH_BWD)
    before = counts()
    with torch.no_grad():
        attention.packed_fused_attention(qkv, num_heads=1, head_dim=64)
    assert counts() == (before[0], before[1], before[2] + 1, *before[3:])
    x = qkv.clone().requires_grad_(True)
    attention.packed_fused_attention_trainable(x, 1, 64).float().sum().backward()
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 1, before[3] + 1,
                        before[4] + 1)
    # fp32: the blockwise kernels' fp32 forms, under their own counts.
    counts32 = lambda: (attention.LAUNCHES_FLASH_F32,  # noqa: E731
                        attention.LAUNCHES_FLASH_LSE_F32, attention.LAUNCHES_FLASH_BWD_F32)
    before, before32 = counts(), counts32()
    q32 = qkv.float()
    with torch.no_grad():
        out32 = attention.packed_fused_attention(q32, num_heads=1, head_dim=64)
        again = attention.packed_fused_attention(q32, num_heads=1, head_dim=64)
    torch.cuda.synchronize()
    assert counts32() == (before32[0] + 2, *before32[1:]) and counts() == before
    assert out32.dtype == torch.float32 and torch.equal(out32, again)
    _rel_close(out32, attention.packed_fused_attention_reference(q32, 1, 64),
               SINGLE_F32_REL)
    x32 = q32.clone().requires_grad_(True)
    cot = _rand((1, 1025, 64), dev, seed=2)
    (attention.packed_fused_attention_trainable(x32, 1, 64) * cot).sum().backward()
    torch.cuda.synchronize()
    assert counts32() == (before32[0] + 2, before32[1] + 1, before32[2] + 1)
    assert counts() == before
    ref_out, ref_lse = attention.blockwise_attention_fwd_reference(q32, 1, 64,
                                                                   return_lse=True)
    _rel_close(x32.grad, attention.blockwise_attention_bwd_reference(
        q32, ref_out, ref_lse, cot, 1, 64), F32_GEMM_REL)
    with pytest.raises(NotImplementedError, match="one dtype"):
        attention.blockwise_attention_bwd(q32, qkv[..., :64],
                                          torch.zeros((1, 1, 1025), device=dev),
                                          qkv[..., :64].float(), 1, 64)
    with pytest.raises(RuntimeError, match="packed_fused_attention_trainable"):
        attention.packed_fused_attention(x, num_heads=1, head_dim=64)
    # The packed route's first form's shared-memory window (849-1024 tokens
    # at hd 64) runs on the packed kernel, which streams its K/V tiles.
    window = _rand((1, 900, 3 * 64), dev, torch.bfloat16)
    launches = (attention.LAUNCHES, attention.LAUNCHES_SINGLE)
    out = attention.packed_fused_attention(window, num_heads=1, head_dim=64)
    torch.cuda.synchronize()
    assert (attention.LAUNCHES, attention.LAUNCHES_SINGLE) == (launches[0] + 1, launches[1])
    _close(out, attention.packed_fused_attention_reference(window, 1, 64))
    before = attention.LAUNCHES_PACKED_F32
    out = attention.packed_fused_attention(window.float(), num_heads=1, head_dim=64)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_PACKED_F32 == before + 1
    _rel_close(out, attention.packed_fused_attention_reference(window.float(), 1, 64),
               SINGLE_F32_REL)


# The single-pass kernel (flash_attention up to T = 1024, and the packed
# route's 849-1024 window): bf16 outputs as the packed forward's; fp32
# outputs (plain FMA, no TF32) within 1e-5 of scale of the plain version's
# library matmuls, another summation order.
SINGLE_F32_REL = 1e-5
SINGLE_SHAPES = [(16, 12, 197, 64), (8, 16, 577, 64), (4, 16, 1024, 64),
                 (2, 3, 37, 16), (1, 2, 200, 104), (1, 2, 130, 128),
                 (1, 1, 1000, 80)]


def _heads_cfg(nh, hd):
    return ViTConfig(name="heads", img_size=16, patch_size=8, embed_dim=nh * hd,
                     depth=1, num_heads=nh, num_classes=2)


@pytest.mark.parametrize("b,nh,t,hd", SINGLE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_single_pass_kernel(dev, b, nh, t, hd, dtype):
    """ViT-B's heads at B = 16, ViT-L/16@384's T = 577, the route's last T
    (1024), and ragged or wide heads."""
    cfg = _heads_cfg(nh, hd)
    q, k, v = (_rand((b, nh, t, hd), dev, dtype, seed=i) for i in range(3))
    before = attention.LAUNCHES_SINGLE
    out = attention.flash_attention(q, k, v, cfg)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_SINGLE == before + 1 and out.dtype == dtype
    ref = attention.flash_attention_reference(q, k, v, cfg)
    if dtype == torch.bfloat16:
        _close(out, ref)
    else:
        _rel_close(out, ref, SINGLE_F32_REL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_single_pass_kernel_masks_keys_past_kv_len(dev, dtype):
    q, k, v = (_rand((2, 2, 150, 64), dev, dtype, seed=i) for i in range(3))
    out = attention.single_pass_attention(q, k, v, 64, kv_len=97)
    ref = attention.single_pass_attention_reference(q, k, v, 64, kv_len=97)
    if dtype == torch.bfloat16:
        _close(out, ref)
    else:
        _rel_close(out, ref, SINGLE_F32_REL)


def test_flash_attention_on_permuted_views(dev):
    """``profile_ops``'s q, k and v: views of a [B, T, 3D] GEMM output with
    row stride 3D, read in place. A view whose rows are not 16-byte aligned
    raises instead of reading the wrong elements."""
    b, t, nh, hd = 4, 197, 12, 64
    cfg = _heads_cfg(nh, hd)
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16)
    q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    out = attention.flash_attention(q, k, v, cfg)
    ref = attention.flash_attention_reference(q, k, v, cfg)
    torch.cuda.synchronize()
    _close(out, ref)
    assert torch.equal(out, attention.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), cfg))
    ragged = _rand((b, nh, t, hd + 4), dev, torch.bfloat16)[..., :hd]
    with pytest.raises(ValueError, match="16-byte"):
        attention.flash_attention(ragged, k, v, cfg)


@pytest.mark.parametrize("b,nh,t,hd", [(2, 2, 1025, 64), (1, 2, 1370, 80)])
def test_flash_attention_blockwise_on_split_heads(dev, b, nh, t, hd):
    """Past T = 1024: row 9's kernel through its strided entry, bit-equal
    to its slab entry on the same values, at each key tile it is built for
    (256 and 512 against their plain versions too, counted by tile), and
    so is its fp32 form on fp32 views; a key tile without an instance
    raises on the card, in either dtype."""
    cfg = _heads_cfg(nh, hd)
    q, k, v = (_rand((b, nh, t, hd), dev, torch.bfloat16, seed=i) for i in range(3))
    qkv = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).reshape(b, t, 3 * nh * hd)
    for bk in attention.FLASH_BLOCK_KS:
        counter = f"LAUNCHES_FLASH_K{bk}"
        before = (attention.LAUNCHES_FLASH_SPLIT, attention.LAUNCHES_SINGLE,
                  getattr(attention, counter))
        out = attention.flash_attention(q, k, v, cfg, block_k=bk)
        torch.cuda.synchronize()
        assert (attention.LAUNCHES_FLASH_SPLIT, attention.LAUNCHES_SINGLE,
                getattr(attention, counter)) == (before[0] + 1, before[1], before[2] + 1)
        _close(out, attention.flash_attention_reference(q, k, v, cfg, block_k=bk))
        slab, _ = attention.blockwise_attention_fwd(qkv.contiguous(), nh, hd, block_k=bk)
        assert torch.equal(out, slab.reshape(b, t, nh, hd).permute(0, 2, 1, 3))
    with pytest.raises(NotImplementedError, match="block_k"):
        attention.flash_attention(q, k, v, cfg, block_k=384)
    q32, k32, v32, qkv32 = (z.float() for z in (q, k, v, qkv))
    for bk in attention.FLASH_BLOCK_KS:
        counter = f"LAUNCHES_FLASH_K{bk}"
        before = (attention.LAUNCHES_FLASH_SPLIT_F32, attention.LAUNCHES_FLASH_SPLIT,
                  getattr(attention, counter))
        out = attention.flash_attention(q32, k32, v32, cfg, block_k=bk)
        torch.cuda.synchronize()
        assert (attention.LAUNCHES_FLASH_SPLIT_F32, attention.LAUNCHES_FLASH_SPLIT,
                getattr(attention, counter)) == (before[0] + 1, before[1], before[2] + 1)
        _rel_close(out, attention.flash_attention_reference(q32, k32, v32, cfg,
                                                            block_k=bk), SINGLE_F32_REL)
        slab, _ = attention.blockwise_attention_fwd(qkv32.contiguous(), nh, hd, block_k=bk)
        assert torch.equal(out, slab.reshape(b, t, nh, hd).permute(0, 2, 1, 3))
    with pytest.raises(NotImplementedError, match="block_k"):
        attention.flash_attention(q32, k32, v32, cfg, block_k=384)


@pytest.mark.parametrize("b,t,nh,hd", FLASH_SHAPES + [(2, 1537, 2, 64), (1, 2049, 2, 128)])
@pytest.mark.parametrize("block_k", [256, 512])
def test_flash_attention_fwd_kernel_key_tiles(dev, b, t, nh, hd, block_k):
    """The 256- and 512-key instances (each step's 128-key tiles taken
    twice: the step's max, then p, the row sums and the step's PV) against
    their plain versions, with and without the LSE and with keys masked
    from kv_len (steps of one live key, tiles wholly masked), under the
    128-key instance's tolerances; the same bits over two runs."""
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16, seed=t + block_k)
    for kv_len in sorted({t, max(1, t - 512), 1, 129}):
        if kv_len > t:
            continue
        out, lse = attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True,
                                                     kv_len=kv_len, block_k=block_k)
        ref, ref_lse = attention.blockwise_attention_fwd_reference(
            qkv, nh, hd, return_lse=True, kv_len=kv_len, block_k=block_k)
        torch.cuda.synchronize()
        _close(out, ref)
        _rel_close(lse, ref_lse, LSE_REL)
        again, again_lse = attention.blockwise_attention_fwd(
            qkv, nh, hd, return_lse=True, kv_len=kv_len, block_k=block_k)
        assert torch.equal(out, again) and torch.equal(lse, again_lse)
    plain, none = attention.blockwise_attention_fwd(qkv, nh, hd, block_k=block_k)
    assert none is None
    _close(plain, attention.blockwise_attention_fwd_reference(qkv, nh, hd,
                                                              block_k=block_k)[0])


@pytest.mark.parametrize("hd", [8, 16, 64, 80, 104, 128])
def test_blockwise_fwd_geometry_matches_the_kernels(dev, hd):
    """The host's copy of the blockwise forward's geometry (shared memory,
    queries a unit, ring stages) against the kernel's own at every key tile
    (the same geometry for all: a longer step takes the same ring twice);
    a key tile without an instance has none."""
    geometry = _build.library().vit_flash_fwd_geometry
    stages, _q_slots, consumers = attention.blockwise_kernel_geometry(hd)
    for bk in attention.FLASH_BLOCK_KS:
        assert geometry(hd, bk, 0) == attention.blockwise_kernel_smem_bytes(hd, bk)
        assert geometry(hd, bk, 1) == consumers * 64
        assert geometry(hd, bk, 2) == stages
        assert attention.blockwise_kernel_smem_bytes(hd, bk) <= attention.MAX_SMEM_BYTES
    assert geometry(hd, 384, 0) == -1


@pytest.mark.parametrize("t", [848, 849, 900, 1024])
def test_packed_attention_window_takes_the_single_pass_kernel(dev, t):
    """At hd 64 the packed kernel's first form ran up to T = 848, and the
    single-pass kernel took 849-1024 on the slabs; the packed kernel now
    takes the whole window itself (the single-pass function, counted under
    LAUNCHES), equal to the single-pass kernel's output on the same slabs."""
    b, nh, hd = 2, 4, 64
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16)
    before = (attention.LAUNCHES, attention.LAUNCHES_SINGLE)
    out = attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd)
    torch.cuda.synchronize()
    assert (attention.LAUNCHES, attention.LAUNCHES_SINGLE) == (before[0] + 1, before[1])
    _close(out, attention.packed_fused_attention_reference(qkv, nh, hd))
    q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    single = attention.single_pass_attention(q, k, v, hd)
    assert torch.equal(out, single.permute(0, 2, 1, 3).reshape(b, t, nh * hd))


# The single-pass attention's Hopper body (shared with the packed kernel):
# key counts about its 64-key chunks and its one-pass limit of 256 keys.
KV_LEN_EDGES = (1, 64, 65, 256, 257)


@pytest.mark.parametrize("kv_len", KV_LEN_EDGES)
@pytest.mark.parametrize("hd", [64, 80])
def test_single_pass_kernel_kv_len_edges(dev, kv_len, hd):
    """Keys at and past kv_len are real data in memory and must be masked:
    one pass up to 256 keys, two past it, at T = 264 (one 64-key chunk more
    than 256)."""
    b, nh, t = 2, 2, 264
    q, k, v = (_rand((b, nh, t, hd), dev, torch.bfloat16, seed=kv_len + i)
               for i in range(3))
    before = attention.LAUNCHES_SINGLE
    out = attention.single_pass_attention(q, k, v, hd, kv_len=kv_len)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_SINGLE == before + 1
    _close(out, attention.single_pass_attention_reference(q, k, v, hd, kv_len=kv_len))


@pytest.mark.parametrize("t", [197, 300])
def test_single_pass_kernel_view_layouts_agree(dev, t):
    """Row 8 reads K and V through maps ordered by stride and q and out
    through their strides: contiguous split heads, the permuted views of a
    [B, T, 3D] GEMM output (the slabs), the same with the context written
    head-major into [B, T, D], and per-head packing give the same bits on
    the same values, and so does row 4's packed kernel (the same body)."""
    b, nh, hd = 2, 4, 64
    bf = torch.bfloat16
    q, k, v = (_rand((b, nh, t, hd), dev, bf, seed=t + i) for i in range(3))
    outs = {"contiguous": attention.single_pass_attention(q, k, v, hd)}
    slab = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).reshape(b, t, 3 * nh * hd)
    slab = slab.contiguous()
    qs, ks, vs = slab.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    outs["permuted"] = attention.single_pass_attention(qs, ks, vs, hd)
    ctx = torch.empty((b, t, nh * hd), dtype=bf, device=dev)
    heads = ctx.view(b, t, nh, hd).permute(0, 2, 1, 3)
    attention.single_pass_attention(qs, ks, vs, hd, out=heads)
    outs["slab, head-major context"] = heads
    per_head = torch.stack([q, k, v], dim=3).permute(0, 2, 1, 3, 4)
    per_head = per_head.reshape(b, t, 3 * nh * hd).contiguous()
    before = (attention.LAUNCHES, attention.LAUNCHES_SINGLE)
    ctx = attention.packed_fused_attention(per_head, num_heads=nh, head_dim=hd,
                                           packing="per_head")
    outs["per_head"] = ctx.view(b, t, nh, hd).permute(0, 2, 1, 3)
    ctx = attention.packed_fused_attention(slab, num_heads=nh, head_dim=hd)
    outs["packed kernel"] = ctx.view(b, t, nh, hd).permute(0, 2, 1, 3)
    torch.cuda.synchronize()
    assert (attention.LAUNCHES, attention.LAUNCHES_SINGLE) == (before[0] + 2, before[1])
    _close(outs["contiguous"], attention.single_pass_attention_reference(q, k, v, hd))
    for name, out in outs.items():
        assert torch.equal(out, outs["contiguous"]), name


# The blockwise forward's edges: T about its 128-key tiles and 128-query
# units (ViT-L/16@512's 1025; 1151, 1152 and 1153 about 9 whole tiles),
# head dims of one 16-wide step, one box and a 16-column tail, two boxes
# with a ragged second and two whole.
BLOCKWISE_EDGE_TS = (1025, 1151, 1152, 1153)
BLOCKWISE_EDGE_HDS = (8, 80, 104, 128)


@pytest.mark.parametrize("t", BLOCKWISE_EDGE_TS)
@pytest.mark.parametrize("hd", BLOCKWISE_EDGE_HDS)
@pytest.mark.parametrize("return_lse", [False, True])
def test_blockwise_fwd_kernel_edges(dev, t, hd, return_lse):
    b, nh = 1, 2
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16, seed=t + hd)
    counter = "LAUNCHES_FLASH_LSE" if return_lse else "LAUNCHES_FLASH"
    before = getattr(attention, counter)
    out, lse = attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=return_lse)
    torch.cuda.synchronize()
    assert getattr(attention, counter) == before + 1
    ref, ref_lse = attention.blockwise_attention_fwd_reference(
        qkv, nh, hd, return_lse=return_lse)
    _close(out, ref)
    if return_lse:
        _rel_close(lse, ref_lse, LSE_REL)


@pytest.mark.parametrize("kv_len", [1, 64, 65, 128, 700, 1025])
def test_blockwise_fwd_kernel_skips_masked_tiles(dev, kv_len):
    """kv_len below T leaves whole 128-key tiles (and the second half of a
    tile) masked: skipped, they move nothing; the keys in [kv_len, T) are
    real data and are masked, not read as zeros."""
    b, nh, hd, t = 2, 2, 64, 1153
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16, seed=kv_len)
    out, lse = attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True,
                                                 kv_len=kv_len)
    ref, ref_lse = attention.blockwise_attention_fwd_reference(
        qkv, nh, hd, return_lse=True, kv_len=kv_len)
    torch.cuda.synchronize()
    _close(out, ref)
    _rel_close(lse, ref_lse, LSE_REL)


def test_attention_kernels_walk_more_units_than_sms(dev):
    """Both persistent grids take their units (image, head, 128 queries) in
    turns when there are more units than SMs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, nh, t, hd = 16, 12, 300, 64
    assert b * nh * -(-t // 128) > sms
    q, k, v = (_rand((b, nh, t, hd), dev, torch.bfloat16, seed=i) for i in range(3))
    _close(attention.single_pass_attention(q, k, v, hd),
           attention.single_pass_attention_reference(q, k, v, hd))
    b, nh, t = 4, 8, 1153
    assert b * nh * -(-t // 128) > sms
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16, seed=3)
    out, lse = attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True)
    ref, ref_lse = attention.blockwise_attention_fwd_reference(qkv, nh, hd,
                                                               return_lse=True)
    torch.cuda.synchronize()
    _close(out, ref)
    _rel_close(lse, ref_lse, LSE_REL)


def test_rows_8_and_9_give_the_same_bits_every_run(dev):
    """No atomics and a fixed order of every sum: the single-pass attention
    and the blockwise forward (slabs with the LSE, and split heads) repeat
    their bits."""
    b, nh, hd = 4, 12, 64
    q, k, v = (_rand((b, nh, 577, hd), dev, torch.bfloat16, seed=i) for i in range(3))
    first = attention.single_pass_attention(q, k, v, hd, kv_len=500)
    qkv = _rand((b, 1153, 3 * nh * hd), dev, torch.bfloat16, seed=7)
    out, lse = attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True)
    qh, kh, vh = qkv.reshape(b, 1153, 3, nh, hd).permute(2, 0, 3, 1, 4)
    split = attention.flash_attention(qh, kh, vh, _heads_cfg(nh, hd))
    for _ in range(3):
        assert torch.equal(first, attention.single_pass_attention(q, k, v, hd, kv_len=500))
        again, again_lse = attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True)
        assert torch.equal(out, again) and torch.equal(lse, again_lse)
        assert torch.equal(split, attention.flash_attention(qh, kh, vh, _heads_cfg(nh, hd)))


@pytest.mark.parametrize("rows,cols", [(74, 64), (3152, 768), (197, 1000)])
@pytest.mark.parametrize("x_dtype,r_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_residual_layer_norm_kernel(dev, rows, cols, x_dtype, r_dtype):
    """``summed`` is the fp32 sum rounded once: bit-identical; the
    normalised output as the LN kernel's."""
    x = _rand((rows, cols), dev, x_dtype, std=2.0)
    r = _rand((rows, cols), dev, r_dtype, std=2.0, seed=3)
    w = (_rand((cols,), dev, std=0.1, seed=1) + 1.0).to(x_dtype)
    b = _rand((cols,), dev, std=0.1, seed=2).to(x_dtype)
    before = layernorm.LAUNCHES_RESIDUAL
    out, summed = layernorm.residual_layer_norm(x, r, w, b, 1e-6)
    torch.cuda.synchronize()
    assert layernorm.LAUNCHES_RESIDUAL == before + 1
    assert out.dtype == summed.dtype == x_dtype
    ref_out, ref_sum = layernorm.residual_layer_norm_reference(x, r, w, b, 1e-6)
    assert torch.equal(summed, ref_sum)
    _close(out, ref_out)


def _train_layer(cfg, dev, seed=5):
    params = vit.stack_params(fixtures.random_params(cfg, seed=seed), cfg,
                              param_dtype=torch.float32, device=dev)
    return {k: v[0] for k, v in params["layers"].items()}


@pytest.mark.parametrize("d,nh,t", [(64, 4, 37), (192, 3, 197)])
def test_fused_backward_stages(dev, d, nh, t):
    cfg = ViTConfig(name="bwd", img_size=32, patch_size=8, embed_dim=d,
                    depth=1, num_heads=nh, num_classes=9)
    lp = _train_layer(cfg, dev)
    x = _rand((2, t, d), dev, torch.bfloat16, std=0.5, seed=6)
    dout = _rand((2, t, d), dev, torch.bfloat16, std=0.1, seed=7)
    before = (fused_block.LAUNCHES_BWD, fused_block.LAUNCHES_BWD_X2,
              fused_block.LAUNCHES_BWD_MLP, fused_block.LAUNCHES_BWD_ATTN)
    dx, dlp = fused_block.fused_encoder_layer_bwd(x, lp, dout, cfg)
    torch.cuda.synchronize()
    assert (fused_block.LAUNCHES_BWD, fused_block.LAUNCHES_BWD_X2,
            fused_block.LAUNCHES_BWD_MLP, fused_block.LAUNCHES_BWD_ATTN) == tuple(
                c + 1 for c in before)
    rdx, rdlp = fused_block.fused_encoder_layer_bwd_reference(x, lp, dout, cfg)
    _close(dx, rdx, min_same=MIN_SAME_CHAIN)
    for key in rdlp:
        assert dlp[key].dtype == torch.float32
        _rel_close(dlp[key], rdlp[key], 2e-2)


@pytest.mark.parametrize("d,nh,t", [(192, 3, 197), (1024, 16, 577)])
def test_chunked_mlp_stages(dev, d, nh, t):
    """The light and wgrad stages against their plain versions, and the two
    together equal to the mono stage on the card (the same kernels on the
    same values)."""
    cfg = ViTConfig(name="bwd", img_size=32, patch_size=8, embed_dim=d,
                    depth=1, num_heads=nh, num_classes=9)
    lp = _train_layer(cfg, dev)
    x2 = _rand((1, t, d), dev, std=0.5, seed=6)
    dout = _rand((1, t, d), dev, torch.bfloat16, std=0.1, seed=7)
    before = (fused_block.LAUNCHES_BWD_MLP_LIGHT, fused_block.LAUNCHES_BWD_MLP_WGRAD)
    dx2, hid, dhp, small = fused_block.fused_bwd_stage_mlp_light(x2, dout, lp, cfg)
    dfc1, dfc2 = fused_block.fused_bwd_stage_mlp_wgrad(x2, dout, hid, dhp, lp, cfg,
                                                       mlp_chunks=2)
    torch.cuda.synchronize()
    assert (fused_block.LAUNCHES_BWD_MLP_LIGHT,
            fused_block.LAUNCHES_BWD_MLP_WGRAD) == (before[0] + 1, before[1] + 1)
    assert hid.shape == dhp.shape == (1, t, cfg.hidden_dim)
    assert dfc1.shape == (1, d, cfg.hidden_dim) and dfc2.shape == (1, cfg.hidden_dim, d)
    rdx2, rhid, rdhp, rsmall = fused_block.fused_bwd_stage_mlp_light_reference(
        x2, dout, lp, cfg)
    _rel_close(dx2, rdx2, 2e-2)
    _close(hid, rhid)
    _close(dhp, rdhp)
    for key in rsmall:
        _rel_close(small[key], rsmall[key], 2e-2)
    # The wgrad stage recomputes h2c with the LN kernel: a bf16 flip there
    # moves a row of dfc1's summands (1.6e-4 of scale at D = 1024).
    rw = fused_block.fused_bwd_stage_mlp_wgrad_reference(x2, dout, hid, dhp, lp, cfg)
    _rel_close(dfc1, rw[0])
    _rel_close(dfc2, rw[1])
    mdx2, mono = fused_block.fused_bwd_stage_mlp_mono(x2, dout, lp, cfg)
    assert torch.equal(dx2, mdx2)
    assert torch.equal(dfc1, mono["fc1_w"]) and torch.equal(dfc2, mono["fc2_w"])
    assert all(torch.equal(small[k], mono[k]) for k in small)


def test_fused_layer_bwd_at_vit_l_width(dev):
    """One ViT-L/16@384-width layer backward (D = 1024, 16 heads, H = 4096,
    T = 577): its own H-chunk count routes the MLP stage to light → wgrad."""
    cfg = ViTConfig(name="bwd_l", img_size=384, patch_size=16, embed_dim=1024,
                    depth=1, num_heads=16, num_classes=9)
    assert fused_block._pick_mlp_chunks(1024, 4096, 2) == 2
    lp = _train_layer(cfg, dev)
    x = _rand((2, 577, 1024), dev, torch.bfloat16, std=0.5, seed=6)
    dout = _rand((2, 577, 1024), dev, torch.bfloat16, std=0.1, seed=7)
    names = ("LAUNCHES_BWD", "LAUNCHES_BWD_MLP", "LAUNCHES_BWD_MLP_LIGHT",
             "LAUNCHES_BWD_MLP_WGRAD", "LAUNCHES_BWD_ATTN")
    before = [getattr(fused_block, n) for n in names]
    dx, dlp = fused_block.fused_encoder_layer_bwd(x, lp, dout, cfg)
    torch.cuda.synchronize()
    assert [getattr(fused_block, n) - b for n, b in zip(names, before)] == [1, 0, 1, 1, 1]
    rdx, rdlp = fused_block.fused_encoder_layer_bwd_reference(x, lp, dout, cfg)
    _close(dx, rdx, min_same=MIN_SAME_CHAIN)
    for key in rdlp:
        assert dlp[key].dtype == torch.float32
        _rel_close(dlp[key], rdlp[key], 2e-2)


def test_fused_layer_trainable_on_card(dev):
    cfg = ViTConfig(name="bwd", img_size=32, patch_size=8, embed_dim=64,
                    depth=1, num_heads=4, num_classes=9)
    lp = {k: v.requires_grad_(True) for k, v in _train_layer(cfg, dev).items()}
    x = _rand((2, cfg.num_tokens, 64), dev, torch.bfloat16, std=0.5, seed=6)
    x.requires_grad_(True)
    out = fused_block.fused_encoder_layer_trainable(x, lp, cfg)
    out.float().square().sum().backward()
    assert x.grad is not None and all(v.grad is not None for v in lp.values())
    ref_dx, ref = fused_block.fused_encoder_layer_bwd_reference(
        x.detach(), {k: v.detach() for k, v in lp.items()},
        (2 * out.float()).to(torch.bfloat16).detach(), cfg)
    _close(x.grad, ref_dx, min_same=MIN_SAME_CHAIN)
    for key, v in lp.items():
        _rel_close(v.grad, ref[key], 2e-2)


def test_inference_wrappers_refuse_autograd_on_card(dev):
    """A kernel's result carries no graph: under autograd with a tensor that
    requires grad the wrappers raise; inference_mode and no_grad run."""
    cfg = ViTConfig(name="guard", img_size=32, patch_size=8, embed_dim=64,
                    depth=1, num_heads=4, num_classes=9)
    lp = _train_layer(cfg, dev)
    x = _rand((2, cfg.num_tokens, 64), dev, torch.bfloat16)
    w = lp["ln1_w"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="trainable"):
        layernorm.layer_norm(x, w, lp["ln1_b"])
    xr = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_encoder_layer_trainable"):
        fused_block.fused_encoder_layer(xr, lp, cfg)
    qkv = _rand((2, 17, 192), dev, torch.bfloat16).requires_grad_(True)
    with pytest.raises(RuntimeError, match="packed_fused_attention_trainable"):
        attention.packed_fused_attention(qkv, num_heads=4, head_dim=16)
    with torch.inference_mode():
        layernorm.layer_norm(x, w, lp["ln1_b"])
        fused_block.fused_encoder_layer(xr, lp, cfg)
    with torch.no_grad():
        attention.packed_fused_attention(qkv, num_heads=4, head_dim=16)
    q = _rand((2, 4, 17, 16), dev, torch.bfloat16).requires_grad_(True)
    with pytest.raises(RuntimeError, match="packed_fused_attention_trainable"):
        attention.flash_attention(q, q, q, cfg)
    with pytest.raises(RuntimeError, match="trainable"):
        layernorm.residual_layer_norm(x, x, w, lp["ln1_b"])
    with torch.no_grad():
        attention.flash_attention(q, q, q, cfg)
        layernorm.residual_layer_norm(x, x, w, lp["ln1_b"])


# The step test's configs: (config, batch, {route: {counter: launches of
# one step}}). At T = 17 both routes run the packed backward once a layer,
# and `fused` its layer backward too. At T = 1025 (256-pixel images at patch
# 8) `flash` runs the blockwise forward with its LSE and the blockwise
# backward a layer, `fused` the blockwise forward three times a layer (the
# chain and the two recomputes) and the streamed packed backward once.
STEP_CASES = {
    "t17": (ViTConfig(name="step", img_size=32, patch_size=8, embed_dim=192,
                      depth=2, num_heads=3, num_classes=10), 4,
            {"flash": {"attention.LAUNCHES_BWD": 2, "fused_block.LAUNCHES_BWD": 0},
             "fused": {"attention.LAUNCHES_BWD": 2, "fused_block.LAUNCHES_BWD": 2}}),
    "t1025": (ViTConfig(name="long_step", img_size=256, patch_size=8,
                        embed_dim=128, depth=2, num_heads=2, num_classes=10), 2,
              {"flash": {"attention.LAUNCHES": 0, "attention.LAUNCHES_BWD": 0,
                         "attention.LAUNCHES_FLASH": 0,
                         "attention.LAUNCHES_FLASH_LSE": 2,
                         "attention.LAUNCHES_FLASH_BWD": 2},
               "fused": {"attention.LAUNCHES": 0, "attention.LAUNCHES_BWD": 2,
                         "attention.LAUNCHES_FLASH": 6,
                         "attention.LAUNCHES_FLASH_LSE": 0,
                         "attention.LAUNCHES_FLASH_BWD": 0}}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("route", ["flash", "fused"])
def test_train_step_on_card_matches_plain_links(dev, route, case, monkeypatch):
    """One bf16 AdamW step through the kernels, with its launch counts,
    against the same step with every link swapped for its plain version."""
    from vit_with_opencl_tpu_torch.parallel import spmd

    cfg, batch, launches = STEP_CASES[case]
    images = torch.from_numpy(fixtures.random_images(cfg, n=batch, seed=1)).to(dev)
    labels = torch.arange(batch, device=dev)
    modules = {"attention": attention, "fused_block": fused_block}

    def count(key):
        module, name = key.split(".")
        return getattr(modules[module], name)

    def run():
        params = vit.stack_params(fixtures.random_params(cfg, seed=2), cfg,
                                  param_dtype=torch.float32, device=dev)
        init, step = spmd.make_train_step(cfg, device=dev, lr=1e-3,
                                          compute_dtype=torch.bfloat16,
                                          optimizer="adamw",
                                          attention_impl=route)
        state = init(params)
        params, state, loss = step(params, state, images, labels)
        return float(loss), state["mu"]

    before = {key: count(key) for key in launches[route]}
    loss, mu = run()
    torch.cuda.synchronize()
    assert {key: count(key) - n for key, n in before.items()} == launches[route]
    for name in ("packed_fused_attention", "packed_attention_bwd",
                 "blockwise_attention_fwd", "blockwise_attention_bwd"):
        monkeypatch.setattr(attention, name, getattr(attention, name + "_reference"))
    for name in ("fused_encoder_layer", "fused_encoder_layer_bwd"):
        monkeypatch.setattr(fused_block, name, getattr(fused_block, name + "_reference"))
    plain_loss, plain_mu = run()
    assert abs(loss - plain_loss) <= 1e-3 * abs(plain_loss)
    for key in ("qkv_w", "fc1_w"):
        _rel_close(mu["layers"][key], plain_mu["layers"][key], 5e-2)


# The ring step kernel (row 10, ``blockwise_ring_step``): its outputs are
# fp32. m and l: the same scores and sums in another order (1e-5 of
# scale). acc: at fp32 the same; at bf16 a score an ulp off the plain
# version's may round its p the other way, moving that term by a bf16 ulp
# (2^-8 of the largest term, well inside 2e-3 of acc's scale).
RING_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
# (n, t_loc, hd, block_k, masked keys): ViT-L/16@512 on 4 shards (257, the
# last shard's 3 padded keys) and 8 shards (129), ViT-B on one shard (197),
# ViT-H/14@518 on 4 shards (343, hd 80), two 512-key blocks (1024), and
# ViT-G's and the widest head dims (the 257-key shard at hd 128 too: the
# bf16 kernel's two-consumer form and the fp32 body's widest PV tile), and
# two ragged 129-key blocks (the bf16 kernel's 8-key tail chunk, whose tile
# holds the next block's keys).
RING_SHAPES = [(64, 257, 64, 257, 3), (32, 129, 64, 129, 7), (48, 197, 64, 197, 0),
               (16, 343, 80, 343, 1), (4, 1024, 64, 512, 0), (8, 96, 104, 48, 5),
               (4, 200, 128, 100, 0), (3, 37, 16, 37, 2), (8, 257, 128, 257, 3),
               (6, 258, 64, 129, 4)]


def _ring_inputs(dev, n, t_loc, hd, dtype, masked, seed=0):
    q, k, v = (_rand((n, t_loc, hd), dev, dtype, seed=seed + i) for i in range(3))
    bias = torch.zeros((1, t_loc), device=dev)
    if masked:
        bias[:, t_loc - masked:] = attention.MASK_VALUE
    return q, k, v, bias


def _ring_close(got, want, dtype):
    for g, w, name in zip(got, want, ("m", "l", "acc")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        rel = RING_REL[dtype] if name == "acc" else 1e-5
        _rel_close(g, w, rel)


@pytest.mark.parametrize("n,t_loc,hd,block,masked", RING_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_step_kernel(dev, n, t_loc, hd, block, masked, dtype):
    """The first rotation from (-inf, 0, 0), then 4 rotations chained (each
    side carrying its own state) against the plain version."""
    state = (torch.full((n, t_loc), -float("inf"), device=dev),
             torch.zeros((n, t_loc), device=dev),
             torch.zeros((n, t_loc, hd), device=dev))
    kernel_state, plain_state = state, state
    kw = dict(scale=float(1.0 / np.sqrt(hd)), block_q=block, block_k=block)
    for rotation in range(4):
        q, k, v, bias = _ring_inputs(dev, n, t_loc, hd, dtype,
                                     masked if rotation == 3 else 0, seed=3 * rotation)
        before = attention.LAUNCHES_RING
        kernel_state = attention.blockwise_ring_step(q, k, v, bias, *kernel_state, **kw)
        torch.cuda.synchronize()
        assert attention.LAUNCHES_RING == before + 1
        plain_state = attention.blockwise_ring_step_reference(q, k, v, bias,
                                                              *plain_state, **kw)
        _ring_close(kernel_state, plain_state, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_step_kernel_wipes_a_masked_first_block(dev, dtype):
    """A row whose first block is all masked gets m' near MASK_VALUE and
    counts its masked keys as ones, as JAX's kernel does; the next live
    block wipes that out with a = 0."""
    n, t_loc, hd = 4, 129, 64
    q, k, v, bias = _ring_inputs(dev, n, t_loc, hd, dtype, masked=t_loc)
    state = (torch.full((n, t_loc), -float("inf"), device=dev),
             torch.zeros((n, t_loc), device=dev), torch.zeros((n, t_loc, hd), device=dev))
    kw = dict(scale=0.125, block_q=t_loc, block_k=t_loc)
    got = attention.blockwise_ring_step(q, k, v, bias, *state, **kw)
    want = attention.blockwise_ring_step_reference(q, k, v, bias, *state, **kw)
    _ring_close(got, want, dtype)
    assert float(got[0].max()) < -1e38 and torch.equal(got[1], want[1])
    q2, k2, v2, live = _ring_inputs(dev, n, t_loc, hd, dtype, masked=0, seed=5)
    _ring_close(attention.blockwise_ring_step(q, k2, v2, live, *got, **kw),
                attention.blockwise_ring_step_reference(q, k2, v2, live, *want, **kw),
                dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_8_and_10_give_the_same_bits_over_two_calls(dev, dtype):
    """No atomics and a fixed order of every sum: the ring step (the bf16
    kernel's units sharing K/V tiles, the fp32 body) at whole-shard blocks
    with and without a ragged tail, two key blocks and both consumer forms,
    from a carried state, and the
    single-pass attention's fp32 form on the permuted views of a packed
    buffer with a key count, repeat their bits."""
    for n, t_loc, hd, block, masked in ((64, 257, 64, 257, 3), (16, 343, 80, 343, 2),
                                        (8, 1024, 128, 512, 0), (12, 96, 64, 96, 1)):
        q, k, v, bias = _ring_inputs(dev, n, t_loc, hd, dtype, masked, seed=t_loc)
        state = (_rand((n, t_loc), dev, seed=1), _rand((n, t_loc), dev, seed=2).abs() + 1,
                 _rand((n, t_loc, hd), dev, seed=3))
        kw = dict(scale=float(1.0 / np.sqrt(hd)), block_q=block, block_k=block)
        first = attention.blockwise_ring_step(q, k, v, bias, *state, **kw)
        for _ in range(2):
            again = attention.blockwise_ring_step(q, k, v, bias, *state, **kw)
            assert all(torch.equal(a, b) for a, b in zip(first, again)), (n, t_loc, hd)
        _ring_close(first, attention.blockwise_ring_step_reference(q, k, v, bias, *state,
                                                                   **kw), dtype)
    if dtype == torch.float32:
        b, t, nh, hd = 4, 197, 12, 64
        qkv = _rand((b, t, 3 * nh * hd), dev, dtype, seed=7)
        qs, ks, vs = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        first = attention.single_pass_attention(qs, ks, vs, hd, kv_len=190)
        for _ in range(2):
            assert torch.equal(first, attention.single_pass_attention(qs, ks, vs, hd,
                                                                      kv_len=190))
        _rel_close(first, attention.single_pass_attention_reference(qs, ks, vs, hd,
                                                                     kv_len=190),
                   SINGLE_F32_REL)


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_ring_and_f32_geometry_match_the_kernels(dev, hd):
    """The host's copies of the kernels' geometry, which the CPU tests hold
    to the card's limits, are the kernels' own: the bf16 ring step's shared
    memory and queries a unit, and the fp32 body's shared memory."""
    geometry = _build.library().vit_ring_step_geometry
    assert geometry(hd, 0) == attention.ring_kernel_smem_bytes(hd)
    queries = geometry(hd, 1)
    assert attention.ring_kernel_units(1, queries, hd) == 1
    assert attention.ring_kernel_units(1, queries + 1, hd) == 2
    assert geometry(hd, 2) == attention.f32_attention_smem_bytes(hd)


def test_ring_step_kernel_refusals(dev):
    """Head dims the kernel does not take, blocks that do not divide t_loc,
    other dtypes and tensors under autograd raise; nothing falls back."""
    q, k, v, bias = _ring_inputs(dev, 2, 64, 64, torch.bfloat16, 0)
    state = (torch.full((2, 64), -float("inf"), device=dev),
             torch.zeros((2, 64), device=dev), torch.zeros((2, 64, 64), device=dev))
    with pytest.raises(ValueError, match="must divide"):
        attention.blockwise_ring_step(q, k, v, bias, *state, scale=0.1,
                                      block_q=64, block_k=48)
    with pytest.raises(NotImplementedError, match="bf16 or fp32"):
        attention.blockwise_ring_step(q.half(), k.half(), v.half(), bias, *state,
                                      scale=0.1, block_q=64, block_k=64)
    q12, k12, v12, _ = _ring_inputs(dev, 2, 64, 12, torch.bfloat16, 0)
    with pytest.raises(NotImplementedError, match="head_dim"):
        attention.blockwise_ring_step(q12, k12, v12, bias, state[0], state[1],
                                      torch.zeros((2, 64, 12), device=dev),
                                      scale=0.1, block_q=64, block_k=64)
    with pytest.raises(RuntimeError, match="einsum"):
        attention.blockwise_ring_step(q.float().requires_grad_(True), k.float(),
                                      v.float(), bias, *state, scale=0.1,
                                      block_q=64, block_k=64)


def test_ring_attention_on_a_virtual_mesh_of_the_card(dev):
    """ring_attention over 4 shards of one card: a 4-step ring, one kernel
    launch a shard a step, against the same ring on the CPU's plain steps."""
    from vit_with_opencl_tpu_torch.ops import ring_attention
    from vit_with_opencl_tpu_torch.parallel.mesh import Mesh

    cfg = _heads_cfg(2, 64)
    q, k, v = (_rand((2, 2, 1025, 64), dev, torch.bfloat16, seed=i) for i in range(3))
    before = attention.LAUNCHES_RING
    out = ring_attention.ring_attention(q, k, v, cfg, Mesh([dev] * 4, ("model",)))
    torch.cuda.synchronize()
    assert attention.LAUNCHES_RING == before + 16
    ref = ring_attention.ring_attention(q.cpu(), k.cpu(), v.cpu(), cfg,
                                        Mesh(["cpu"] * 4, ("model",)))
    _close(out.cpu(), ref)


@pytest.mark.parametrize("t,seq", [(200, 197), (1028, 1025), (64, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_attention_per_head_and_true_seq_len(dev, t, seq, dtype):
    """Per-head packing and true_seq_len on the card: up to padded T = 1024
    the packed kernel's key-count entry in bf16 (the single-pass kernel on
    strided views with kv_len in fp32), past it (slab packing) the blockwise
    kernel with its kv_len (its fp32 form in fp32, the same bits over two
    calls); per-head packing past 1024 raises."""
    b, nh, hd = 2, 4, 64
    qkv = _rand((b, t, 3 * nh * hd), dev, dtype)
    long_seq = attention._is_long_seq(t)
    for packing in ("per_head", "slab"):
        if long_seq and packing == "per_head":
            with pytest.raises(NotImplementedError, match="slab packing only"):
                attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd,
                                                 packing=packing, true_seq_len=seq)
            continue
        if not long_seq and packing == "slab" and seq == t and dtype == torch.float32:
            continue  # the packed kernel takes bf16 only (unchanged)
        before = (attention.LAUNCHES_SINGLE, attention.LAUNCHES_FLASH, attention.LAUNCHES,
                  attention.LAUNCHES_FLASH_F32)
        out = attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd,
                                               packing=packing, true_seq_len=seq)
        torch.cuda.synchronize()
        if long_seq and dtype == torch.float32:
            assert (attention.LAUNCHES_FLASH, attention.LAUNCHES_FLASH_F32) == (
                before[1], before[3] + 1)
            assert torch.equal(out, attention.packed_fused_attention(
                qkv, num_heads=nh, head_dim=hd, packing=packing, true_seq_len=seq))
        elif long_seq:
            assert attention.LAUNCHES_FLASH == before[1] + 1
        elif dtype == torch.float32:
            assert attention.LAUNCHES_SINGLE == before[0] + 1
        else:
            assert (attention.LAUNCHES, attention.LAUNCHES_SINGLE) == (before[2] + 1, before[0])
        ref = attention.packed_fused_attention_reference(
            qkv, nh, hd, packing=packing, true_seq_len=seq)
        if dtype == torch.bfloat16:
            _close(out, ref)
        else:
            _rel_close(out, ref, SINGLE_F32_REL)


@pytest.fixture
def cards(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more NVIDIA cards")
    return [torch.device("cuda", i) for i in range(n)]


def test_kernels_launch_on_the_cards_of_their_tensors(cards):
    """With cuda:0 current and a side stream current on another card,
    wrappers given tensors on that card launch there, on the side stream,
    after the op that wrote their inputs: a ring step, a layer norm, a GEMM
    that opts into more than 48 KB of shared memory and the single-pass
    attention, each against its plain version. (A launch from cuda:0 onto
    another card's stream fails: the check is not left to a race.)"""
    other = cards[-1]
    side = torch.cuda.Stream(other)
    with torch.cuda.stream(side), torch.cuda.device(cards[0]):
        assert torch.cuda.current_device() == cards[0].index
        assert torch.cuda.current_stream(other) == side
        n, t_loc, hd = 64, 257, 64
        q, k, v, bias = _ring_inputs(other, n, t_loc, hd, torch.bfloat16, 3)
        q = (q.float() * 2).to(torch.bfloat16)  # written on the side stream
        state = (torch.full((n, t_loc), -float("inf"), device=other),
                 torch.zeros((n, t_loc), device=other),
                 torch.zeros((n, t_loc, hd), device=other))
        kw = dict(scale=0.125, block_q=t_loc, block_k=t_loc)
        got = attention.blockwise_ring_step(q, k, v, bias, *state, **kw)
        assert got[2].device == other
        _ring_close(got, attention.blockwise_ring_step_reference(q, k, v, bias,
                                                                 *state, **kw),
                    torch.bfloat16)
        x = _rand((3152, 768), other, torch.bfloat16, std=2.0)
        lw = _rand((768,), other, std=0.1, seed=1) + 1.0
        lb = _rand((768,), other, std=0.1, seed=2)
        _close(layernorm.layer_norm(x, lw, lb, 1e-6),
               layernorm.layer_norm_reference(x, lw, lb, 1e-6))
        w = _rand((768, 2304), other, torch.bfloat16, std=0.05, seed=3)
        _close(linear.fused_linear(x, w, lb.repeat(3)),
               linear.fused_linear_reference(x, w, lb.repeat(3)))
        qs, ks, vs = (_rand((4, 12, 197, 64), other, torch.bfloat16, seed=i)
                      for i in range(3))
        _close(attention.single_pass_attention(qs, ks, vs, 64),
               attention.single_pass_attention_reference(qs, ks, vs, 64))
        assert torch.cuda.current_device() == cards[0].index


def test_mesh_paths_across_cards(cards):
    """The mesh paths over every card give what the same paths give on a
    virtual mesh of cuda:0: sp_forward with the ring kernel (t_loc >= 128
    at 4 or 2 shards), tp_forward and sp_tp_forward with the single-pass
    kernel, and DataParallelEngine against the one-card engine."""
    from vit_with_opencl_tpu_torch.engine import DataParallelEngine, InferenceEngine
    from vit_with_opencl_tpu_torch.parallel import spmd

    s = 4 if len(cards) >= 4 else 2
    cfg = ViTConfig(name="mesh", img_size=224, patch_size=8, embed_dim=256,
                    depth=2, num_heads=4, num_classes=10)
    named = fixtures.random_params(cfg, seed=0, scale=0.05)
    x = torch.from_numpy(fixtures.random_images(cfg, n=4, seed=1)).to(cards[0])
    real = spmd.make_mesh(1, s, devices=cards)
    virtual = spmd.make_mesh(1, s, devices=[cards[0]] * s)
    stacked = vit.stack_params(named, cfg, param_dtype=torch.bfloat16,
                               device=cards[0])
    reps = spmd.replicate_params(stacked, real)
    assert set(reps) == set(cards[:s])
    before = attention.LAUNCHES_RING
    got = spmd.sp_forward(x, reps, cfg, real, compute_dtype=torch.bfloat16, kv="ring")
    torch.cuda.synchronize()
    assert attention.LAUNCHES_RING == before + cfg.depth * s * s
    want = spmd.sp_forward(x, stacked, cfg, virtual, compute_dtype=torch.bfloat16,
                           kv="ring")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    for fwd in (spmd.tp_forward, spmd.sp_tp_forward):
        got = fwd(x, spmd.shard_params_tp(stacked, real, cfg), cfg, real,
                  attention_impl="flash")
        want = fwd(x, spmd.shard_params_tp(stacked, virtual, cfg), cfg, virtual,
                   attention_impl="flash")
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    images = fixtures.random_images(cfg, n=len(cards) * 2, seed=2)
    dp = DataParallelEngine(cfg, named, batch_size=len(cards) * 2, devices=cards,
                            attention_impl="flash")
    one = InferenceEngine(cfg, named, batch_size=2, attention_impl="flash",
                          device=cards[0])
    np.testing.assert_allclose(dp.run(images), one.run(images), rtol=0, atol=1e-6)


# The overlap probe's kernels (csrc/probe_overlap.cu) against their plain
# versions at a grid of 1 to 4 blocks and N = 128, 256 and 3072, on the
# probe's own data (degenerate: every row of x alike, xq constant along each
# row, w along N) and on seeded random data, w stored K-major (what the GEMM
# kernels' int8 wgmma reads). The int8 values, the scales, the stream's
# output and the GEMMs' bf16 outputs are bit-identical; the LN's bf16
# outputs are within one bf16 ulp (near 0, one fp32 ulp of their unit
# scale) and 99% identical; a second call gives the same bits.
PROBE_FORMS = ("stream", "vpu:q", "vpu:ln", "mxu", "fused", "indep:q", "indep:ln")


def _probe_data(dev, kind: str, grid: int, n: int, seed: int = 0) -> dict:
    from vit_with_opencl_tpu_torch.scripts import probe_w8a8_overlap as probe

    rows = grid * probe.M_BLOCK
    if kind == "probe":
        assert probe.N == n  # main()'s weights are N wide
        w, sw = probe.weights(dev)
        return dict(xf=probe._x_f32(rows, 7, dev), xq=probe._x_i8(rows, 11, dev),
                    w=w, sw=sw)
    rng = np.random.default_rng(seed)
    d = {key: torch.from_numpy(v).to(dev) for key, v in dict(
        xf=rng.normal(0.0, 2.0, (rows, probe.K)).astype(np.float32),
        xq=rng.integers(-127, 128, (rows, probe.K)).astype(np.int8),
        w=rng.integers(-127, 128, (probe.K, n)).astype(np.int8),
        sw=rng.uniform(1e-4, 1e-3, (1, n)).astype(np.float32)).items()}
    return dict(d, w=probe.k_major(d["w"]))


def _probe_run(form: str, d: dict, reference: bool):
    from vit_with_opencl_tpu_torch.scripts import probe_w8a8_overlap as probe

    return probe.run(form, d, plain=reference)


def _probe_close(form: str, outs, refs) -> None:
    for i, (out, ref) in enumerate(zip(outs, refs)):
        assert out.shape == ref.shape and out.dtype == ref.dtype, (form, i)
        if form.endswith("ln") and i == 0:
            o, r = out.float(), ref.float()
            _, exp = torch.frexp(r.abs())
            ulp = torch.clamp_min(torch.ldexp(torch.ones_like(r), exp - 8),
                                  2.0 ** -23)
            assert bool(((o - r).abs() <= ulp).all()), float((o - r).abs().max())
            assert float((o == r).float().mean()) >= MIN_SAME_KERNEL
        else:
            assert torch.equal(out, ref), (form, i)


@pytest.mark.parametrize("kind", ["probe", "random"])
@pytest.mark.parametrize("grid,n", [(2, 256)] + [(g, n) for g in (1, 3, 4)
                                                  for n in (128, 256, 3072)])
@pytest.mark.parametrize("form", PROBE_FORMS)
def test_probe_kernel(dev, form, grid, n, kind, monkeypatch):
    from vit_with_opencl_tpu_torch.scripts import probe_w8a8_overlap as probe

    monkeypatch.setattr(probe, "N", n)
    d = _probe_data(dev, kind, grid, n)
    counter = probe.FORMS[form].counter
    before = getattr(probe, counter)
    outs = _probe_run(form, d, reference=False)
    torch.cuda.synchronize()
    assert all(o.is_cuda for o in outs)
    assert getattr(probe, counter) == before + 1
    _probe_close(form, outs, _probe_run(form, d, reference=True))
    again = _probe_run(form, d, reference=False)
    assert all(torch.equal(a, o) for a, o in zip(again, outs))


@pytest.mark.parametrize("gemm_grid", [1, 3])
@pytest.mark.parametrize("n", [128, 384, 3072])
@pytest.mark.parametrize("form", ["mxu", "fused", "indep:q", "indep:ln"])
def test_probe_gemm_kernel_walks_several_chunks_a_block(dev, form, n, gemm_grid,
                                                        monkeypatch):
    """The GEMM kernels' persistent grid cut to 1 and 3 blocks: each block
    walks several of the 32 chunks (3: unevenly), with one column tile a
    chunk (n = 128: one consumer warpgroup idle in each), an odd count (384)
    and 24; the row warpgroup's stride over the rows changes with it."""
    from vit_with_opencl_tpu_torch.scripts import probe_w8a8_overlap as probe

    d = _probe_data(dev, "random", 4, n, seed=2)
    monkeypatch.setattr(probe, "_gemm_grid", lambda blocks, device: gemm_grid)
    outs = _probe_run(form, d, reference=False)
    torch.cuda.synchronize()
    _probe_close(form, outs, _probe_run(form, d, reference=True))


@pytest.mark.parametrize("form", PROBE_FORMS)
def test_probe_kernel_keeps_only_the_last_block(dev, form):
    """Another first block leaves the outputs as they were; another last
    block moves every output."""
    base = _probe_data(dev, "random", 3, 256)
    other = _probe_data(dev, "random", 3, 256, seed=1)
    first = dict(base, xf=torch.cat([other["xf"][:1024], base["xf"][1024:]]),
                 xq=torch.cat([other["xq"][:1024], base["xq"][1024:]]))
    last = dict(base, xf=torch.cat([base["xf"][:-1024], other["xf"][-1024:]]),
                xq=torch.cat([base["xq"][:-1024], other["xq"][-1024:]]))
    want = _probe_run(form, base, reference=False)
    for out, ref in zip(_probe_run(form, first, reference=False), want):
        assert torch.equal(out, ref)
    for out, ref in zip(_probe_run(form, last, reference=False), want):
        assert not torch.equal(out, ref)


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from vit_with_opencl_tpu_torch.scripts import probe_w8a8_overlap as probe

    d = _probe_data(dev, "random", 1, 256)
    with pytest.raises(ValueError, match="blocks"):
        probe.vpu_quant(d["xf"][:1000])
    with pytest.raises(ValueError, match="multiple of 128"):
        probe.mxu(d["xq"], d["w"][:, :200].contiguous(), d["sw"][:, :200].contiguous())
    for form in ("mxu", "fused", "indep:q"):
        with pytest.raises(ValueError, match="K-major"):
            probe.run(form, dict(d, w=d["w"].contiguous()))
    with pytest.raises(TypeError, match="dtype"):
        probe.fused(d["xq"], d["w"], d["sw"])
    with pytest.raises(ValueError, match="vpu_op"):
        probe.indep(d["xf"], d["xq"], d["w"], d["sw"], "gelu")


# perf.device_kernel_table on the card. The tracer drops the kernels at the
# start of its window now and then (on an H100: the first launches of a
# ViT-B forward, the first 3.5 layers of a host-bound ViT-Ti stack); the
# marks around the counted runs keep every launch of those runs in the
# table. TRACE_REPEATS traces of each forward, each of 3 runs.
TRACE_REPEATS = 10


@pytest.mark.parametrize("name,batch", [("vit_b_16_224", 256),
                                        ("vit_tiny_16_224", 16)])
def test_device_kernel_table_counts_every_launch(dev, name, batch):
    from vit_with_opencl_tpu_torch import config, perf
    from vit_with_opencl_tpu_torch.engine import InferenceEngine

    cfg = config.get_config(name)
    engine = InferenceEngine(cfg, fixtures.random_params(cfg, seed=2, scale=0.05),
                             batch_size=batch, attention_impl="flash", device=dev)
    x = _rand((batch, 3, cfg.img_size, cfg.img_size), dev)
    per_forward = {"gemm_sm90_kernel": 4 * cfg.depth,
                   "layernorm_kernel<": 2 * cfg.depth,
                   "packed_attention_kernel": cfg.depth}
    with torch.inference_mode():
        for _ in range(TRACE_REPEATS):
            table = perf.device_kernel_table(engine.forward, (x,), iters=3)
            got = {k: sum(s.calls for s in table if k in s.name) for k in per_forward}
            assert got == {k: 3 * n for k, n in per_forward.items()}


# The serving daemon on the card (serve.py): the batcher's thread launches
# the encoder's kernels; every answer equals the same engine's run on the
# same images (the forward's shape is the engine's batch either way, so a
# row's sums do not depend on its neighbours).
SERVE_CFG = ViTConfig(name="serve_card", img_size=64, patch_size=16, embed_dim=192,
                      depth=2, num_heads=3, num_classes=10)


@pytest.fixture
def socket_timeout():
    import socket

    before = socket.getdefaulttimeout()
    socket.setdefaulttimeout(30)
    yield
    socket.setdefaulttimeout(before)


def _serve_and_check(engine, images, payload):
    """Three client threads send ``images`` in ``payload``-image requests to
    a server on ``engine``; checks a wrong-shape request's ERROR, STATS, and
    the GEMM launches of every served batch (from the batcher's thread).
    Returns the answers in image order."""
    import threading

    from vit_with_opencl_tpu_torch import serve

    srv = serve.InferenceServer(engine, port=0, max_wait_ms=10.0)
    srv.start_background()
    try:
        chunks = [images[i:i + payload] for i in range(0, len(images), payload)]
        got = [None] * len(chunks)

        def client(t):
            for c in range(t, len(chunks), 3):
                got[c] = serve.classify(chunks[c], port=srv.address[1])

        before = linear.LAUNCHES + linear.LAUNCHES_W8A8
        threads = [threading.Thread(target=client, args=(t,)) for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        launched = linear.LAUNCHES + linear.LAUNCHES_W8A8 - before
        with pytest.raises(RuntimeError, match="ERROR: expected images"):
            serve.classify(np.zeros((1, 3, 8, 8), images.dtype), port=srv.address[1])
        stats = serve.stats(port=srv.address[1])
    finally:
        srv.shutdown()
    assert stats["images_served"] == len(images) and stats["batch_errors"] == 0
    assert launched == 4 * SERVE_CFG.depth * stats["batches_run"] * \
        getattr(engine, "n_devices", 1)
    return [pair for chunk in got for pair in chunk]


@pytest.mark.parametrize("quantize", [None, "int8-w8a8"])
@pytest.mark.parametrize("uint8", [False, True], ids=["float32", "uint8"])
def test_server_on_the_card(dev, socket_timeout, quantize, uint8):
    from vit_with_opencl_tpu_torch.engine import InferenceEngine

    params = fixtures.random_params(SERVE_CFG, seed=1, scale=0.05)
    engine = InferenceEngine(SERVE_CFG, params, batch_size=8, attention_impl="flash",
                             device=dev, quantize=quantize, normalize_uint8=uint8)
    engine.warmup()
    shape = (20, 3, SERVE_CFG.img_size, SERVE_CFG.img_size)
    rng = np.random.default_rng(2)
    images = (rng.integers(0, 256, shape, np.uint8) if uint8
              else rng.standard_normal(shape).astype(np.float32))
    served = _serve_and_check(engine, images, payload=3)
    want = engine.run(images)
    assert [label for label, _ in served] == [int(p.argmax()) for p in want]
    np.testing.assert_allclose([prob for _, prob in served], want.max(-1), atol=1e-3)


def test_dp_serving_on_a_virtual_mesh(dev, socket_timeout):
    from vit_with_opencl_tpu_torch.engine import DataParallelEngine, InferenceEngine

    params = fixtures.random_params(SERVE_CFG, seed=1, scale=0.05)
    dp = DataParallelEngine(SERVE_CFG, params, batch_size=8, devices=[dev] * 4,
                            attention_impl="flash")
    dp.warmup()
    images = np.random.default_rng(3).standard_normal(
        (20, 3, SERVE_CFG.img_size, SERVE_CFG.img_size)).astype(np.float32)
    served = _serve_and_check(dp, images, payload=4)
    one = InferenceEngine(SERVE_CFG, params, batch_size=8, attention_impl="flash",
                          device=dev).run(images)
    # Each shard's GEMMs are 4x shorter than the one-card engine's, so bf16
    # may round elsewhere: labels are held where the top two are apart.
    top2 = np.sort(one, axis=-1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 2e-3
    labels = np.array([label for label, _ in served])
    assert decisive.sum() >= 10
    assert (labels[decisive] == one.argmax(-1)[decisive]).all()
    np.testing.assert_allclose([prob for _, prob in served], one.max(-1), atol=1e-3)


# -- the on-card input pipeline (augment_device, augment) -------------------

AUG_OP_TOL = 1.0 + 1e-6  # one u8 level, the JAX package's bound a device op
AUG_EXACT_OPS = ("identity", "equalize", "posterize", "solarize")


def _aug_batch(n=16, src=64, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (n, src, src, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 10, n)))


def test_device_augment_ops_on_the_card(dev):
    """Each RandAugment op on the card against the same op on the CPU, the
    same arguments: within one level, bit-identical for the exact ops."""
    from vit_with_opencl_tpu_torch import augment_device as ad

    imgs = _aug_batch(8, 48)[0].float()
    for k, (name, fn, _, _) in enumerate(ad.DEVICE_RAND_AUGMENT_OPS):
        v = torch.from_numpy(ad.op_arguments(
            np.full(8, k), np.linspace(0.0, 10.0, 8, dtype=np.float32),
            np.arange(8) % 2 == 1))
        want = fn(imgs, v)
        got = fn(imgs.to(dev), v.to(dev)).cpu()
        same = float((got == want).float().mean())
        print(f"{name}: max abs err {float((got - want).abs().max()):.3g}, "
              f"{same:.4%} exact")
        if name in AUG_EXACT_OPS:
            assert torch.equal(got, want), name
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=AUG_OP_TOL)


@pytest.mark.parametrize("randaugment", [(2, 9.0), None])
def test_device_augment_on_the_card_matches_the_cpu(dev, randaugment):
    """The pipeline on the card and on the CPU, the same drawn parameters:
    before the normalization within one level (nearly all exact); the flip
    and the crop without RandAugment within fp32 rounding."""
    from vit_with_opencl_tpu_torch import augment_device as ad
    from vit_with_opencl_tpu_torch.io.preprocess import IMAGENET_MEAN, IMAGENET_STD

    std = torch.from_numpy(IMAGENET_STD * np.float32(255.0))[:, None, None]
    mean = torch.from_numpy(IMAGENET_MEAN * np.float32(255.0))[:, None, None]
    # Three batches through one captured graph: the first call captures it,
    # the others replay it on new images and new parameters.
    for seed in (4, 5, 6):
        imgs, _ = _aug_batch(32, 64, seed=seed)
        p = ad.draw_augment_params(torch.Generator().manual_seed(seed), 32, 64,
                                   64, randaugment=randaugment)
        want = ad.apply_augment(imgs, p, img_size=48, randaugment=randaugment)
        got = ad.apply_augment(imgs.to(dev), p, img_size=48,
                               randaugment=randaugment).cpu()
        pg, pw = got * std + mean, want * std + mean
        same = float(((pg - pw).abs() < 1e-3).float().mean())
        print(f"device_augment {randaugment} seed {seed}: max abs err "
              f"{float((pg - pw).abs().max()):.3g} levels, {same:.4%} exact")
        tol = AUG_OP_TOL if randaugment else 1e-3
        torch.testing.assert_close(pg, pw, rtol=0, atol=tol)
        assert same > 0.99
    # The flip alone (no crop move): the card's flipped images are the
    # CPU's unflipped ones reversed, bit for bit.
    flip = p._replace(flip=torch.ones(32, dtype=torch.bool))
    keep = p._replace(flip=torch.zeros(32, dtype=torch.bool))
    a = ad.apply_augment(imgs.to(dev), flip, img_size=48, randaugment=None).cpu()
    b = ad.apply_augment(imgs, keep, img_size=48, randaugment=None)
    assert torch.equal(a, b.flip(-1))


@pytest.mark.parametrize("kw", [{"mixup_alpha": 0.0}, {"cutmix_alpha": 0.0}, {}])
def test_device_mixup_cutmix_on_the_card_matches_the_cpu(dev, kw):
    """The batch mix on the card and on the CPU from the same generator
    seed: CutMix and the labels exact, Mixup exact (the same fp32 lerp)."""
    from vit_with_opencl_tpu_torch import augment

    x = _rand((16, 3, 48, 48), "cpu", seed=3)
    _, y = _aug_batch(16)
    for seed in range(4):
        want = augment.device_mixup_cutmix(torch.Generator().manual_seed(seed), x,
                                           y, 10, **kw)
        got = augment.device_mixup_cutmix(torch.Generator().manual_seed(seed),
                                          x.to(dev), y.to(dev), 10, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_device_augment_replays_from_threads(dev):
    """Calls from two threads on their own streams share the captured
    graphs one at a time: each result equals the same call alone."""
    import threading

    from vit_with_opencl_tpu_torch import augment_device as ad

    imgs = [_aug_batch(16, 64, seed=s)[0].to(dev) for s in range(6)]
    alone = [ad.device_augment(x, torch.Generator().manual_seed(i), img_size=32)
             for i, x in enumerate(imgs)]
    got = [None] * len(imgs)

    def work(which):
        with torch.cuda.stream(torch.cuda.Stream()):
            for i in which:
                got[i] = ad.device_augment(imgs[i], torch.Generator().manual_seed(i),
                                           img_size=32)
            torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=work, args=(r,))
               for r in (range(0, 6, 2), range(1, 6, 2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for a, b in zip(got, alone):
        assert torch.equal(a, b)
    held = torch.cuda.memory_allocated()
    ad.release_graphs()
    import gc

    gc.collect()
    assert torch.cuda.memory_allocated() < held  # the graphs' pools went


def test_trainer_recipe_on_the_card(dev):
    """Trainer(device_augment=..., mixup=..., ema_decay=...) on a tiny
    config: the batches live on the card, the loss is finite."""
    from vit_with_opencl_tpu_torch.augment_device import raw_batches
    from vit_with_opencl_tpu_torch.train import Trainer

    cfg = ViTConfig(name="aug_card", img_size=32, patch_size=8, embed_dim=64,
                    depth=2, num_heads=4, num_classes=17)
    raw = np.random.default_rng(0).integers(0, 256, (32, 40, 40, 3), dtype=np.uint8)
    tr = Trainer(cfg, device=dev, lr=1e-3, optimizer="adamw",
                 compute_dtype=torch.bfloat16, attention_impl="fused",
                 device_augment={}, mixup={}, ema_decay=0.99, log_every=0)
    tr.fit(raw_batches(raw, np.arange(32) % 17, 16, epochs=2, seed=1))
    assert tr.step_idx == 4 and np.isfinite(tr.last_loss)


# -- the attribution probe's stand-ins (perf/profiler.kernel_substitutions) --


def _substituted(gelu=False, softmax=False, cheap=False):
    from vit_with_opencl_tpu_torch.perf import profiler

    return profiler.kernel_substitutions(gelu, softmax, cheap)


@pytest.mark.parametrize("b,t,nh,hd", [(2, 197, 12, 64), (16, 197, 12, 64),
                                       (2, 577, 16, 64), (2, 257, 16, 80),
                                       (3, 17, 4, 64)])
def test_packed_attention_const_scale_stand_in(dev, b, t, nh, hd):
    """Row 4's constant-scale form against its plain version (JAX's
    fake_head) at ViT-B's shape, past the one-pass 256 keys, at ViT-H's head
    dim and at a T below one tile; counted under the real kernel's count;
    the real kernel gives the same bits before and after."""
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16, seed=t)
    real = attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd)
    before = attention.LAUNCHES
    with _substituted(softmax=True):
        out = attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd)
        ref = attention.packed_fused_attention_reference(qkv, nh, hd)
    torch.cuda.synchronize()
    assert attention.LAUNCHES == before + 1
    _close(out, ref)
    assert not torch.equal(out, real)
    assert torch.equal(real, attention.packed_fused_attention(qkv, num_heads=nh,
                                                              head_dim=hd))


@pytest.mark.parametrize("rows,cols", [(19, 768), (3152, 768), (197, 3072), (7, 8192),
                                       (1100, 8192), (19, 192)])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_cheap_stand_in(dev, rows, cols, in_dtype):
    """Row 5a's cheap form: bit-identical to its plain version (the codes
    truncated and saturated, scale 1.0), with values past int8's range; the
    real kernel's bits unchanged after it."""
    x = _rand((rows, cols), dev, in_dtype, std=60.0)
    real_q, real_s = quantize.quantize_rows(x)
    before = quantize.LAUNCHES
    with _substituted(cheap=True):
        q, s = quantize.quantize_rows(x)
        rq, rs = quantize.quantize_rows_reference(x)
    torch.cuda.synchronize()
    assert quantize.LAUNCHES == before + 1
    assert torch.equal(q, rq) and torch.equal(s, rs) and bool((s == 1.0).all())
    q2, s2 = quantize.quantize_rows(x)
    assert torch.equal(q2, real_q) and torch.equal(s2, real_s)


@pytest.mark.parametrize("rows,cols,m", [(19, 768, 640), (3152, 768, 640),
                                         (197, 3072, 2944), (37, 1024, 896)])
def test_quantize_rows_split_cheap_stand_in(dev, rows, cols, m):
    x = _rand((rows, cols), dev, std=60.0, seed=2)
    real = quantize.quantize_rows_split(x, m, torch.bfloat16)
    before = quantize.LAUNCHES_SPLIT
    with _substituted(cheap=True):
        got = quantize.quantize_rows_split(x, m, torch.bfloat16)
        ref = quantize.quantize_rows_split_reference(x, m, torch.bfloat16)
    torch.cuda.synchronize()
    assert quantize.LAUNCHES_SPLIT == before + 1
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert all(torch.equal(a, r) for a, r in
               zip(quantize.quantize_rows_split(x, m, torch.bfloat16), real))


def test_gelu_identity_runs_fc1_without_its_gelu(dev):
    x = _rand((394, 768), dev, torch.bfloat16)
    w = _rand((768, 3072), dev, torch.bfloat16, std=0.05, seed=1)
    b = _rand((3072,), dev, std=0.1, seed=2)
    with_gelu = linear.fused_linear(x, w, b, fuse_gelu=True)
    with _substituted(gelu=True):
        out = linear.fused_linear(x, w, b, fuse_gelu=True)
        ref = linear.fused_linear_reference(x, w, b, fuse_gelu=True)
    _close(out, ref)
    assert torch.equal(out, linear.fused_linear(x, w, b))
    assert torch.equal(with_gelu, linear.fused_linear(x, w, b, fuse_gelu=True))


def test_routes_without_a_stand_in_raise(dev):
    """Under each substitution the card routes that have no compiled
    stand-in raise instead of running their real math."""
    nh, hd, t = 4, 64, 37
    qkv = _rand((2, t, 3 * nh * hd), dev, torch.bfloat16)
    do = _rand((2, t, nh * hd), dev, torch.bfloat16, seed=1)
    q, k, v = qkv.reshape(2, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    cfg = ViTConfig(name="hd64", img_size=32, patch_size=8, embed_dim=nh * hd,
                    depth=1, num_heads=nh, num_classes=9)
    x = _rand((8, 768), dev, torch.bfloat16)
    w = _rand((768, 256), dev, torch.bfloat16, std=0.05, seed=1)
    counts = (attention.LAUNCHES, attention.LAUNCHES_SINGLE, attention.LAUNCHES_BWD,
              linear.LAUNCHES_GELU_PAIR, quantize.LAUNCHES)
    with _substituted(softmax=True):
        for call in (
                lambda: attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd,
                                                         true_seq_len=t - 5),
                lambda: attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd,
                                                         packing="per_head"),
                lambda: attention.packed_fused_attention(
                    _rand((2, t, 3 * 4 * 32), dev, torch.bfloat16), num_heads=4,
                    head_dim=32),
                lambda: attention.single_pass_attention(q, k, v, hd),
                lambda: attention.flash_attention(q, k, v, cfg),
                lambda: attention.packed_attention_bwd(qkv, do, nh, hd)):
            with pytest.raises(NotImplementedError, match="softmax_identity"):
                call()
    with _substituted(gelu=True):
        with pytest.raises(NotImplementedError, match="gelu_identity"):
            linear.fused_linear_with_gelu(x, w, _rand((256,), dev))
    with _substituted(cheap=True):
        with pytest.raises(NotImplementedError, match="quant_cheap"):
            quantize.quantize_rows(_rand((4, 112), dev))
    assert counts == (attention.LAUNCHES, attention.LAUNCHES_SINGLE,
                      attention.LAUNCHES_BWD, linear.LAUNCHES_GELU_PAIR,
                      quantize.LAUNCHES)


def test_graph_capture_is_refused_under_a_substitution(dev):
    qkv = _rand((2, 197, 3 * 12 * 64), dev, torch.bfloat16)
    attention.packed_fused_attention(qkv, num_heads=12, head_dim=64)  # built, warm
    graph = torch.cuda.CUDAGraph()
    with _substituted(softmax=True), torch.cuda.graph(graph):
        with pytest.raises(RuntimeError, match="substitution"):
            attention.packed_fused_attention(qkv, num_heads=12, head_dim=64)


def test_attribute_forward_on_the_card(dev):
    """ViT-B/16's width at depth 2, B = 4: the shares lie in [0, 1] and the
    real forward gives the same bits after the attribution as before."""
    from vit_with_opencl_tpu_torch.config import VIT_B_16_224
    from vit_with_opencl_tpu_torch.perf import profiler
    import dataclasses

    cfg = dataclasses.replace(VIT_B_16_224, depth=2)
    params = vit.stack_params(fixtures.random_params(cfg, seed=1), cfg,
                              param_dtype=torch.bfloat16, device=dev)
    images = _rand((4, 3, 224, 224), dev, seed=3)
    kernels = vit.resolve_kernels("flash")
    with torch.inference_mode():
        before = vit.forward(images, params, cfg, kernels=kernels)
        a = profiler.attribute_forward(cfg, params, images, iters=2)
        after = vit.forward(images, params, cfg, kernels=kernels)
    assert torch.equal(before, after)
    for key in ("gelu_share", "softmax_share", "vpu_share"):
        assert 0.0 <= a[key] <= 1.0


# -- fp32 up to padded T = 1024: the fp32 GEMM (csrc/gemm_f32.cu), the fp32
# slab entry of the packed attention and the fp32 attention backward
# (csrc/attention_bwd_f32.cu). Plain fp32 FMA against the plain versions'
# library matmuls (TF32 off): another summation order, held to F32_GEMM_REL
# of each output's largest magnitude (measured below 3e-6 at ViT-B shapes on
# an H100 80GB HBM3); bf16 outputs as the bf16 kernels'.
F32_GEMM_REL = 2e-5


@pytest.mark.parametrize("m,k,n", [(74, 64, 192), (394, 768, 2304), (33, 40, 24),
                                   (1, 3072, 768), (3152, 3072, 768)] + WIDE_GEMMS)
@pytest.mark.parametrize("epilogue", ["bias", "gelu", "res_f32", "res_bf16",
                                      "res_bf16_out"])
def test_fused_linear_fp32_kernel(dev, m, k, n, epilogue):
    x = _rand((m, k), dev)
    w = _rand((k, n), dev, std=0.05, seed=1)
    b = _rand((n,), dev, std=0.1, seed=2)
    kw = {"fuse_gelu": epilogue == "gelu"}
    if epilogue.startswith("res"):
        rdt = torch.float32 if epilogue == "res_f32" else torch.bfloat16
        kw["residual"] = _rand((m, n), dev, rdt, seed=3)
        if epilogue == "res_bf16_out":
            kw["out_dtype"] = torch.bfloat16
    before = linear.LAUNCHES_F32
    out = linear.fused_linear(x, w, b, **kw)
    torch.cuda.synchronize()
    assert linear.LAUNCHES_F32 == before + 1
    ref = linear.fused_linear_reference(x, w, b, **kw)
    if out.dtype == torch.bfloat16:
        _close(out, ref)
    else:
        _rel_close(out, ref, F32_GEMM_REL)
    assert torch.equal(out, linear.fused_linear(x, w, b, **kw))


@pytest.mark.parametrize("m,k,n", [(74, 64, 192), (3152, 768, 2304),
                                   (3152, 3072, 768), (33, 40, 24),
                                   (40, 768, 768)] + WIDE_GEMMS)
@pytest.mark.parametrize("form", ["dgrad", "dgrad_gelu_f32", "dgrad_gelu_bf16",
                                  "wgrad", "fc1"])
def test_grad_gemm_fp32_kernels(dev, m, k, n, form):
    """The fp32 GEMM's backward forms, each with its own count, the same
    bits over two calls: dgrad dY [m, n] · Wᵀ (W [k, n]) with the GELU
    gradient and a second output in fp32 or bf16; wgrad Xᵀ [k, m] · dY
    [m, n] (split over the tokens where _wgrad_splits says so); the fc1
    recompute X [m, k] · W2 [k, n] + b with its fp32 GELU'd copy."""
    x = _rand((m, k), dev)
    dy = _rand((m, n), dev, seed=1)
    w = _rand((k, n), dev, std=0.05, seed=2)
    if form.startswith("dgrad"):
        kw = {}
        if form != "dgrad":
            kw = dict(gelu_grad_of=_rand((m, k), dev, seed=3),
                      out2_dtype=torch.float32 if form.endswith("f32") else torch.bfloat16)
        call = lambda: linear.linear_dgrad(dy, w, **kw)  # noqa: E731
        plain = linear.linear_dgrad_reference(dy, w, **kw)
        counter = "LAUNCHES_DGRAD_F32"
    elif form == "wgrad":
        call = lambda: linear.linear_wgrad(x, dy)  # noqa: E731
        plain = linear.linear_wgrad_reference(x, dy)
        counter = "LAUNCHES_WGRAD_F32"
    else:
        b = _rand((n,), dev, std=0.1, seed=4)
        call = lambda: linear.fused_linear_with_gelu(x, w, b)  # noqa: E731
        plain = linear.fused_linear_with_gelu_reference(x, w, b)
        counter = "LAUNCHES_GELU_PAIR_F32"
    before = getattr(linear, counter)
    out = call()
    torch.cuda.synchronize()
    assert getattr(linear, counter) == before + 1
    outs = out if isinstance(out, tuple) else (out,)
    refs = plain if isinstance(plain, tuple) else (plain,)
    for o, r in zip(outs, refs):
        assert o.dtype == r.dtype
        if o.dtype == torch.bfloat16:
            _close(o, r)
        else:
            _rel_close(o, r, F32_GEMM_REL)
    again = call()
    for o, a in zip(outs, again if isinstance(again, tuple) else (again,)):
        assert torch.equal(o, a)


def test_grad_gemm_fp32_refuses_mixed_operands(dev):
    with pytest.raises(NotImplementedError):
        linear.linear_dgrad(_rand((8, 16), dev), _rand((8, 16), dev, torch.bfloat16))
    with pytest.raises(NotImplementedError):
        linear.linear_wgrad(_rand((8, 16), dev), _rand((8, 16), dev, torch.bfloat16))


@pytest.mark.parametrize("k,n", [(768, 768), (3072, 768), (768, 2304)])
def test_wgrad_fp32_is_deterministic(dev, k, n):
    """The fp32 weight gradient at ViT-B's B = 64: its split partials are
    summed by the same fixed-order kernel as the bf16 form's."""
    m = 64 * 197
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x = _rand((m, k), dev)
    dy = _rand((m, n), dev, seed=1)
    before = linear.LAUNCHES_WGRAD_F32
    first = linear.linear_wgrad(x, dy)
    torch.cuda.synchronize()
    assert linear.LAUNCHES_WGRAD_F32 == before + 1
    assert torch.equal(first, linear.linear_wgrad(x, dy))
    full, splits, split_k = linear._wgrad_splits(m, k, n, sms)
    if splits > 1:
        # The split's order of sums, which the kernel keeps.
        _rel_close(first, linear.linear_wgrad_split_reference(x, dy, full, splits,
                                                              split_k), F32_GEMM_REL)
    _rel_close(first, linear.linear_wgrad_reference(x, dy), F32_GEMM_REL)


@pytest.mark.parametrize("b,t,nh,hd", [(2, 37, 4, 16), (16, 197, 12, 64),
                                       (1, 50, 2, 104), (1, 130, 2, 128),
                                       (8, 577, 16, 64), (1, 1000, 1, 80),
                                       (1, 1024, 2, 64), (3, 1, 2, 16)])
def test_packed_attention_fp32_kernel(dev, b, t, nh, hd):
    """fp32 slab packing over every key on the fp32 slab entry, at ViT-B's
    T, ViT-L/16@384's and the route's last, ragged T and head dims."""
    qkv = _rand((b, t, 3 * nh * hd), dev, seed=t + hd)
    launches = (attention.LAUNCHES, attention.LAUNCHES_SINGLE, attention.LAUNCHES_PACKED_F32)
    out = attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd)
    torch.cuda.synchronize()
    assert (attention.LAUNCHES, attention.LAUNCHES_SINGLE,
            attention.LAUNCHES_PACKED_F32) == (launches[0], launches[1], launches[2] + 1)
    _rel_close(out, attention.packed_fused_attention_reference(qkv, nh, hd), SINGLE_F32_REL)
    assert torch.equal(out, attention.packed_fused_attention(qkv, num_heads=nh, head_dim=hd))


@pytest.mark.parametrize("b,t,nh,hd", [(2, 37, 4, 16), (16, 197, 12, 64),
                                       (1, 50, 2, 104), (1, 197, 2, 128),
                                       (2, 577, 16, 64), (1, 257, 2, 80),
                                       (1, 1024, 2, 64), (1, 1, 2, 16),
                                       (1, 65, 2, 48)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_packed_attention_bwd_fp32_kernel(dev, b, t, nh, hd, out_dtype):
    """The fp32 backward's dq and dK/dV kernels at ViT-B's T, the presets'
    and the route's last, tiles of 64 rows, T not a multiple of them;
    dqkv in fp32 or bf16; the same bits over two calls."""
    qkv = _rand((b, t, 3 * nh * hd), dev, seed=t + hd)
    do = _rand((b, t, nh * hd), dev, std=0.01, seed=t + hd + 1)
    before = (attention.LAUNCHES_BWD, attention.LAUNCHES_BWD_F32)
    out = attention.packed_attention_bwd(qkv, do, nh, hd, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (attention.LAUNCHES_BWD, attention.LAUNCHES_BWD_F32) == (before[0], before[1] + 1)
    assert out.dtype == out_dtype
    ref = attention.packed_attention_bwd_reference(qkv, do, nh, hd, out_dtype=out_dtype)
    if out_dtype == torch.bfloat16:
        _close(out, ref, min_same=MIN_SAME_KERNEL,
               tol=dict(rtol=1.6e-2, atol=1e-2 * float(ref.float().abs().max())))
    else:
        _rel_close(out, ref, F32_GEMM_REL)
    assert torch.equal(out, attention.packed_attention_bwd(qkv, do, nh, hd,
                                                           out_dtype=out_dtype))


def test_fp32_trainable_attention_and_layer_on_card(dev):
    """fp32 training's two routes at a small width: the trainable packed
    attention (fp32 slab forward, fp32 backward) and the trainable fused
    layer (the fp32 GEMM's four forms, the fp32 attention both ways, the
    LN backward's general form and the column sums) against their plain
    versions."""
    cfg = ViTConfig(name="bwd32", img_size=32, patch_size=8, embed_dim=64,
                    depth=1, num_heads=4, num_classes=9)
    qkv = _rand((2, 197, 192), dev, seed=8).requires_grad_(True)
    before = (attention.LAUNCHES_PACKED_F32, attention.LAUNCHES_BWD_F32)
    attention.packed_fused_attention_trainable(qkv, 4, 16).square().sum().backward()
    torch.cuda.synchronize()
    assert (attention.LAUNCHES_PACKED_F32, attention.LAUNCHES_BWD_F32) == (
        before[0] + 1, before[1] + 1)
    out = attention.packed_fused_attention_reference(qkv.detach(), 4, 16)
    ref = attention.packed_attention_bwd_reference(qkv.detach(), 2 * out, 4, 16)
    _rel_close(qkv.grad, ref, F32_GEMM_REL)

    lp = {k: v.requires_grad_(True) for k, v in _train_layer(cfg, dev).items()}
    x = _rand((2, cfg.num_tokens, 64), dev, std=0.5, seed=6).requires_grad_(True)
    names = ("LAUNCHES_F32", "LAUNCHES_DGRAD_F32", "LAUNCHES_WGRAD_F32",
             "LAUNCHES_GELU_PAIR_F32")
    before = [getattr(linear, n) for n in names]
    out = fused_block.fused_encoder_layer_trainable(x, lp, cfg)
    out.square().sum().backward()
    torch.cuda.synchronize()
    # The forward's 4 GEMMs, the backward's recomputes (qkv and out-proj for
    # x2, qkv again in the attention stage); 4 dgrads, 4 wgrads, the fc1
    # recompute.
    assert [getattr(linear, n) - b for n, b in zip(names, before)] == [7, 4, 4, 1]
    ref_dx, ref = fused_block.fused_encoder_layer_bwd_reference(
        x.detach(), {k: v.detach() for k, v in lp.items()}, 2 * out.detach(), cfg)
    _rel_close(x.grad, ref_dx, F32_GEMM_REL)
    for key, v in lp.items():
        _rel_close(v.grad, ref[key], 1e-4)


# The blockwise kernels' fp32 forms (rows 9-fp32 and 12-fp32, past padded
# T = 1024): plain FMA, no TF32, the sums in another order than the plain
# versions' library calls (outputs within SINGLE_F32_REL of scale, the LSE
# within LSE_REL, gradients within F32_GEMM_REL of each slab's scale).
# ViT-L/16@512's T = 1025 at hd 64, ViT-H/14@518's 1370 at hd 80, one key
# past 9 whole 128-key tiles at hd 128, JAX's odd tail 1337, and short or
# narrow heads.
FLASH_F32_SHAPES = [(2, 1025, 2, 64), (1, 1370, 2, 80), (1, 1153, 2, 128),
                    (1, 1337, 1, 64), (2, 37, 2, 16), (1, 200, 1, 104)]


@pytest.mark.parametrize("b,t,nh,hd", FLASH_F32_SHAPES)
@pytest.mark.parametrize("block_k", attention.FLASH_BLOCK_KS)
def test_flash_attention_fwd_fp32_kernel(dev, b, t, nh, hd, block_k):
    """Row 9-fp32 at each key tile, with and without the LSE, over every
    key and with keys masked from kv_len (a last block of one live key,
    64-key tiles of the last block wholly masked), against the plain
    version at the same tile; counted by form and by tile; the same bits
    over two calls, with and without the LSE."""
    qkv = _rand((b, t, 3 * nh * hd), dev, seed=t + hd + block_k)
    tile = f"LAUNCHES_FLASH_K{block_k}"
    for kv_len in sorted({t, max(1, t - 300), min(t, 129), 1}):
        kw = dict(kv_len=kv_len, block_k=block_k)
        before = (attention.LAUNCHES_FLASH_F32, attention.LAUNCHES_FLASH_LSE_F32,
                  getattr(attention, tile), attention.LAUNCHES_FLASH,
                  attention.LAUNCHES_FLASH_LSE)
        out, lse = attention.blockwise_attention_fwd(qkv, nh, hd, return_lse=True, **kw)
        plain, none = attention.blockwise_attention_fwd(qkv, nh, hd, **kw)
        torch.cuda.synchronize()
        assert (attention.LAUNCHES_FLASH_F32, attention.LAUNCHES_FLASH_LSE_F32,
                getattr(attention, tile), attention.LAUNCHES_FLASH,
                attention.LAUNCHES_FLASH_LSE) == (before[0] + 1, before[1] + 1,
                                                  before[2] + 2, *before[3:])
        assert none is None and out.dtype == torch.float32
        assert lse.shape == (b, nh, t) and lse.dtype == torch.float32
        ref, ref_lse = attention.blockwise_attention_fwd_reference(
            qkv, nh, hd, return_lse=True, **kw)
        _rel_close(out, ref, SINGLE_F32_REL)
        _rel_close(lse, ref_lse, LSE_REL)
        assert torch.equal(plain, out)
        again, again_lse = attention.blockwise_attention_fwd(qkv, nh, hd,
                                                             return_lse=True, **kw)
        assert torch.equal(out, again) and torch.equal(lse, again_lse)


def _slabs_close(got, ref, d, rel):
    """dq, dk and dv (the three slabs of dqkv) each within ``rel`` of its
    own scale."""
    for i in range(3):
        _rel_close(got[..., i * d:(i + 1) * d], ref[..., i * d:(i + 1) * d], rel)


@pytest.mark.parametrize("b,t,nh,hd", FLASH_F32_SHAPES + [(4, 1025, 16, 64)])
def test_flash_attention_bwd_fp32_kernel(dev, b, t, nh, hd):
    """Row 12-fp32 (the dq kernel, which also writes dvec, and the dK/dV
    kernel, with the forward's statistics given) on the plain forward's out
    and lse against the plain version; ViT-L/16@512's heads at B = 4 too;
    fp32 dqkv, the same bits over two calls (no atomics)."""
    qkv = _rand((b, t, 3 * nh * hd), dev, seed=t + hd)
    do = _rand((b, t, nh * hd), dev, std=0.01, seed=t + hd + 1)
    out, lse = attention.blockwise_attention_fwd_reference(qkv, nh, hd, return_lse=True)
    before = (attention.LAUNCHES_FLASH_BWD, attention.LAUNCHES_FLASH_BWD_F32)
    dqkv = attention.blockwise_attention_bwd(qkv, out, lse, do, nh, hd)
    torch.cuda.synchronize()
    assert (attention.LAUNCHES_FLASH_BWD, attention.LAUNCHES_FLASH_BWD_F32) == (
        before[0], before[1] + 1)
    assert dqkv.dtype == torch.float32 and dqkv.shape == qkv.shape
    _slabs_close(dqkv, attention.blockwise_attention_bwd_reference(qkv, out, lse, do, nh, hd),
                 nh * hd, F32_GEMM_REL)
    assert torch.equal(dqkv, attention.blockwise_attention_bwd(qkv, out, lse, do, nh, hd))


def test_fp32_trainable_attention_past_1024_on_card(dev):
    """fp32 training's attention at ViT-L/16@512's T = 1025 with 4 heads:
    ``packed_fused_attention_trainable`` launches the blockwise forward's
    fp32 form with the LSE and the fp32 blockwise backward, and its
    gradient is the plain versions' (forward with the LSE, then the
    backward on their out and lse)."""
    b, t, nh, hd = 2, 1025, 4, 64
    qkv = _rand((b, t, 3 * nh * hd), dev, seed=11)
    cot = _rand((b, t, nh * hd), dev, seed=12)
    x = qkv.clone().requires_grad_(True)
    before = (attention.LAUNCHES_FLASH_LSE_F32, attention.LAUNCHES_FLASH_BWD_F32,
              attention.LAUNCHES_PACKED_F32, attention.LAUNCHES_BWD_F32)
    out = attention.packed_fused_attention_trainable(x, nh, hd)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert (attention.LAUNCHES_FLASH_LSE_F32, attention.LAUNCHES_FLASH_BWD_F32,
            attention.LAUNCHES_PACKED_F32, attention.LAUNCHES_BWD_F32) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    ref_out, ref_lse = attention.blockwise_attention_fwd_reference(qkv, nh, hd,
                                                                   return_lse=True)
    _rel_close(out.detach(), ref_out, SINGLE_F32_REL)
    _slabs_close(x.grad, attention.blockwise_attention_bwd_reference(
        qkv, ref_out, ref_lse, cot, nh, hd), nh * hd, F32_GEMM_REL)


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_flash_bwd_f32_geometry_matches_the_kernels(dev, hd):
    """The host's copy of the fp32 blockwise backward's shared memory (the
    dq and the dK/dV kernel's, which the CPU tests hold to one block) is
    the kernels' own."""
    geometry = _build.library().vit_flash_bwd_f32_geometry
    assert (geometry(hd, 0), geometry(hd, 1)) == attention.f32_flash_bwd_smem_bytes(hd)
    assert geometry(hd, 2) == -1


def test_tune_and_save_fp32_on_card(dev, tmp_path):
    """``perf.autotune.tune_and_save`` in fp32 at T = 1025 (a narrow config,
    batch 1) sweeps the blockwise forward's fp32 form at each key tile and
    saves a winner that ``lookup`` returns on this card."""
    from vit_with_opencl_tpu_torch.perf import autotune

    cfg = ViTConfig(name="long_f32", img_size=256, patch_size=8, embed_dim=128,
                    depth=1, num_heads=2, num_classes=9)
    assert attention._is_long_seq(cfg.num_tokens)
    path = tmp_path / "tuning.json"
    before = (attention.LAUNCHES_FLASH_F32, attention.LAUNCHES_FLASH)
    result = autotune.tune_and_save(cfg, 1, dtype=torch.float32, path=path, iters=2,
                                    device=dev)
    table = result["blockwise_table_ms"]
    assert set(table) == {str(bk) for bk in attention.FLASH_BLOCK_KS}
    assert all(np.isfinite(v) and v > 0 for v in table.values())
    assert result["blockwise_block_k"] in attention.FLASH_BLOCK_KS
    assert attention.LAUNCHES_FLASH_F32 > before[0] and attention.LAUNCHES_FLASH == before[1]
    saved = autotune.lookup(cfg, 1, torch.float32, path=path, device=dev)
    assert saved["blockwise_block_k"] == result["blockwise_block_k"]

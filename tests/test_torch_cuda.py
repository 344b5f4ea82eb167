"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no NVIDIA card is present. The shapes
go beyond ViT-B's: ragged rows, K and N that are not multiples of the GEMM
tile, head dims that the attention kernel pads, and a 577-token sequence.
Run on a machine with a card (this file imports no JAX, so the repository's
conftest, which does, is left out):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from vit_with_opencl_tpu_torch import ViTConfig
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.models import vit
from vit_with_opencl_tpu_torch.ops import attention, fused_block, layernorm, linear

pytestmark = pytest.mark.cuda

# bf16 outputs: within about 2 bf16 ulps, and bit-identical almost
# everywhere (both sides round at the same points; a moved rounding point
# changes about half the elements). fp32 outputs: the kernels sum in another
# order than the plain versions' library calls.
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
MIN_SAME_KERNEL = 0.99
MIN_SAME_CHAIN = 0.7  # the chain compounds the flips of its 7 launches


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


def _close(out, ref, min_same=MIN_SAME_KERNEL):
    if out.dtype != torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), **F32_TOL)
        return
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    assert (out == ref).float().mean().item() >= min_same


@pytest.mark.parametrize("rows,cols", [(74, 64), (3152, 768)])
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


@pytest.mark.parametrize("m,k,n", [(74, 64, 192), (394, 768, 2304),
                                   (33, 40, 24), (1, 3072, 768)])
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
    x = _rand((4, 8), dev)
    with pytest.raises(NotImplementedError):
        linear.fused_linear(x, _rand((8, 8), dev))


@pytest.mark.parametrize("b,t,nh,hd", [(2, 37, 4, 16), (2, 197, 12, 64),
                                       (1, 50, 2, 104), (1, 577, 2, 64)])
def test_packed_attention_kernel(dev, b, t, nh, hd):
    qkv = _rand((b, t, 3 * nh * hd), dev, torch.bfloat16)
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

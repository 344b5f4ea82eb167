"""The LayerNorm and column-sum plain versions at the widths and row counts
that the card's kernels take in their several forms, against the JAX package.

``csrc/layernorm.cu`` compiles a form of its row kernel for each preset's
width (192, 384, 768, 1024, 1280, 1664) and a general form for any other;
``csrc/reduce.cu`` sums up to ``COLSUM_ONE_PASS_ROWS`` rows in one pass and
more in chunks. On the card each form is held to these plain versions
(``tests/test_torch_cuda.py``); here the plain versions are held to JAX's
``layer_norm`` (Pallas in interpret mode on the CPU), its fused layer's fp32
``_ln`` and ``_csum`` at those widths and row counts, on the same inputs made
with numpy from a seed. On CPU tensors no kernel may launch.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu.ops import fused_block as jfused
from vit_with_opencl_tpu.ops import layernorm as jlayernorm
from vit_with_opencl_tpu_torch.ops import layernorm

PRESET_WIDTHS = [192, 384, 768, 1024, 1280, 1664]
# 100 is not a whole number of 16-byte vectors in bf16 (the kernel's
# misaligned-row form), 64 is but is no preset's width (its general form).
WIDTHS = PRESET_WIDTHS + [64, 100]
ROWS = 19  # ragged against JAX's 8-row tiles and the kernel's row groups
# fp32 outputs: another summation order of the statistics over up to 1664
# elements; bf16 outputs within about 2 bf16 ulps and mostly bit-identical.
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
MIN_IDENTICAL_SHARE = 0.9
# Column sums: fp32 over up to 12608 rows in another order than XLA's.
COLSUM_REL = 1e-5


@pytest.fixture
def no_launches():
    before = (layernorm.LAUNCHES, layernorm.LAUNCHES_COLSUM)
    yield
    assert (layernorm.LAUNCHES, layernorm.LAUNCHES_COLSUM) == before


def _ln_inputs(d: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.5, (ROWS, d)).astype(np.float32)
    w = rng.normal(1.0, 0.1, d).astype(np.float32)
    b = rng.normal(0.0, 0.1, d).astype(np.float32)
    return x, w, b


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _assert_bf16_close(out, ref):
    out, ref = _np(out), _np(ref)
    np.testing.assert_allclose(out, ref, **BF16_TOL)
    assert (out == ref).mean() >= MIN_IDENTICAL_SHARE


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_reference_matches_jax_at_width(no_launches, d, dtype):
    """JAX's ``layer_norm`` (the output in x's dtype) at each width."""
    x, w, b = _ln_inputs(d, seed=d)
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    ref = jlayernorm.layer_norm(jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b),
                                1e-6, interpret=True)
    out = layernorm.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                               torch.from_numpy(b), 1e-6)
    assert out.dtype == tdt and tuple(out.shape) == (ROWS, d)
    if dtype == "f32":
        np.testing.assert_allclose(_np(out), np.asarray(ref), **F32_TOL)
    else:
        _assert_bf16_close(out, ref)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("bf16", torch.float32), ("f32", torch.float32), ("f32", torch.bfloat16)])
def test_layer_norm_reference_matches_fused_ln_at_width(no_launches, d, in_dtype,
                                                        out_dtype):
    """The fused layer's fp32 ``_ln`` (the W8A8 chains' LN1 and LN2 take its
    fp32 output, the bf16 chain's LN2 rounds it to bf16) on a bf16 or fp32
    input at each width."""
    x, w, b = _ln_inputs(d, seed=d + 1)
    if in_dtype == "bf16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16 if in_dtype == "bf16" else torch.float32)
    ref = jfused._ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)
    out = layernorm.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-6,
                               out_dtype=out_dtype)
    assert out.dtype == out_dtype
    if out_dtype == torch.float32:
        np.testing.assert_allclose(_np(out), np.asarray(ref), **F32_TOL)
    else:
        _assert_bf16_close(out, jnp.asarray(ref, jnp.bfloat16))


# The LN backward's partial rows at ViT-B B = 16 (50) and 64 (197), the
# one-pass limit's neighbours, ViT-B B = 64's tokens.
COLSUM_ROWS = [1, 50, 63, 64, 65, 197, 256, 257, 12608]


@pytest.mark.parametrize("rows", COLSUM_ROWS)
@pytest.mark.parametrize("cols", [7, 24])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_column_sum_reference_matches_jax_csum(no_launches, rows, cols, dtype):
    """``column_sum_reference`` against ``_csum`` (``jnp.sum`` over the token
    axis in fp32) on fp32 and on bf16 values."""
    x = np.random.default_rng(rows + cols).normal(0, 1, (rows, cols)).astype(np.float32)
    tx = torch.from_numpy(x)
    if dtype == "bf16":
        tx = tx.to(torch.bfloat16)
        x = tx.float().numpy()
    ref = np.asarray(jfused._csum(jnp.asarray(x, jnp.float32)))[0]
    out = layernorm.column_sum(tx)
    assert out.dtype == torch.float32 and tuple(out.shape) == (cols,)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(out.numpy() - ref).max()) <= COLSUM_REL * scale


@pytest.mark.parametrize("rows,cols,itemsize,chunks", [
    (50, 768, 4, 1), (197, 768, 4, 1), (256, 768, 4, 1),
    (257, 768, 4, 9),        # chunks of the 32-row floor
    (3152, 2304, 4, 30),     # dqkv at ViT-B B = 16: 18 tiles of 32 float4
    (12608, 2304, 4, 30),
    (12608, 768, 2, 176),    # dOut at B = 64: 3 tiles of 32 x 8 bf16
    (3152, 768, 2, 99),
    (12608, 7, 4, 394)])     # not whole vectors: a column a lane
def test_column_sum_chunks(rows, cols, itemsize, chunks):
    """The first pass's chunking depends on the shape alone: one pass up to
    COLSUM_ONE_PASS_ROWS rows, else about COLSUM_TARGET_BLOCKS blocks of at
    least COLSUM_MIN_CHUNK_ROWS rows."""
    per_chunk = layernorm.column_sum_rows_per_chunk(rows, cols, itemsize)
    assert -(-rows // per_chunk) == chunks
    if chunks > 1:
        assert per_chunk >= layernorm.COLSUM_MIN_CHUNK_ROWS

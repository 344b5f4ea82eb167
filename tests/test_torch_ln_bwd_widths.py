"""The LayerNorm backward's plain version at the widths that the card's
kernel takes in its several forms, against the JAX package.

``csrc/layernorm.cu`` compiles a form of its backward row kernel for each
preset's width (``LnBwdWidths``) in the two dtype sets of the training
chains (LN2: fp32 x, bf16 residual gradient, fp32 dx; LN1: bf16 x, fp32
residual gradient, bf16 dx) and a general form for any other. On the card
each form is held to ``layer_norm_bwd_reference`` (``tests/test_torch_cuda.py``);
here that plain version is held to the JAX fused layer's ``_ln_fwd_stats``,
``_ln_bwd`` and ``_csum`` with the residual gradient added, at those widths
and a general one, on the same inputs made with numpy from a seed. The
kernel's partial rows (``bwd_partial_rows``) are checked at the presets'
training shapes. On CPU tensors no kernel may launch.
"""

import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu.ops import fused_block as jfused
from vit_with_opencl_tpu_torch.config import (VIT_B_16_224, VIT_G_14_224,
                                              VIT_H_14_224, VIT_L_16_384,
                                              VIT_S_16_224, VIT_TINY_16_224)
from vit_with_opencl_tpu_torch.ops import layernorm

FORM_WIDTHS = [192, 384, 768, 1024, 1280, 1664]
GENERAL_WIDTH = 520  # whole chunks of 8 columns, no preset's width
ROWS = 19  # ragged against the kernel's row groups and blocks
EPS = 1e-6
# (x dtype, residual gradient dtype or None, dx dtype): the chains' LN2 and
# LN1, and LN2's dtypes without a residual.
SETS = {"LN2": (torch.float32, torch.bfloat16, torch.float32),
        "LN1": (torch.bfloat16, torch.float32, torch.bfloat16),
        "LN2, no residual": (torch.float32, None, torch.float32)}
# fp32 results: the same formulas with the row sums and the column sums
# taken in another order (over up to 1664 columns and 19 rows).
F32_REL = 1e-5
# bf16 dx: within about 2 bf16 ulps and mostly bit-identical.
BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
MIN_IDENTICAL_SHARE = 0.9

SOURCE = (Path(layernorm.__file__).resolve().parent.parent / "csrc" / "layernorm.cu")


@pytest.fixture
def no_launches():
    before = (layernorm.LAUNCHES_BWD, layernorm.LAUNCHES_COLSUM)
    yield
    assert (layernorm.LAUNCHES_BWD, layernorm.LAUNCHES_COLSUM) == before


def _constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert found, name
    return int(found.group(1))


def test_widths_cover_every_compile_time_form():
    found = re.search(r"using LnBwdWidths = Widths<([\d,\s]+)>;", SOURCE.read_text())
    assert found
    assert [int(w) for w in found.group(1).split(",")] == FORM_WIDTHS
    assert GENERAL_WIDTH not in FORM_WIDTHS


def test_rows_at_a_time_follow_the_forms_shape():
    """``BWD_FORM_ROWS_AT_A_TIME`` is LnBwdShape's rows a block at a time:
    the fewest threads a row (8 to 128, powers of two) that hold the row's
    chunks of 8 columns at kLnBwdMaxChunks a thread, in blocks of
    kLnBwdThreads."""
    threads, most = _constant("kLnBwdThreads"), _constant("kLnBwdMaxChunks")
    for cols in FORM_WIDTHS:
        chunks = cols // 8
        per_row = next(t for t in (8, 16, 32, 64, 128) if chunks <= t * most)
        assert layernorm.BWD_FORM_ROWS_AT_A_TIME[cols] == threads // per_row
    assert set(layernorm.BWD_FORM_ROWS_AT_A_TIME) == set(FORM_WIDTHS)


def _inputs(d: int, x_dtype, g_dtype, seed: int):
    """x, dy, w, g as numpy fp32 (x and g already rounded to their dtypes)
    and as torch tensors of those dtypes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.5, (ROWS, d)).astype(np.float32)
    dy = rng.normal(0.0, 0.02, (ROWS, d)).astype(np.float32)
    w = rng.normal(1.0, 0.1, d).astype(np.float32)
    g = rng.normal(0.0, 0.05, (ROWS, d)).astype(np.float32)
    tx = torch.from_numpy(x).to(x_dtype)
    tg = None if g_dtype is None else torch.from_numpy(g).to(g_dtype)
    x = tx.float().numpy()
    g = None if tg is None else tg.float().numpy()
    return (x, dy, w, g), (tx, torch.from_numpy(dy), torch.from_numpy(w), tg)


def _jax_ln_bwd(x, dy, w, g):
    """The fused layer's LN backward: dx (+ g) in fp32, dw and db summed over
    the tokens by ``_csum``."""
    xhat, inv, _ = jfused._ln_fwd_stats(jnp.asarray(x), jnp.asarray(w),
                                        jnp.zeros_like(jnp.asarray(w)), EPS)
    dx, dw_rows, db_rows = jfused._ln_bwd(jnp.asarray(dy), xhat, inv, jnp.asarray(w))
    if g is not None:
        dx = jnp.asarray(g) + dx
    return (np.asarray(dx), np.asarray(jfused._csum(dw_rows))[0],
            np.asarray(jfused._csum(db_rows))[0])


def _rel_close(out: np.ndarray, ref: np.ndarray, rel: float = F32_REL):
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(out - ref).max()) <= rel * scale


@pytest.mark.parametrize("d", FORM_WIDTHS + [GENERAL_WIDTH])
@pytest.mark.parametrize("form", list(SETS))
def test_layer_norm_bwd_reference_matches_jax_at_width(no_launches, d, form):
    x_dtype, g_dtype, out_dtype = SETS[form]
    (x, dy, w, g), (tx, tdy, tw, tg) = _inputs(d, x_dtype, g_dtype, seed=d)
    ref_dx, ref_dw, ref_db = _jax_ln_bwd(x, dy, w, g)
    dx, dw, db = layernorm.layer_norm_bwd(tx, tdy, tw, EPS, residual=tg,
                                          out_dtype=out_dtype)
    assert dx.dtype == out_dtype and tuple(dx.shape) == (ROWS, d)
    assert dw.dtype == db.dtype == torch.float32 and tuple(dw.shape) == (d,)
    if out_dtype == torch.float32:
        _rel_close(dx.numpy(), ref_dx)
    else:
        ref = np.asarray(jnp.asarray(ref_dx, jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_allclose(dx.float().numpy(), ref, **BF16_TOL)
        assert (dx.float().numpy() == ref).mean() >= MIN_IDENTICAL_SHARE
    _rel_close(dw.numpy(), ref_dw)
    _rel_close(db.numpy(), ref_db)


# (config, batch, partial rows): the training chains' LN shapes (tokens x D)
# at the presets' B = 16 and 64; ViT-Ti at B = 16 is the one below the
# target (3152 rows, 16 at a time).
PARTIAL_ROWS = [(cfg, batch, 197 if (cfg, batch) == (VIT_TINY_16_224, 16) else 256)
                for cfg in (VIT_TINY_16_224, VIT_S_16_224, VIT_B_16_224,
                            VIT_L_16_384, VIT_H_14_224, VIT_G_14_224)
                for batch in (16, 64)]


@pytest.mark.parametrize("cfg,batch,expected", PARTIAL_ROWS,
                         ids=[f"{c.name}-B{b}" for c, b, _ in PARTIAL_ROWS])
def test_bwd_partial_rows_at_the_presets(cfg, batch, expected):
    rows, cols = batch * cfg.num_tokens, cfg.embed_dim
    n = layernorm.bwd_partial_rows(rows, cols)
    assert n == expected <= layernorm.COLSUM_ONE_PASS_ROWS
    # Every run holds at least the rows a block takes at a time.
    assert rows // n >= layernorm.BWD_FORM_ROWS_AT_A_TIME[cols]


@pytest.mark.parametrize("rows,cols,expected", [
    (ROWS, 768, 4), (ROWS, 1664, 19), (ROWS, 192, 1), (ROWS, GENERAL_WIDTH, 2),
    (3, 768, 1), (1, 64, 1), (4 * 256 - 1, 768, 255), (4 * 256, 768, 256)])
def test_bwd_partial_rows_at_few_rows(rows, cols, expected):
    """Fewer rows than the target: a block a run of at least the rows it
    takes at a time (a general width: 8), and at least one block."""
    assert layernorm.bwd_partial_rows(rows, cols) == expected

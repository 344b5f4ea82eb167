"""The int8 row quantize's plain versions at the widths that the card's
kernels take in their several forms, against the JAX package.

``csrc/quantize.cu`` compiles a form of its whole-row and split kernels for
each width of the presets' chains (``QuantWidths``: the D and MLP widths;
several warps a row from 3072 fp32 and 5120 bf16 up) and a general form
for any other.
On the card each form is held bit for bit to these plain versions
(``tests/test_torch_cuda.py``); here the plain versions are held bit for
bit to JAX's ``models/quant.quantize_act`` (the fused layer's
``_quantize_rows``) and to its outlier split (``_mm`` with ``hi_ref``:
``quantize_act`` of the leading ``m`` columns, the rest cast to bf16) at
those widths, on the same inputs made with numpy from a seed. On CPU
tensors no kernel may launch.
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

from vit_with_opencl_tpu.models import quant as jquant
from vit_with_opencl_tpu_torch.ops import quantize

FORM_WIDTHS = [192, 384, 768, 1024, 1280, 1536, 1664, 3072, 4096, 5120, 8192]
# Widths of no preset: the kernels' general form.
GENERAL_WIDTHS = [112, 400]
ROWS = 19  # ragged against the kernels' row groups and blocks
# The calibrated chains' splits at ViT-B (LN outputs 768 / 640, the GELU'd
# hidden 3072 / 2944), each other form with its last 128 columns (64 of
# 192) in the bf16 tail, and splits of the general widths.
SPLITS = ([(768, 640), (3072, 2944)]
          + [(k, k - (64 if k == 192 else 128)) for k in FORM_WIDTHS
             if k not in (768, 3072)]
          + [(112, 48), (400, 272)])
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture
def no_launches():
    before = (quantize.LAUNCHES, quantize.LAUNCHES_SPLIT, quantize.LAUNCHES_MASKED)
    yield
    assert (quantize.LAUNCHES, quantize.LAUNCHES_SPLIT,
            quantize.LAUNCHES_MASKED) == before


def _rows(k: int, seed: int) -> np.ndarray:
    """ROWS seeded rows of k values with a zero row (3: the 2^-93 floor) and
    a row (5) whose absmax is 127, so that r = 1 and its half-way values
    must round to even."""
    x = np.random.default_rng(seed).normal(0.0, 2.0, (ROWS, k)).astype(np.float32)
    x[3] = 0.0
    x[5] = 0.0
    x[5, :5] = [127.0, 2.5, 3.5, -2.5, 0.5]
    return x


def _same(out, ref) -> None:
    """Bit-identical: the same values and dtype, compared as raw bits."""
    out = out.numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.array_equal(out.view(np.uint8), ref.view(np.uint8))


def test_widths_cover_every_compile_time_form():
    """FORM_WIDTHS is the kernel source's list of forms."""
    src = (Path(quantize.__file__).resolve().parent.parent / "csrc" / "quantize.cu")
    found = re.search(r"using QuantWidths = Widths<([\d,\s]+)>;", src.read_text())
    assert found and [int(w) for w in found.group(1).split(",")] == FORM_WIDTHS


@pytest.mark.parametrize("k", FORM_WIDTHS + GENERAL_WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_rows_reference_matches_jax_at_width(no_launches, k, dtype):
    """``quantize_rows`` (its plain version on the CPU) against JAX's
    ``quantize_act`` on fp32 (the LN outputs, the GELU'd hidden) and bf16
    (the attention context) rows: codes and scales bit-identical."""
    tdt, jdt = DTYPES[dtype]
    x = _rows(k, seed=k)
    tx = torch.from_numpy(x).to(tdt)
    jq, js = jquant.quantize_act(jnp.asarray(x, jdt))
    q, s = quantize.quantize_rows(tx)
    _same(q, jq)
    _same(s, js)
    assert q.shape == (ROWS, k) and s.shape == (ROWS, 1)
    assert q[5, :5].tolist() == [127, 2, 4, -2, 0] and not q[3].any()


@pytest.mark.parametrize("k,m", SPLITS)
def test_quantize_rows_split_reference_matches_jax_split(no_launches, k, m):
    """``quantize_rows_split`` (its plain version on the CPU) against the JAX
    layer's split: ``quantize_act`` of the leading m columns, the trailing
    ones cast to bf16. The tail holds values above the kept absmax (they
    stay out of it) and values half-way between two bf16 numbers (they
    round to even)."""
    x = _rows(k, seed=k + m)
    x[5, m:m + 3] = [1e4, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8]
    x[7, m] = -3e5
    q, s, hi = quantize.quantize_rows_split(torch.from_numpy(x), m, torch.bfloat16)
    jq, js = jquant.quantize_act(jnp.asarray(x[:, :m]))
    jhi = jnp.asarray(x[:, m:]).astype(jnp.bfloat16)
    _same(q, jq)
    _same(s, js)
    _same(hi.view(torch.int16), np.asarray(jhi).view(np.int16))
    assert q.shape == (ROWS, m) and hi.shape == (ROWS, k - m)
    assert q[5, :5].tolist() == [127, 2, 4, -2, 0] and not q[3].any()
    assert hi[5, :3].float().tolist() == [9984.0, 1.0, 1.0 + 2.0 ** -6]

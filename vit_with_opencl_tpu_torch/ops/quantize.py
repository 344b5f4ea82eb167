"""Per-row int8 quantization: the CUDA kernels of ``csrc/quantize.cu`` and
their plain versions.

Replaces the per-token quantize inside
``vit_with_opencl_tpu/ops/fused_block.py:_block_kernel`` with ``w8a8=True``
(``_quantize_rows``), which runs before each of the W8A8 layer's four int8
GEMMs, and its two outlier-aware forms (``outlier=True``):

  * ``quantize_rows``: the whole row (plain version
    ``models/quant.quantize_act``: absmax with a 2⁻⁹³ floor, one IEEE divide
    per row, round half to even, the scale as absmax times float32(1/127));
  * ``quantize_rows_split``: the leading ``m`` columns of the fp32 LN
    output or GELU'd hidden quantized, the trailing ones rounded to bf16 for
    the side GEMM (``_mm`` with ``hi_ref``; plain version
    ``quant.quantize_act_split``);
  * ``quantize_rows_masked``: each head's last ``kh`` columns of the bf16
    attention context left out of the absmax, clipped, and copied out in
    head order (``_mm_ctx_masked``; plain version
    ``quant.quantize_act_masked``).

Each kernel is bit-identical to its plain version. Bound on the card: bytes
(see the note in the source). Each wrapper launches its kernel for a CUDA
tensor and computes its plain version for a CPU tensor; there is no other
fallback.

Under the attribution probe's ``quant_cheap`` substitution
(``ops/substitutions``) the plain versions of the first two follow
``models/quant.quantize_act``'s stand-in, and on the card they launch their
cheap forms (``vit_quantize_rows_cheap``, ``vit_quantize_rows_split_cheap``:
the same loads and stores, the codes the values truncated toward zero and
saturated, a scale of 1.0; compiled at the widths of ``CHEAP_WIDTHS`` only,
any other width raises ``NotImplementedError``), counted under the real
kernels' counts. The masked quantize stays real, as in JAX, whose masked
branch does not call ``quantize_act``.
"""

from __future__ import annotations

import torch

from ..models.quant import quantize_act as quantize_rows_reference
from ..models.quant import quantize_act_masked as quantize_rows_masked_reference
from ..models.quant import quantize_act_split as quantize_rows_split_reference
from . import _build, substitutions

# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): the whole-row, split and masked forms.
LAUNCHES = 0
LAUNCHES_SPLIT = 0
LAUNCHES_MASKED = 0

# The widths at which the cheap forms are compiled (csrc/quantize.cu
# QuantWidths: the presets' D and MLP widths).
CHEAP_WIDTHS = (192, 384, 768, 1024, 1280, 1536, 1664, 3072, 4096, 5120, 8192)


def _cheap_entry(name: str, what: str, cols: int) -> str:
    """The cheap form's entry point of ``name`` under ``quant_cheap``, else
    ``name``."""
    if not substitutions.QUANT_CHEAP:
        return name
    if cols not in CHEAP_WIDTHS:
        substitutions.refuse(f"{what} at width {cols} (the stand-in is built "
                             f"for {CHEAP_WIDTHS})", "quant_cheap")
    substitutions.check_launch(what)
    return name + "_cheap"


def _rows(x: torch.Tensor, q_cols: int) -> int:
    """Check x for a kernel whose int8 output has ``q_cols`` columns; the
    number of rows. Under autograd a quantize has no gradient to give (the
    JAX package trains no quantized path): it refuses to run."""
    _build.refuse_autograd("the int8 quantize", (x,),
                           "an unquantized layer (training quantizes "
                           "nothing)")
    if q_cols % 16:
        raise ValueError(f"K={q_cols} must be a multiple of 16 (the int8 "
                         "GEMMs' 16-byte chunks)")
    _build.require(x, "x", device=x.device, dtypes=tuple(_build.DTYPE_CODES))
    k = x.shape[-1]
    return x.numel() // k if k else 0


def _int8_and_scale(x: torch.Tensor, k: int):
    q = torch.empty((*x.shape[:-1], k), dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                        device=x.device)
    return q, scale


def quantize_rows(x: torch.Tensor):
    """x [..., K] (fp32 or bf16) → (int8 [..., K], fp32 scale [..., 1])."""
    global LAUNCHES
    if not x.is_cuda:
        return quantize_rows_reference(x)
    k = x.shape[-1]
    rows = _rows(x, k)
    q, scale = _int8_and_scale(x, k)
    if rows == 0:
        return q, scale
    err = _build.launch(_cheap_entry("vit_quantize_rows", "quantize_rows", k), x,
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], q.data_ptr(),
        scale.data_ptr(), rows, k)
    _build.check_launch(err, "quantize_rows")
    LAUNCHES += 1
    return q, scale


def quantize_rows_split(x: torch.Tensor, m: int, hi_dtype: torch.dtype):
    """x [..., K] → (int8 [..., m], fp32 scale [..., 1], hi [..., K - m] in
    ``hi_dtype``): the leading ``m`` columns quantized with the absmax over
    those only, the trailing ones cast (to bf16: rounded to nearest even).
    The kernel takes an fp32 x and gives a bf16 hi; m must be a multiple of
    16 and K - m of 4."""
    global LAUNCHES_SPLIT
    if not x.is_cuda:
        return quantize_rows_split_reference(x, m, hi_dtype)
    k = x.shape[-1]
    if not 0 < m < k or (k - m) % 4:
        raise ValueError(f"split at m={m} of K={k}: need 0 < m < K and K - m "
                         "a multiple of 4")
    if x.dtype != torch.float32 or hi_dtype != torch.bfloat16:
        raise TypeError(f"the split quantize kernel takes fp32 x and gives a "
                        f"bf16 hi (got x {x.dtype}, hi {hi_dtype})")
    rows = _rows(x, m)
    q, scale = _int8_and_scale(x, m)
    hi = torch.empty((*x.shape[:-1], k - m), dtype=hi_dtype, device=x.device)
    if rows == 0:
        return q, scale, hi
    err = _build.launch(_cheap_entry("vit_quantize_rows_split",
                                     "quantize_rows_split", k), x,
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), hi.data_ptr(), rows, k,
        m)
    _build.check_launch(err, "quantize_rows_split")
    LAUNCHES_SPLIT += 1
    return q, scale, hi


def quantize_rows_masked(x: torch.Tensor, num_heads: int, head_dim: int,
                         kh: int):
    """The attention context x [..., D = num_heads * head_dim] → (int8
    [..., D], fp32 scale [..., 1], hi [..., num_heads * kh] in x's dtype):
    each head's last ``kh`` columns left out of the absmax, clipped to ±127
    in q, and copied to hi in head order. The kernel takes a bf16 x."""
    global LAUNCHES_MASKED
    if not x.is_cuda:
        return quantize_rows_masked_reference(x, num_heads, head_dim, kh)
    k = x.shape[-1]
    if k != num_heads * head_dim or not 0 < kh < head_dim:
        raise ValueError(f"K={k} is not num_heads * head_dim = {num_heads} * "
                         f"{head_dim}, or kh={kh} is not in (0, head_dim)")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the masked quantize kernel takes a bf16 x, got {x.dtype}")
    rows = _rows(x, k)
    q, scale = _int8_and_scale(x, k)
    hi = torch.empty((*x.shape[:-1], num_heads * kh), dtype=x.dtype,
                     device=x.device)
    if rows == 0:
        return q, scale, hi
    err = _build.launch("vit_quantize_rows_masked", x,
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), hi.data_ptr(), rows, k,
        head_dim, kh)
    _build.check_launch(err, "quantize_rows_masked")
    LAUNCHES_MASKED += 1
    return q, scale, hi

"""LayerNorm: the CUDA kernel ``csrc/layernorm.cu`` and its plain version.

Replaces ``vit_with_opencl_tpu/ops/layernorm.py:_ln_kernel`` (``layer_norm``)
and is the LN link of the encoder chain (``ops/fused_block.py``). fp32
statistics with var = E[x²]−E[x]², as the golden model. Bound on the card:
bytes; the kernel reads each row once in 16-byte vectors, holds it in
registers until its write, and reduces with shuffles (see the note in the
source).

``layer_norm`` launches the kernel for a CUDA tensor and computes
``layer_norm_reference`` for a CPU tensor; there is no other fallback. On
the card it refuses to run under autograd (its result would carry no
graph).

``residual_layer_norm`` replaces ``_ln_residual_kernel`` (JAX's
``residual_layer_norm``, a public op of the kernel layer that no forward of
either package calls): s = x + residual in fp32, returned rounded to x's
dtype beside LN(s), whose statistics come from the fp32 s. Its kernel is the
row kernel's residual form (``csrc/layernorm.cu``).

The training backward adds two kernels: ``layer_norm_bwd`` (the LN
backward of ``ops/fused_block.py:_ln_bwd``, ``csrc/layernorm.cu``), which
also writes per-block partial column sums of ``dy·x̂`` and ``dy``, and
``column_sum`` (``csrc/reduce.cu``), the token-axis sum ``_csum`` that
finishes those partials and gives the bias gradients.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build

# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): the forward, its residual form, the backward, and the column sum.
LAUNCHES = 0
LAUNCHES_RESIDUAL = 0
LAUNCHES_BWD = 0
LAUNCHES_COLSUM = 0
# The column sum's chunks (csrc/reduce.cu): up to COLSUM_ONE_PASS_ROWS rows
# in one pass; past that, chunks of at least COLSUM_MIN_CHUNK_ROWS rows, as
# many as give about COLSUM_TARGET_BLOCKS blocks of 32 column vectors (4 an
# SM of an H100) in the first pass.
COLSUM_ONE_PASS_ROWS = 256
COLSUM_MIN_CHUNK_ROWS = 32
COLSUM_TARGET_BLOCKS = 4 * 132
COLSUM_TILE_VECTORS = 32
# The backward kernel's blocks (one partial row of dw and db each): up to
# BWD_TARGET_BLOCKS, none with fewer rows than it takes at a time. The
# target is the column sum's one-pass limit, so that each of dw and db is
# finished by one launch (at 528 blocks, 4 an SM of an H100, the second
# pass of each cost more than the row kernel gained). The compile-time forms
# take rows in blocks of 128 threads (``csrc/layernorm.cu`` ``LnBwdShape``:
# 8 to 128 threads a row, a thread holding at most 3 chunks of 8 columns),
# the general form a row a warp of 8.
BWD_TARGET_BLOCKS = COLSUM_ONE_PASS_ROWS
BWD_FORM_ROWS_AT_A_TIME = {192: 16, 384: 8, 768: 4, 1024: 2, 1280: 2, 1664: 1}
BWD_GENERAL_ROWS_AT_A_TIME = 8


def layer_norm_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         eps: float = 1e-6, *,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-token LN over the last axis in fp32; result in ``out_dtype``
    (default: x's dtype)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean_sq = (xf * xf).mean(-1, keepdim=True)
    var = mean_sq - mean * mean
    inv = torch.rsqrt(var + eps)
    out = (xf - mean) * inv * w.float() + b.float()
    return out.to(out_dtype or x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6, *,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LN of ``x`` [..., D] (bf16 or fp32) with fp32 ``w``, ``b`` [D];
    result in ``out_dtype`` (bf16 or fp32, default x's dtype)."""
    global LAUNCHES
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return layer_norm_reference(x, w, b, eps, out_dtype=out_dtype)
    d = x.shape[-1]
    dtypes = tuple(_build.DTYPE_CODES)
    _build.require(x, "x", device=x.device, dtypes=dtypes)
    _build.require(w, "w", device=x.device, dtypes=(torch.float32,), shape=(d,))
    _build.require(b, "b", device=x.device, dtypes=(torch.float32,), shape=(d,))
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in {dtypes}")
    _build.refuse_autograd("layer_norm", (x, w, b),
                           "ops/fused_block.fused_encoder_layer_trainable")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rows = x.numel() // d
    if rows == 0:
        return out
    err = _build.launch("vit_layernorm", x,
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], w.data_ptr(), b.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[out_dtype], rows, d, eps)
    _build.check_launch(err, "layer_norm")
    LAUNCHES += 1
    return out


def residual_layer_norm_reference(x: torch.Tensor, residual: torch.Tensor,
                                  w: torch.Tensor, b: torch.Tensor,
                                  eps: float = 1e-6):
    """(LN(x + residual), x + residual), both in x's dtype: the sum in fp32,
    the statistics of the fp32 sum, w and b read as fp32."""
    s = x.float() + residual.float()
    mean = s.mean(-1, keepdim=True)
    mean_sq = (s * s).mean(-1, keepdim=True)
    inv = torch.rsqrt(mean_sq - mean * mean + eps)
    out = (s - mean) * inv * w.float() + b.float()
    return out.to(x.dtype), s.to(x.dtype)


def residual_layer_norm(x: torch.Tensor, residual: torch.Tensor,
                        w: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    """(x + residual) then LayerNorm, one pass over [..., D]: returns
    ``(normalized, summed)`` in x's dtype (bf16 or fp32; the residual bf16
    or fp32 too). ``w`` and ``b`` [D] may be any float dtype."""
    global LAUNCHES_RESIDUAL
    if x.shape != residual.shape:
        raise ValueError(f"x {tuple(x.shape)} and residual "
                         f"{tuple(residual.shape)} differ")
    if not x.is_cuda:
        return residual_layer_norm_reference(x, residual, w, b, eps)
    d = x.shape[-1]
    dtypes = tuple(_build.DTYPE_CODES)
    _build.require(x, "x", device=x.device, dtypes=dtypes)
    _build.require(residual, "residual", device=x.device, dtypes=dtypes)
    w32, b32 = w.float().contiguous(), b.float().contiguous()
    _build.require(w32, "w", device=x.device, dtypes=(torch.float32,), shape=(d,))
    _build.require(b32, "b", device=x.device, dtypes=(torch.float32,), shape=(d,))
    _build.refuse_autograd("residual_layer_norm", (x, residual, w, b),
                           "ops/fused_block.fused_encoder_layer_trainable")
    out = torch.empty_like(x)
    summed = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out, summed
    err = _build.launch("vit_layernorm_residual", x,
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], residual.data_ptr(),
        _build.DTYPE_CODES[residual.dtype], w32.data_ptr(), b32.data_ptr(),
        out.data_ptr(), summed.data_ptr(), rows, d, eps)
    _build.check_launch(err, "residual_layer_norm")
    LAUNCHES_RESIDUAL += 1
    return out, summed


def column_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the last, in fp32: [..., C] → [C]."""
    return x.reshape(-1, x.shape[-1]).float().sum(0)


@functools.lru_cache(maxsize=None)
def column_sum_rows_per_chunk(rows: int, cols: int, itemsize: int) -> int:
    """The rows of a chunk of ``column_sum``'s first pass over [rows, cols]
    of ``itemsize``-byte elements: all of them (one pass) up to
    COLSUM_ONE_PASS_ROWS, else enough chunks to give the first pass about
    COLSUM_TARGET_BLOCKS blocks, each at least COLSUM_MIN_CHUNK_ROWS rows.
    It depends on the shape alone, so the order of every column's sum does
    too."""
    if rows <= COLSUM_ONE_PASS_ROWS:
        return rows
    per_vec = 16 // itemsize
    vectors = cols // per_vec if cols % per_vec == 0 else cols
    tiles = -(-vectors // COLSUM_TILE_VECTORS)
    chunks = -(-COLSUM_TARGET_BLOCKS // tiles)
    return max(-(-rows // chunks), COLSUM_MIN_CHUNK_ROWS)


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the last (the token axis of ``_csum``):
    ``x`` [..., C] fp32 or bf16 → fp32 [C], without atomics and in an order
    fixed by the shape (the same result from run to run): one launch up to
    COLSUM_ONE_PASS_ROWS rows, else a pass over chunks of rows and a pass
    over their partial sums."""
    global LAUNCHES_COLSUM
    if not x.is_cuda:
        return column_sum_reference(x)
    _build.require(x, "x", device=x.device, dtypes=tuple(_build.DTYPE_CODES))
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    if rows == 0 or c == 0:
        return torch.zeros((c,), dtype=torch.float32, device=x.device)
    out = torch.empty((c,), dtype=torch.float32, device=x.device)
    per_chunk = column_sum_rows_per_chunk(rows, c, x.element_size())
    chunks = -(-rows // per_chunk)
    partial = (torch.empty((chunks, c), dtype=torch.float32, device=x.device)
               if chunks > 1 else None)
    err = _build.launch("vit_column_sum", x,
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], out.data_ptr(),
        None if partial is None else partial.data_ptr(), rows, c, per_chunk)
    _build.check_launch(err, "column_sum")
    LAUNCHES_COLSUM += 1
    return out


def bwd_partial_rows(rows: int, cols: int) -> int:
    """The n partial rows of dw and db that the backward kernel writes for
    [rows, cols]: one a block, block b summing rows [b·rows // n,
    (b + 1)·rows // n). BWD_TARGET_BLOCKS, or fewer where a block would get
    fewer rows than it takes at a time. It depends on the shape alone, so
    the order of every column's sum does too."""
    at_a_time = BWD_FORM_ROWS_AT_A_TIME.get(cols, BWD_GENERAL_ROWS_AT_A_TIME)
    return max(1, min(BWD_TARGET_BLOCKS, rows // at_a_time))


def layer_norm_bwd_reference(x: torch.Tensor, dy: torch.Tensor,
                             w: torch.Tensor, eps: float = 1e-6, *,
                             residual: Optional[torch.Tensor] = None,
                             out_dtype: Optional[torch.dtype] = None):
    """LN backward with the statistics recomputed from ``x``: (dx, dw, db)
    with dx = inv·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)), dx̂ = dy·w, plus
    ``residual`` (added first) in ``out_dtype`` (default x's), and the
    fp32 column sums dw = Σ dy·x̂, db = Σ dy over every token
    (``fused_block._ln_fwd_stats`` and ``_ln_bwd``)."""
    from .fused_block import _ln_bwd, _ln_fwd_stats

    xhat, inv, _ = _ln_fwd_stats(x.float(), w, torch.zeros_like(w), eps)
    dx, dw_rows, db_rows = _ln_bwd(dy.float(), xhat, inv, w)
    if residual is not None:
        dx = residual.float() + dx
    return (dx.to(out_dtype or x.dtype), column_sum_reference(dw_rows),
            column_sum_reference(db_rows))


def layer_norm_bwd(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6, *,
                   residual: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None):
    """LN backward of ``x`` [..., D] (fp32 or bf16) for the fp32 output
    gradient ``dy``: (dx in ``out_dtype``, default x's, plus ``residual``
    [..., D] fp32 or bf16 if given; fp32 dw [D]; fp32 db [D]). The row
    kernel writes per-block partial column sums (``bwd_partial_rows``),
    which ``column_sum`` finishes."""
    global LAUNCHES_BWD
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return layer_norm_bwd_reference(x, dy, w, eps, residual=residual,
                                        out_dtype=out_dtype)
    d = x.shape[-1]
    dtypes = tuple(_build.DTYPE_CODES)
    _build.require(x, "x", device=x.device, dtypes=dtypes)
    _build.require(dy, "dy", device=x.device, dtypes=(torch.float32,),
                   shape=tuple(x.shape))
    _build.require(w, "w", device=x.device, dtypes=(torch.float32,), shape=(d,))
    if residual is not None:
        _build.require(residual, "residual", device=x.device, dtypes=dtypes,
                       shape=tuple(x.shape))
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in {dtypes}")
    rows = x.numel() // d if d else 0
    dx = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if rows == 0:
        zeros = torch.zeros((d,), dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    blocks = bwd_partial_rows(rows, d)
    partial = torch.empty((2, blocks, d), dtype=torch.float32, device=x.device)
    err = _build.launch("vit_layernorm_bwd", x,
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], dy.data_ptr(), w.data_ptr(),
        None if residual is None else residual.data_ptr(),
        _build.DTYPE_CODES[residual.dtype] if residual is not None else 0,
        dx.data_ptr(), _build.DTYPE_CODES[out_dtype], partial[0].data_ptr(),
        partial[1].data_ptr(), rows, d, blocks, eps)
    _build.check_launch(err, "layer_norm_bwd")
    LAUNCHES_BWD += 1
    return dx, column_sum(partial[0]), column_sum(partial[1])

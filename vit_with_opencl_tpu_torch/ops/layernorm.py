"""LayerNorm: the CUDA kernel ``csrc/layernorm.cu`` and its plain version.

Replaces ``vit_with_opencl_tpu/ops/layernorm.py:_ln_kernel`` (``layer_norm``)
and is the LN link of the encoder chain (``ops/fused_block.py``). fp32
statistics with var = E[x²]−E[x]², as the golden model. Bound on the card:
bytes; the kernel gives each row one warp and reduces with shuffles (see
the note in the source).

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

from typing import Optional

import torch

from . import _build

# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): the forward, its residual form, the backward, and the column sum.
LAUNCHES = 0
LAUNCHES_RESIDUAL = 0
LAUNCHES_BWD = 0
LAUNCHES_COLSUM = 0
# Rows per block of the backward kernel: one partial row of dw and db each.
BWD_ROWS_PER_BLOCK = 64


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


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the last (the token axis of ``_csum``):
    ``x`` [..., C] fp32 or bf16 → fp32 [C], in two passes without atomics
    (the same result from run to run)."""
    global LAUNCHES_COLSUM
    if not x.is_cuda:
        return column_sum_reference(x)
    _build.require(x, "x", device=x.device, dtypes=tuple(_build.DTYPE_CODES))
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    if rows == 0 or c == 0:
        return torch.zeros((c,), dtype=torch.float32, device=x.device)
    out = torch.empty((c,), dtype=torch.float32, device=x.device)
    partial = torch.empty((-(-rows // 64), c), dtype=torch.float32,
                          device=x.device)
    err = _build.launch("vit_column_sum", x,
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], out.data_ptr(),
        partial.data_ptr(), rows, c)
    _build.check_launch(err, "column_sum")
    LAUNCHES_COLSUM += 1
    return out


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
    kernel writes per-block partial column sums, which ``column_sum``
    finishes."""
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
    blocks = -(-rows // BWD_ROWS_PER_BLOCK)
    partial = torch.empty((2, blocks, d), dtype=torch.float32, device=x.device)
    err = _build.launch("vit_layernorm_bwd", x,
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], dy.data_ptr(), w.data_ptr(),
        None if residual is None else residual.data_ptr(),
        _build.DTYPE_CODES[residual.dtype] if residual is not None else 0,
        dx.data_ptr(), _build.DTYPE_CODES[out_dtype], partial[0].data_ptr(),
        partial[1].data_ptr(), rows, d, eps)
    _build.check_launch(err, "layer_norm_bwd")
    LAUNCHES_BWD += 1
    return dx, column_sum(partial[0]), column_sum(partial[1])

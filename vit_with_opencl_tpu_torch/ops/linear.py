"""Fused linear layer: the CUDA GEMM ``csrc/linear.cu`` and its plain version.

Replaces ``vit_with_opencl_tpu/ops/linear.py:_linear_kernel``
(``fused_linear``) and is the GEMM link of the encoder chain
(``ops/fused_block.py``). ``x @ w`` accumulates in fp32; the epilogue adds,
in fp32 and in this order, an optional residual, the bias, the optional
``_gelu_fast``, and casts to ``out_dtype``. The residual and ``out_dtype``
are the port's additions for the chain: the layer keeps its residual stream
in fp32 between kernels. Bound on the card: operations (see the note in the
source). The kernel takes bf16 ``x`` and ``w``; fp32 inputs on the card are
not supported in this slice.

``fused_linear`` launches the kernel for a CUDA tensor and computes
``fused_linear_reference`` for a CPU tensor; there is no other fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it).
LAUNCHES = 0

_RESIDUAL_KINDS = {None: 0, torch.float32: 1, torch.bfloat16: 2}


def fused_linear_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    fuse_gelu: bool = False,
    residual: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``epilogue(x @ w)`` with an fp32-output GEMM (never a bf16-output
    matmul, which would round where the reference does not)."""
    from .fused_block import _gelu_fast

    *lead, k = x.shape
    n = w.shape[1]
    out = x.reshape(-1, k).float() @ w.float()
    if residual is not None:
        out = residual.reshape(-1, n).float() + out
    if b is not None:
        out = out + b.float()
    if fuse_gelu:
        out = _gelu_fast(out)
    return out.to(out_dtype or x.dtype).reshape(*lead, n)


def fused_linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    fuse_gelu: bool = False,
    residual: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x`` [..., K] @ ``w`` [K, N] (right-multiply layout) with bias ``b``
    [N] (fp32), an optional ``residual`` [..., N] (fp32 or bf16) added before
    the bias, and an optional ``_gelu_fast``. Result in ``out_dtype``
    (default x's dtype)."""
    global LAUNCHES
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return fused_linear_reference(x, w, b, fuse_gelu=fuse_gelu,
                                      residual=residual, out_dtype=out_dtype)
    *lead, k = x.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA GEMM takes bf16 x and w; an fp32 variant is not "
            f"ported yet (got x {x.dtype}, w {w.dtype})")
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w has shape {tuple(w.shape)}, expected ({k}, N)")
    n = w.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"K={k} and N={n} must be multiples of 8")
    _build.require(x, "x", device=x.device, dtypes=(torch.bfloat16,))
    _build.require(w, "w", device=x.device, dtypes=(torch.bfloat16,))
    if b is not None:
        _build.require(b, "b", device=x.device, dtypes=(torch.float32,),
                       shape=(n,))
    if residual is not None:
        _build.require(residual, "residual", device=x.device,
                       dtypes=(torch.float32, torch.bfloat16),
                       shape=(*lead, n))
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    out = torch.empty((*lead, n), dtype=out_dtype, device=x.device)
    m = x.numel() // k
    if m == 0:
        return out
    err = _build.library().vit_linear_bf16(
        x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
        residual.data_ptr() if residual is not None else None,
        _RESIDUAL_KINDS[None if residual is None else residual.dtype],
        out.data_ptr(), int(out_dtype == torch.bfloat16), int(fuse_gelu),
        m, n, k, _build.stream_handle(x))
    _build.check_launch(err, "fused_linear")
    LAUNCHES += 1
    return out

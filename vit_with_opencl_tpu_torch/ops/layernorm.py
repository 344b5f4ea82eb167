"""LayerNorm: the CUDA kernel ``csrc/layernorm.cu`` and its plain version.

Replaces ``vit_with_opencl_tpu/ops/layernorm.py:_ln_kernel`` (``layer_norm``)
and is the LN link of the encoder chain (``ops/fused_block.py``). fp32
statistics with var = E[x²]−E[x]², as the golden model. Bound on the card:
bytes; the kernel gives each row one warp and reduces with shuffles (see
the note in the source).

``layer_norm`` launches the kernel for a CUDA tensor and computes
``layer_norm_reference`` for a CPU tensor; there is no other fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it).
LAUNCHES = 0


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
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    rows = x.numel() // d
    if rows == 0:
        return out
    err = _build.library().vit_layernorm(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], w.data_ptr(), b.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[out_dtype], rows, d, eps,
        _build.stream_handle(x))
    _build.check_launch(err, "layer_norm")
    LAUNCHES += 1
    return out

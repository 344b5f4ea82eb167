"""Per-row int8 quantization: the CUDA kernel ``csrc/quantize.cu`` and its
plain version.

Replaces the per-token quantize inside
``vit_with_opencl_tpu/ops/fused_block.py:_block_kernel`` with ``w8a8=True``
(``_quantize_rows``), which runs before each of the W8A8 layer's four int8
GEMMs. The plain version is ``models/quant.quantize_act``: absmax with a
2⁻⁹³ floor, one IEEE divide per row, round half to even, and the scale as
absmax times float32(1/127). Bound on the card: bytes (see the note in the
source).

``quantize_rows`` launches the kernel for a CUDA tensor and computes
``quantize_rows_reference`` for a CPU tensor; there is no other fallback.
"""

from __future__ import annotations

import torch

from ..models.quant import quantize_act as quantize_rows_reference
from . import _build

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it).
LAUNCHES = 0


def quantize_rows(x: torch.Tensor):
    """x [..., K] (fp32 or bf16) → (int8 [..., K], fp32 scale [..., 1])."""
    global LAUNCHES
    if not x.is_cuda:
        return quantize_rows_reference(x)
    k = x.shape[-1]
    if k % 16:
        raise ValueError(f"K={k} must be a multiple of 16 (the int8 GEMMs' "
                         "16-byte chunks)")
    _build.require(x, "x", device=x.device, dtypes=tuple(_build.DTYPE_CODES))
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                        device=x.device)
    rows = x.numel() // k if k else 0
    if rows == 0:
        return q, scale
    err = _build.library().vit_quantize_rows(
        x.data_ptr(), _build.DTYPE_CODES[x.dtype], q.data_ptr(),
        scale.data_ptr(), rows, k, _build.stream_handle(x))
    _build.check_launch(err, "quantize_rows")
    LAUNCHES += 1
    return q, scale

"""Numerically stable softmax, kept as a named op of the kernel layer.

Counterpart of ``vit_with_opencl_tpu/ops/softmax.py``, which leaves it to
XLA (``jax.nn.softmax`` in fp32): it has no Pallas kernel, so the port has
no CUDA kernel for it either, only these PyTorch ops (on any device).
"""

from __future__ import annotations

import torch


def softmax(logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Stable softmax in fp32, result cast back to the input dtype."""
    return torch.softmax(logits.float(), dim=axis).to(logits.dtype)

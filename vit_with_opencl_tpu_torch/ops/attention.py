"""Packed-QKV attention: the CUDA kernel ``csrc/attention.cu`` and its plain
version.

Replaces ``vit_with_opencl_tpu/ops/attention.py:_packed_kernel``
(``packed_fused_attention``): [B, T, 3D] packed q|k|v slabs in, the
head-major context [B, T, D] out, with the per-head numerics of
``_head_attention`` (q scaled in the input dtype, fp32 scores and whole-row
softmax, normalisation after the PV product). It is also the attention link
of the encoder chain (``ops/fused_block.py``). Bound on the card: bytes at
ViT-B's 197 tokens (see the note in the source).

``packed_fused_attention`` launches the kernel for a CUDA tensor and
computes ``packed_fused_attention_reference`` for a CPU tensor; there is no
other fallback. Not ported yet: "per_head" packing and ``true_seq_len``
(the tensor-parallel and sequence-parallel callers), and sequences whose
K and V do not fit one block's shared memory (the JAX package's blockwise
route); those raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ViTConfig
from . import _build

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it).
LAUNCHES = 0

# Hopper's largest dynamic shared memory for one block.
MAX_SMEM_BYTES = 227 * 1024


def _head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q·scale @ kᵀ) @ v over the last two axes, fp32 output.

    The reference's rounding points: q is scaled in its own dtype, scores and
    the softmax are fp32, the unnormalised weights are cast to v's dtype for
    the PV product, and the 1/rowsum scales the output, not the weights."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = qs.float() @ k.float().transpose(-1, -2)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    inv = 1.0 / e.sum(-1, keepdim=True)
    o = e.to(v.dtype).float() @ v.float()
    return o * inv


def packed_fused_attention_reference(qkv: torch.Tensor, num_heads: int,
                                     head_dim: int) -> torch.Tensor:
    """Plain version: slab-packed [B, T, 3D] → head-major [B, T, D]. Slab
    packing puts head h's q, k and v at columns h·hd, D + h·hd and 2D + h·hd
    (the JAX package's ``_packed_offsets``), which is this reshape."""
    b, t, _ = qkv.shape
    q, k, v = qkv.reshape(b, t, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    o = _head_attention(q, k, v, float(1.0 / np.sqrt(head_dim)))
    return o.permute(0, 2, 1, 3).reshape(b, t, num_heads * head_dim).to(qkv.dtype)


def kernel_smem_bytes(seq_len: int, head_dim: int) -> int:
    """Shared memory of one block of the kernel: K and Vᵀ of one head."""
    tp = -(-seq_len // 16) * 16
    hdp = -(-head_dim // 16) * 16
    return (tp * (hdp + 8) + hdp * (tp + 8)) * 2


def packed_fused_attention(
    qkv: torch.Tensor,
    config: Optional[ViTConfig] = None,
    *,
    num_heads: Optional[int] = None,
    head_dim: Optional[int] = None,
    packing: str = "slab",
    true_seq_len: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention over packed QKV: [B, T, 3D] → [B, T, D]."""
    global LAUNCHES
    b, t, three_d = qkv.shape
    nh = num_heads if num_heads is not None else config.num_heads
    hd = head_dim if head_dim is not None else config.head_dim
    d = nh * hd
    if three_d != 3 * d:
        raise ValueError(f"qkv last dim {three_d} != 3 * {d}")
    if packing not in ("slab", "per_head"):
        raise ValueError(f"unknown packing {packing!r}")
    if packing != "slab" or true_seq_len is not None:
        raise NotImplementedError(
            "per_head packing and true_seq_len are not ported yet")
    if not qkv.is_cuda:
        return packed_fused_attention_reference(qkv, nh, hd)
    if qkv.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA attention kernel takes bf16 qkv, got {qkv.dtype}")
    if hd % 8 or hd > 128:
        raise NotImplementedError(
            f"head_dim {hd}: the kernel takes multiples of 8 up to 128")
    if kernel_smem_bytes(t, hd) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"T={t}: K and V of one head exceed one block's shared memory; "
            "the blockwise long-sequence kernel is not ported yet")
    _build.require(qkv, "qkv", device=qkv.device, dtypes=(torch.bfloat16,))
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or t == 0:
        return out
    # `jnp.asarray(scale, q.dtype)`: the scale rounded once to bf16.
    scale = torch.tensor(float(1.0 / np.sqrt(hd)), dtype=torch.float64).to(
        torch.bfloat16).item()
    err = _build.library().vit_packed_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), b, t, nh, hd, scale,
        _build.stream_handle(qkv))
    _build.check_launch(err, "packed_fused_attention")
    LAUNCHES += 1
    return out

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

The backward, ``packed_attention_bwd``, replaces ``_packed_bwd_kernel``
with the two kernels of ``csrc/attention_bwd.cu`` (plain version
``packed_attention_bwd_reference``); ``packed_fused_attention_trainable``
is the differentiable form that training's ``flash`` route uses. The
forward wrapper refuses to run under autograd on the card (its result would
carry no graph); the trainable form is the way to train through it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ViTConfig
from . import _build

# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): the forward, and the backward (one per call: its two kernels).
LAUNCHES = 0
LAUNCHES_BWD = 0

# Hopper's largest dynamic shared memory for one block.
MAX_SMEM_BYTES = 227 * 1024
# Padded sequence lengths above this take the JAX package's blockwise
# (flash) route in training, which is not ported yet.
SINGLE_PASS_MAX_T = 1024


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
    _build.refuse_autograd("packed_fused_attention", (qkv,),
                           "packed_fused_attention_trainable")
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


# ---------------------------------------------------------------------------
# Backward (training)
# ---------------------------------------------------------------------------


def _split_heads(x: torch.Tensor, parts: int, num_heads: int,
                 head_dim: int) -> torch.Tensor:
    """[B, T, parts * D] slab-packed → [parts, B, H, T, hd]."""
    b, t, _ = x.shape
    return x.reshape(b, t, parts, num_heads, head_dim).permute(2, 0, 3, 1, 4)


def packed_attention_bwd_reference(qkv: torch.Tensor, do: torch.Tensor,
                                   num_heads: int, head_dim: int, *,
                                   out_dtype: Optional[torch.dtype] = None
                                   ) -> torch.Tensor:
    """Plain version of ``packed_attention_bwd`` with the TPU kernel's
    rounding points (``_packed_bwd_kernel``): the softmax recomputed as the
    forward's (q scaled in its dtype, fp32 scores), p normalised in fp32,
    ``ds = (p ⊙ (dp − rowsum(dp ⊙ p))) · scale`` rounded to qkv's dtype,
    ``dv = p(do's dtype)ᵀ · dO``, ``dq = ds · k``, ``dk = dsᵀ · q`` with the
    unscaled q, fp32 products; dqkv in ``out_dtype`` (default qkv's)."""
    b, t, _ = qkv.shape
    q, k, v = _split_heads(qkv, 3, num_heads, head_dim)
    doh = _split_heads(do, 1, num_heads, head_dim)[0]
    scale = float(1.0 / np.sqrt(head_dim))
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = qs.float() @ k.float().transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    dp = doh.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds * scale).to(qkv.dtype).float()
    dv = p.to(do.dtype).float().transpose(-1, -2) @ doh.float()
    dq = ds @ k.float()
    dk = ds.transpose(-1, -2) @ q.float()
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, t, 3 * num_heads * head_dim).to(
        out_dtype or qkv.dtype)


def kernel_bwd_smem_bytes(seq_len: int, head_dim: int) -> int:
    """Shared memory of the larger of the backward's two kernels (the dK/dV
    one): q scaled and transposed, dO and dOᵀ, and the rows' statistics."""
    tp = -(-seq_len // 16) * 16
    hdp = -(-head_dim // 16) * 16
    return (2 * tp * (hdp + 8) + 2 * hdp * (tp + 8)) * 2 + tp * 3 * 4


def packed_attention_bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                         head_dim: int, *,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused backward: (qkv [B, T, 3D], dO [B, T, D]) → dqkv [B, T, 3D] in
    ``out_dtype`` (default qkv's; the kernels write bf16 or fp32)."""
    global LAUNCHES_BWD
    b, t, three_d = qkv.shape
    d = num_heads * head_dim
    if three_d != 3 * d or tuple(do.shape) != (b, t, d):
        raise ValueError(f"qkv {tuple(qkv.shape)} and dO {tuple(do.shape)} do "
                         f"not fit {num_heads} heads of {head_dim}")
    out_dtype = out_dtype or qkv.dtype
    if not qkv.is_cuda:
        return packed_attention_bwd_reference(qkv, do, num_heads, head_dim,
                                              out_dtype=out_dtype)
    if qkv.dtype != torch.bfloat16 or do.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA attention backward takes bf16 qkv and dO, got "
            f"{qkv.dtype} and {do.dtype}")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    if head_dim % 8 or head_dim > 128:
        raise NotImplementedError(
            f"head_dim {head_dim}: the kernel takes multiples of 8 up to 128")
    if kernel_bwd_smem_bytes(t, head_dim) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"T={t}: q, dO and their transposes of one head exceed one "
            "block's shared memory; the blockwise backward "
            "(_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel) is not ported yet")
    _build.require(qkv, "qkv", device=qkv.device, dtypes=(torch.bfloat16,))
    _build.require(do, "do", device=qkv.device, dtypes=(torch.bfloat16,))
    out = torch.empty((b, t, 3 * d), dtype=out_dtype, device=qkv.device)
    if b == 0 or t == 0:
        return out
    stats = torch.empty((b, num_heads, t, 3), dtype=torch.float32,
                        device=qkv.device)
    q_scale = torch.tensor(float(1.0 / np.sqrt(head_dim)),
                           dtype=torch.float64).to(torch.bfloat16).item()
    ds_scale = float(np.float32(1.0 / np.sqrt(head_dim)))
    err = _build.library().vit_packed_attention_bwd(
        qkv.data_ptr(), do.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[out_dtype], stats.data_ptr(), b, t, num_heads,
        head_dim, q_scale, ds_scale, _build.stream_handle(qkv))
    _build.check_launch(err, "packed_attention_bwd")
    LAUNCHES_BWD += 1
    return out


class _PackedAttention(torch.autograd.Function):
    """The packed kernel forward, the fused backward; qkv is the only tensor
    saved (the backward recomputes the softmax)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim):
        ctx.save_for_backward(qkv)
        ctx.heads = (num_heads, head_dim)
        return packed_fused_attention(qkv, num_heads=num_heads,
                                      head_dim=head_dim)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return (packed_attention_bwd(qkv, g.contiguous(), *ctx.heads),
                None, None)


def packed_fused_attention_trainable(qkv: torch.Tensor, num_heads: int,
                                     head_dim: int) -> torch.Tensor:
    """Differentiable fused attention on packed [B, T, 3D] input: the packed
    kernel forward and ``packed_attention_bwd`` backward (the JAX package's
    route for padded T ≤ ``SINGLE_PASS_MAX_T``). First-order only."""
    t = qkv.shape[1]
    if max(-(-t // 128) * 128, 128) > SINGLE_PASS_MAX_T:
        raise NotImplementedError(
            f"T={t}: padded past {SINGLE_PASS_MAX_T}, the JAX package trains "
            "through its blockwise kernels (_flash_kernel_lse forward, "
            "_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel backward), which "
            "are not ported yet")
    return _PackedAttention.apply(qkv, num_heads, head_dim)

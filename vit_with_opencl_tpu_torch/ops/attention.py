"""Packed-QKV attention: the CUDA kernels ``csrc/attention.cu`` and
``csrc/attention_flash.cu`` and their plain versions.

Replaces ``vit_with_opencl_tpu/ops/attention.py:_packed_kernel``
(``packed_fused_attention``): [B, T, 3D] packed q|k|v slabs in, the
head-major context [B, T, D] out, with the per-head numerics of
``_head_attention`` (q scaled in the input dtype, fp32 scores and whole-row
softmax, normalisation after the PV product). It is also the attention link
of the encoder chain (``ops/fused_block.py``). Bound on the card: bytes at
ViT-B's 197 tokens (see the note in the source).

Past ``SINGLE_PASS_MAX_T`` (padded T > 1024, ``_is_long_seq``) the function
takes the JAX package's blockwise route instead, as JAX's does:
``blockwise_attention_fwd`` replaces ``_flash_kernel`` and
``_flash_kernel_lse`` (``_blockwise_fwd_flat``) with one kernel of
``csrc/attention_flash.cu`` that streams 128-key tiles through an online
softmax and optionally writes each row's log-sum-exp; its plain version is
``blockwise_attention_fwd_reference``. ``packed_fused_attention_reference``
routes the same way, so the chains' plain links compare like with like.

``packed_fused_attention`` launches a kernel for a CUDA tensor and computes
its plain version for a CPU tensor; there is no other fallback. Not ported
yet: "per_head" packing and ``true_seq_len`` (the tensor-parallel and
sequence-parallel callers), fp32 inputs on the card, and on the card
sequences of 849-1024 tokens at hd = 64 (fewer at larger hd): they stay on
the packed route, whose K and V no longer fit one block's shared memory
there; those raise ``NotImplementedError``.

The backward, ``packed_attention_bwd``, replaces ``_packed_bwd_kernel``
with the two kernels of ``csrc/attention_bwd.cu`` (plain version
``packed_attention_bwd_reference``), which stream their tiles and so take
any T; ``blockwise_attention_bwd`` replaces ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` (JAX's ``blockwise_attention_bwd``) with the dq and
dK/dV kernels of ``csrc/attention_flash.cu``, which rebuild p from the
forward's log-sum-exp (plain version ``blockwise_attention_bwd_reference``).
``packed_fused_attention_trainable`` is the differentiable form that
training's ``flash`` route uses, routed by ``_is_long_seq`` as JAX's. The
forward wrappers refuse to run under autograd on the card (their results
would carry no graph); the trainable form is the way to train through them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ViTConfig
from . import _build

# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): the packed forward, and its backward (one per call: its two
# kernels); the blockwise forward without and with the log-sum-exp, and the
# blockwise backward (one per call: its two kernels).
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_FLASH = 0
LAUNCHES_FLASH_LSE = 0
LAUNCHES_FLASH_BWD = 0

# Hopper's largest dynamic shared memory for one block.
MAX_SMEM_BYTES = 227 * 1024
# Padded sequence lengths above this take the JAX package's blockwise
# (flash) route, in inference and in training.
SINGLE_PASS_MAX_T = 1024
# The blockwise route's key tile: the running max moves once a tile, so the
# tile decides where p is rounded (JAX's DEFAULT_BLOCK_K).
FLASH_BLOCK_K = 128
# Masked scores (keys past T): -inf would give NaN on a fully masked row
# (attention.py:43).
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _is_long_seq(t: int) -> bool:
    """Whether JAX's packed attention takes the blockwise route at T = t."""
    return max(-(-t // 128) * 128, 128) > SINGLE_PASS_MAX_T


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
    (the JAX package's ``_packed_offsets``), which is this reshape. Long
    sequences take the blockwise route, as the kernel wrapper does."""
    b, t, _ = qkv.shape
    if _is_long_seq(t):
        return blockwise_attention_fwd_reference(qkv, num_heads, head_dim)[0]
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
    if _is_long_seq(t):
        return blockwise_attention_fwd(qkv, nh, hd)[0]
    if qkv.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA attention kernel takes bf16 qkv, got {qkv.dtype}")
    if hd % 8 or hd > 128:
        raise NotImplementedError(
            f"head_dim {hd}: the kernel takes multiples of 8 up to 128")
    if kernel_smem_bytes(t, hd) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"T={t}: K and V of one head exceed one block's shared memory "
            f"and the padded T is at most {SINGLE_PASS_MAX_T}, where the "
            "JAX package keeps the one-shot route; a kernel for that window "
            "is not ported yet")
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
# Blockwise (long-sequence) attention: forward, log-sum-exp and backward
# ---------------------------------------------------------------------------


def _flash_scale(head_dim: int) -> float:
    """1/sqrt(hd) as JAX's kernels apply it: a Python float multiplying
    fp32 scores, so rounded once to fp32."""
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def blockwise_attention_fwd_reference(qkv: torch.Tensor, num_heads: int,
                                      head_dim: int, *, return_lse: bool = False):
    """Plain version of ``blockwise_attention_fwd`` with ``_flash_kernel``'s
    arithmetic: fp32 scores times the fp32 scale, keys past T masked to
    MASK_VALUE, and a walk over key tiles of FLASH_BLOCK_K in order with
    the running max moved once a tile: ``p = exp(s − m_next)`` (rounded to
    v's dtype for the PV product, fp32 in the row sum), ``acc = acc·α + pv``.
    Returns (out [B, T, D] in qkv's dtype, acc · (1/l) with l == 0 → 1;
    lse [B, H, T] fp32, m + log(l), or None)."""
    b, t, _ = qkv.shape
    q, k, v = _split_heads(qkv, 3, num_heads, head_dim)
    t_pad = -(-t // FLASH_BLOCK_K) * FLASH_BLOCK_K
    pad = (0, 0, 0, t_pad - t)
    k = torch.nn.functional.pad(k, pad)
    v = torch.nn.functional.pad(v, pad)
    scale = _flash_scale(head_dim)
    qf = q.float()
    m = torch.full((b, num_heads, t, 1), -float("inf"), device=qkv.device)
    l = torch.zeros((b, num_heads, t, 1), device=qkv.device)
    acc = torch.zeros((b, num_heads, t, head_dim), device=qkv.device)
    for k0 in range(0, t_pad, FLASH_BLOCK_K):
        kt = k[..., k0:k0 + FLASH_BLOCK_K, :].float()
        s = (qf @ kt.transpose(-1, -2)) * scale
        col = torch.arange(k0, k0 + FLASH_BLOCK_K, device=qkv.device)
        s = torch.where(col < t, s, MASK_VALUE)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(-1, keepdim=True)
        vt = v[..., k0:k0 + FLASH_BLOCK_K, :]
        acc = acc * alpha + p.to(vt.dtype).float() @ vt.float()
        m = m_next
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc * torch.where(l == 0.0, 1.0, 1.0 / l)
    out = out.permute(0, 2, 1, 3).reshape(b, t, num_heads * head_dim)
    lse = (m + torch.log(l_safe))[..., 0] if return_lse else None
    return out.to(qkv.dtype), lse


def blockwise_attention_fwd(qkv: torch.Tensor, num_heads: int, head_dim: int,
                            *, return_lse: bool = False):
    """Blockwise attention over packed [B, T, 3D] at any T: (out [B, T, D]
    in qkv's dtype, lse [B, H, T] fp32 or None). The kernel reads q, k and
    v straight from the slabs (rows past T as zeros) and writes the
    head-major context, with or without each row's log-sum-exp."""
    global LAUNCHES_FLASH, LAUNCHES_FLASH_LSE
    b, t, three_d = qkv.shape
    d = num_heads * head_dim
    if three_d != 3 * d:
        raise ValueError(f"qkv last dim {three_d} != 3 * {d}")
    if not qkv.is_cuda:
        return blockwise_attention_fwd_reference(qkv, num_heads, head_dim,
                                                 return_lse=return_lse)
    if qkv.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA blockwise attention kernel takes bf16 qkv, got {qkv.dtype}")
    if head_dim % 8 or head_dim > 128:
        raise NotImplementedError(
            f"head_dim {head_dim}: the kernel takes multiples of 8 up to 128")
    _build.refuse_autograd("blockwise_attention_fwd", (qkv,),
                           "packed_fused_attention_trainable")
    _build.require(qkv, "qkv", device=qkv.device, dtypes=(torch.bfloat16,))
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, num_heads, t), dtype=torch.float32, device=qkv.device)
           if return_lse else None)
    if b == 0 or t == 0:
        return out, lse
    err = _build.library().vit_flash_attention_fwd(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None,
        b, t, num_heads, head_dim, _flash_scale(head_dim),
        _build.stream_handle(qkv))
    _build.check_launch(err, "blockwise_attention_fwd")
    if return_lse:
        LAUNCHES_FLASH_LSE += 1
    else:
        LAUNCHES_FLASH += 1
    return out, lse


def blockwise_attention_bwd_reference(qkv: torch.Tensor, out: torch.Tensor,
                                      lse: torch.Tensor, do: torch.Tensor,
                                      num_heads: int,
                                      head_dim: int) -> torch.Tensor:
    """Plain version of ``blockwise_attention_bwd`` with the arithmetic of
    ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``: ``dvec =
    rowsum(fp32(dO) ⊙ fp32(O))`` from the forward's rounded output, ``p =
    exp(s − lse)`` with s as the forward's, ``dp = dO · vᵀ``, ``ds =
    dtype((p ⊙ (dp − dvec)) · scale)``, ``dq = ds · k``, ``dk = dsᵀ · q``
    (the unscaled q), ``dv = dtype(p)ᵀ · dO``, fp32 sums; dqkv in qkv's
    dtype. Every key is below T here, so no column is masked."""
    b, t, _ = qkv.shape
    q, k, v = (z.float() for z in _split_heads(qkv, 3, num_heads, head_dim))
    o = _split_heads(out, 1, num_heads, head_dim)[0].float()
    doh = _split_heads(do, 1, num_heads, head_dim)[0].float()
    scale = _flash_scale(head_dim)
    dvec = (doh * o).sum(-1, keepdim=True)
    p = torch.exp((q @ k.transpose(-1, -2)) * scale - lse[..., None])
    dp = doh @ v.transpose(-1, -2)
    ds = ((p * (dp - dvec)) * scale).to(qkv.dtype).float()
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    dv = p.to(qkv.dtype).float().transpose(-1, -2) @ doh
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, t, 3 * num_heads * head_dim).to(qkv.dtype)


def blockwise_attention_bwd(qkv: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            num_heads: int, head_dim: int) -> torch.Tensor:
    """Blockwise backward: (qkv [B, T, 3D], the forward's out [B, T, D] and
    lse [B, H, T], dO [B, T, D]) → dqkv [B, T, 3D] in qkv's dtype, at any
    T. The dq kernel also computes dvec = rowsum(dO ⊙ O) for its rows, and
    the dK/dV kernel reads it."""
    global LAUNCHES_FLASH_BWD
    b, t, three_d = qkv.shape
    d = num_heads * head_dim
    if (three_d != 3 * d or tuple(do.shape) != (b, t, d)
            or tuple(out.shape) != (b, t, d)
            or tuple(lse.shape) != (b, num_heads, t)):
        raise ValueError(
            f"qkv {tuple(qkv.shape)}, out {tuple(out.shape)}, lse "
            f"{tuple(lse.shape)} and dO {tuple(do.shape)} do not fit "
            f"{num_heads} heads of {head_dim}")
    if not qkv.is_cuda:
        return blockwise_attention_bwd_reference(qkv, out, lse, do, num_heads,
                                                 head_dim)
    if any(z.dtype != torch.bfloat16 for z in (qkv, out, do)):
        raise NotImplementedError(
            f"the CUDA blockwise attention backward takes bf16 qkv, out and "
            f"dO, got {qkv.dtype}, {out.dtype} and {do.dtype}")
    if head_dim % 8 or head_dim > 128:
        raise NotImplementedError(
            f"head_dim {head_dim}: the kernel takes multiples of 8 up to 128")
    for z, name in ((qkv, "qkv"), (out, "out"), (do, "do")):
        _build.require(z, name, device=qkv.device, dtypes=(torch.bfloat16,))
    _build.require(lse, "lse", device=qkv.device, dtypes=(torch.float32,))
    dqkv = torch.empty((b, t, 3 * d), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or t == 0:
        return dqkv
    dvec = torch.empty((b, num_heads, t), dtype=torch.float32, device=qkv.device)
    err = _build.library().vit_flash_attention_bwd(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dqkv.data_ptr(), dvec.data_ptr(), b, t, num_heads, head_dim,
        _flash_scale(head_dim), _build.stream_handle(qkv))
    _build.check_launch(err, "blockwise_attention_bwd")
    LAUNCHES_FLASH_BWD += 1
    return dqkv


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


def kernel_bwd_smem_bytes(head_dim: int) -> int:
    """Shared memory of one block of the larger of the backward's two
    kernels (the dK/dV one): a ring of two stages, each a 64-query tile of q
    and of dO (head dim padded to 16, rows to pitch + 8) and the tile's rows'
    statistics. It does not depend on T: the kernels stream their tiles."""
    hdp = -(-head_dim // 16) * 16
    return 2 * (2 * 64 * (hdp + 8) * 2 + 64 * 3 * 4)


def packed_attention_bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                         head_dim: int, *,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused backward: (qkv [B, T, 3D], dO [B, T, D]) → dqkv [B, T, 3D] in
    ``out_dtype`` (default qkv's; the kernels write bf16 or fp32), at any T
    (as the JAX function: the kernels stream q, k, v and dO tiles)."""
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
    """The packed kernel forward and the fused backward, saving qkv alone
    (the backward recomputes the softmax); past SINGLE_PASS_MAX_T the
    blockwise forward with the log-sum-exp and the blockwise backward,
    saving (qkv, out, lse) as JAX's residuals."""

    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim):
        ctx.heads = (num_heads, head_dim)
        ctx.long_seq = _is_long_seq(qkv.shape[1])
        if ctx.long_seq:
            out, lse = blockwise_attention_fwd(qkv, num_heads, head_dim,
                                               return_lse=True)
            ctx.save_for_backward(qkv, out, lse)
            return out
        ctx.save_for_backward(qkv)
        return packed_fused_attention(qkv, num_heads=num_heads,
                                      head_dim=head_dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.long_seq:
            qkv, out, lse = ctx.saved_tensors
            return (blockwise_attention_bwd(qkv, out, lse, g.contiguous(),
                                            *ctx.heads), None, None)
        qkv, = ctx.saved_tensors
        return (packed_attention_bwd(qkv, g.contiguous(), *ctx.heads),
                None, None)


def packed_fused_attention_trainable(qkv: torch.Tensor, num_heads: int,
                                     head_dim: int) -> torch.Tensor:
    """Differentiable fused attention on packed [B, T, 3D] input, routed as
    JAX's: for padded T ≤ ``SINGLE_PASS_MAX_T`` the packed kernel forward
    and ``packed_attention_bwd``; longer, the blockwise forward (saving the
    log-sum-exp) and ``blockwise_attention_bwd``. First-order only."""
    return _PackedAttention.apply(qkv, num_heads, head_dim)

"""Attention: the CUDA kernels ``csrc/attention.cu``,
``csrc/attention_single.cu``, ``csrc/attention_flash.cu`` and
``csrc/attention_ring.cu`` and their plain versions.

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

``flash_attention`` (the kernel layer's public op, JAX's
``flash_attention``) takes split heads, [B, H, T, hd] → [B, H, T, hd], and
routes as JAX's: T ≤ ``SINGLE_PASS_MAX_T`` to ``single_pass_attention``,
which replaces ``_single_pass_kernel`` (the one-shot softmax of
``_head_attention``: in bf16 the packed kernel's Hopper body, whose
function it is, on strided views with a key count; in fp32 a CUDA-core
kernel of ``csrc/attention_single.cu``), longer T to the blockwise kernel
through its strided entry. Its plain version is
``flash_attention_reference``. Both kernels read q, k and v as strided
views (a contiguous last axis, 16-byte rows), so the permuted views of a
[B, T, 3D] GEMM output go in without a copy.

``packed_fused_attention`` routes as JAX's ``_packed_kernel``
(``_packed_route``): up to padded T = 1024 the packed kernel, which streams
its K/V tiles and so takes any T; past it (slab packing only, as in JAX)
the blockwise kernel with its ``kv_len``. Slab packing over all T keys
launches the packed kernel's slab entry; ``packing="per_head"`` (head h's
q, k and v at columns h·3·hd + {0, 1, 2}·hd: the tensor-parallel layout)
and ``true_seq_len`` (keys at and past it masked: a token axis that the
caller already padded) launch its entry with a key count and a packing;
both count under ``LAUNCHES``. The packed kernel takes bf16; fp32 inputs
with per-head packing or a key count take the single-pass attention's fp32
kernel on strided views of the packed buffer (``LAUNCHES_SINGLE``).

``blockwise_ring_step`` replaces ``_flash_carry_kernel``, the local step of
ring attention (``ops/ring_attention.py``): one rotation's blockwise
attention whose (m, l, acc) come in from the previous rotation and go out
un-normalised, bf16 or fp32, through ``csrc/attention_ring.cu``; its plain
version is ``blockwise_ring_step_reference``.

Every wrapper launches a kernel for a CUDA tensor and computes its plain
version for a CPU tensor; there is no other fallback. Not ported yet: fp32
inputs on the card other than the single-pass kernel's and the ring
step's, and a blockwise key tile other than 128 on the card; those raise
``NotImplementedError``.

The backward, ``packed_attention_bwd``, replaces ``_packed_bwd_kernel``
with the two kernels of ``csrc/attention_bwd.cu`` (plain version
``packed_attention_bwd_reference``), which stream their tiles and so take
any T; ``blockwise_attention_bwd`` replaces ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` (JAX's ``blockwise_attention_bwd``) with the dq and
dK/dV kernels of ``csrc/attention_flash.cu`` (TMA and wgmma: the dq kernel
walks each head's K/V tiles once, the dK/dV kernel streams q and dO past
resident K/V), which rebuild p from the forward's log-sum-exp (plain version
``blockwise_attention_bwd_reference``).
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
# kernels); the single-pass forward (split heads or slabs); the blockwise
# forward on the slabs without and with the log-sum-exp, on split heads, and
# the blockwise backward (one per call: its two kernels); the ring step.
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_SINGLE = 0
LAUNCHES_FLASH = 0
LAUNCHES_FLASH_LSE = 0
LAUNCHES_FLASH_SPLIT = 0
LAUNCHES_FLASH_BWD = 0
LAUNCHES_RING = 0

# Hopper's largest dynamic shared memory for one block.
MAX_SMEM_BYTES = 227 * 1024
# Padded sequence lengths above this take the JAX package's blockwise
# (flash) route, in inference and in training.
SINGLE_PASS_MAX_T = 1024
# The blockwise route's key tile: the running max moves once a tile, so the
# tile decides where p is rounded (JAX's DEFAULT_BLOCK_K).
FLASH_BLOCK_K = 128
DEFAULT_BLOCK_Q = 128
# Masked scores (keys past T): -inf would give NaN on a fully masked row
# (attention.py:43).
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _is_long_seq(t: int) -> bool:
    """Whether JAX's packed attention takes the blockwise route at T = t."""
    return max(-(-t // 128) * 128, 128) > SINGLE_PASS_MAX_T


def _head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, kv_len: Optional[int] = None) -> torch.Tensor:
    """softmax(q·scale @ kᵀ) @ v over the last two axes, fp32 output.

    The reference's rounding points: q is scaled in its own dtype, scores and
    the softmax are fp32, the unnormalised weights are cast to v's dtype for
    the PV product, and the 1/rowsum scales the output, not the weights.
    Keys at and past ``kv_len`` score MASK_VALUE."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = qs.float() @ k.float().transpose(-1, -2)
    if kv_len is not None:
        s = torch.where(torch.arange(s.shape[-1], device=s.device) < kv_len,
                        s, MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    inv = 1.0 / e.sum(-1, keepdim=True)
    o = e.to(v.dtype).float() @ v.float()
    return o * inv


def _packed_heads(qkv: torch.Tensor, num_heads: int, head_dim: int,
                  packing: str) -> torch.Tensor:
    """[B, T, 3D] packed → [3, B, H, T, hd] views (the JAX package's
    ``_packed_offsets``): "slab" puts head h's q, k and v at columns h·hd,
    D + h·hd and 2D + h·hd, "per_head" at h·3·hd + {0, 1, 2}·hd."""
    b, t, _ = qkv.shape
    if packing == "slab":
        return _split_heads(qkv, 3, num_heads, head_dim)
    return qkv.reshape(b, t, num_heads, 3, head_dim).permute(3, 0, 2, 1, 4)


def _packed_checks(t: int, packing: str, true_seq_len: Optional[int]) -> int:
    """The key count of packed attention at T = t, as JAX checks it."""
    if packing not in ("slab", "per_head"):
        raise ValueError(f"unknown packing {packing!r}")
    seq = t if true_seq_len is None else true_seq_len
    if t and not 1 <= seq <= t:
        raise ValueError(f"true_seq_len {seq} outside [1, {t}]")
    if _is_long_seq(t) and packing != "slab":
        raise NotImplementedError(
            "long-sequence packed attention supports slab packing only")
    return seq


def packed_fused_attention_reference(qkv: torch.Tensor, num_heads: int,
                                     head_dim: int, *, packing: str = "slab",
                                     true_seq_len: Optional[int] = None
                                     ) -> torch.Tensor:
    """Plain version: packed [B, T, 3D] → head-major [B, T, D], keys at and
    past ``true_seq_len`` masked. Long sequences take the blockwise route
    (slab packing only), as the kernel wrapper does."""
    b, t, _ = qkv.shape
    seq = _packed_checks(t, packing, true_seq_len)
    if _is_long_seq(t):
        return blockwise_attention_fwd_reference(qkv, num_heads, head_dim,
                                                 kv_len=seq)[0]
    q, k, v = _packed_heads(qkv, num_heads, head_dim, packing)
    o = _head_attention(q, k, v, float(1.0 / np.sqrt(head_dim)),
                        None if seq == t else seq)
    return o.permute(0, 2, 1, 3).reshape(b, t, num_heads * head_dim).to(qkv.dtype)


def _packed_route(t: int, packing: str, seq: int, dtype: torch.dtype) -> str:
    """What ``packed_fused_attention`` launches on the card at T = t with
    ``seq`` keys: "blockwise" past padded T = 1024 (JAX's route there);
    below it the packed kernel, by its slab entry ("packed": slab packing,
    every key) or by its entry with a key count and a packing
    ("packed_kv"); "single_pass" for fp32 inputs that need a key count or
    per-head packing (the packed kernel takes bf16, the single-pass
    attention also fp32)."""
    if _is_long_seq(t):
        return "blockwise"
    if packing == "slab" and seq == t:
        return "packed"
    return "packed_kv" if dtype == torch.bfloat16 else "single_pass"


# The Hopper attention kernels' geometry (csrc/attention_sm90.cuh): blocks
# of one producer and two consumer warpgroups, each consumer owning 64 rows
# (queries, or keys in the dK/dV kernel); tiles of 64 rows by 64 columns, two
# of them side by side past hd 64, in 1024-byte-aligned shared memory.
KERNEL_ROWS = 64
KERNEL_CONSUMERS = 2
_TILE_BOX_BYTES = KERNEL_ROWS * 64 * 2
_ALIGN_BYTES = 1024


def _tile_bytes(head_dim: int) -> int:
    return _TILE_BOX_BYTES * (2 if head_dim > 64 else 1)


def packed_kernel_smem_bytes(head_dim: int) -> int:
    """Shared memory of one block of the packed forward (csrc/attention.cu
    ``fwd_smem_bytes``): a ring of K/V tile pairs (8 up to hd 64, 4 past
    it) and its barriers, at any T."""
    slots = 8 if head_dim <= 64 else 4
    return _ALIGN_BYTES + slots * 2 * _tile_bytes(head_dim) + 2 * slots * 8


def blockwise_kernel_smem_bytes(head_dim: int) -> int:
    """Shared memory of one block of the blockwise forward
    (csrc/attention_flash.cu ``fwd_smem_bytes``): a ring of 128-key K/V tile
    pairs (5 up to hd 64, 3 past it), the consumers' q tiles (three
    consumers and two units' tiles up to hd 64, two consumers and one unit's
    past it) and their barriers, at any T."""
    stages, q_slots, consumers = (5, 2, 3) if head_dim <= 64 else (3, 1, 2)
    return (_ALIGN_BYTES + stages * 2 * 2 * _tile_bytes(head_dim)
            + q_slots * consumers * _tile_bytes(head_dim)
            + 2 * (stages + q_slots) * 8)


def blockwise_bwd_kernel_smem_bytes(head_dim: int) -> int:
    """Shared memory of one block of the larger of the blockwise backward's
    two kernels (csrc/attention_flash.cu ``bwd_dq_smem_bytes``,
    ``bwd_dkv_smem_bytes``): the dq kernel's ring of 4 K/V tile pairs; the
    dK/dV kernel's K and V tiles of its two consumers and a ring of 4 q and
    dO tile pairs, each with its 64 rows' lse and dvec (padded to 1024
    bytes), and their barriers. It does not depend on T."""
    tile, stages = _tile_bytes(head_dim), 4
    dq = _ALIGN_BYTES + stages * 2 * tile + 2 * stages * 8
    dkv = (_ALIGN_BYTES + 2 * KERNEL_CONSUMERS * tile
           + stages * (2 * tile + 1024) + (1 + 2 * stages) * 8)
    return max(dq, dkv)


def _stats_rows(seq_len: int) -> int:
    """Rows of each (image, head)'s block of the backward's statistics: T in
    whole 64-row tiles, which the dK/dV kernel copies whole."""
    return -(-seq_len // KERNEL_ROWS) * KERNEL_ROWS


def packed_fused_attention(
    qkv: torch.Tensor,
    config: Optional[ViTConfig] = None,
    *,
    num_heads: Optional[int] = None,
    head_dim: Optional[int] = None,
    packing: str = "slab",
    true_seq_len: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention over packed QKV: [B, T, 3D] → [B, T, D].

    ``packing``: "slab" (q|k|v slabs of D) or "per_head" (head-major
    q|k|v triples, the TP layout). ``true_seq_len``: keys at and past it
    are masked (the token axis is already padded); padded query rows get
    values in their own rows only."""
    global LAUNCHES
    b, t, three_d = qkv.shape
    nh = num_heads if num_heads is not None else config.num_heads
    hd = head_dim if head_dim is not None else config.head_dim
    d = nh * hd
    if three_d != 3 * d:
        raise ValueError(f"qkv last dim {three_d} != 3 * {d}")
    seq = _packed_checks(t, packing, true_seq_len)
    if not qkv.is_cuda:
        return packed_fused_attention_reference(qkv, nh, hd, packing=packing,
                                                true_seq_len=true_seq_len)
    route = _packed_route(t, packing, seq, qkv.dtype)
    if route == "blockwise":
        return blockwise_attention_fwd(qkv, nh, hd, kv_len=seq)[0]
    if route == "single_pass":
        # fp32: the same function through the single-pass attention's fp32
        # kernel, on strided views with kv_len.
        out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
        q, k, v = _packed_heads(qkv, nh, hd, packing)
        single_pass_attention(q, k, v, hd, kv_len=seq,
                              out=out.view(b, t, nh, hd).permute(0, 2, 1, 3))
        return out
    if qkv.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA attention kernel takes bf16 qkv, got {qkv.dtype}")
    if hd % 8 or hd > 128:
        raise NotImplementedError(
            f"head_dim {hd}: the kernel takes multiples of 8 up to 128")
    _build.refuse_autograd("packed_fused_attention", (qkv,),
                           "packed_fused_attention_trainable")
    _build.require(qkv, "qkv", device=qkv.device, dtypes=(torch.bfloat16,))
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or t == 0:
        return out
    scale = _single_pass_scale(hd, torch.bfloat16)
    if route == "packed":
        err = _build.launch("vit_packed_attention_bf16", qkv,
            qkv.data_ptr(), out.data_ptr(), b, t, nh, hd, scale)
    else:
        err = _build.launch("vit_packed_attention_kv", qkv,
            qkv.data_ptr(), out.data_ptr(), b, t, seq, nh, hd,
            int(packing == "per_head"), scale)
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
                                      head_dim: int, *, return_lse: bool = False,
                                      kv_len: Optional[int] = None):
    """Plain version of ``blockwise_attention_fwd`` with ``_flash_kernel``'s
    arithmetic: fp32 scores times the fp32 scale, keys at and past
    ``kv_len`` (default T) masked to MASK_VALUE, and a walk over key tiles
    of FLASH_BLOCK_K in order with
    the running max moved once a tile: ``p = exp(s − m_next)`` (rounded to
    v's dtype for the PV product, fp32 in the row sum), ``acc = acc·α + pv``.
    Returns (out [B, T, D] in qkv's dtype, acc · (1/l) with l == 0 → 1;
    lse [B, H, T] fp32, m + log(l), or None)."""
    b, t, _ = qkv.shape
    q, k, v = _split_heads(qkv, 3, num_heads, head_dim)
    out, lse = _blockwise_heads_reference(q, k, v, _flash_scale(head_dim),
                                          FLASH_BLOCK_K, return_lse, kv_len)
    out = out.permute(0, 2, 1, 3).reshape(b, t, num_heads * head_dim)
    return out.to(qkv.dtype), lse


def _blockwise_heads_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, scale: float, block_k: int,
                               return_lse: bool = False,
                               kv_len: Optional[int] = None):
    """``_flash_kernel``'s arithmetic on split heads [B, H, T, hd]: (acc ·
    (1/l), fp32; lse [B, H, T] or None). Keys at and past ``kv_len``
    (default T) are masked; the walk over key tiles of ``block_k`` is part
    of the function."""
    b, nh, t, hd = q.shape
    kv_len = t if kv_len is None else kv_len
    t_pad = -(-t // block_k) * block_k
    pad = (0, 0, 0, t_pad - t)
    k = torch.nn.functional.pad(k, pad)
    v = torch.nn.functional.pad(v, pad)
    qf = q.float()
    m = torch.full((b, nh, t, 1), -float("inf"), device=q.device)
    l = torch.zeros((b, nh, t, 1), device=q.device)
    acc = torch.zeros((b, nh, t, hd), device=q.device)
    for k0 in range(0, t_pad, block_k):
        kt = k[..., k0:k0 + block_k, :].float()
        s = (qf @ kt.transpose(-1, -2)) * scale
        col = torch.arange(k0, k0 + block_k, device=q.device)
        s = torch.where(col < kv_len, s, MASK_VALUE)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(-1, keepdim=True)
        vt = v[..., k0:k0 + block_k, :]
        acc = acc * alpha + p.to(vt.dtype).float() @ vt.float()
        m = m_next
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc * torch.where(l == 0.0, 1.0, 1.0 / l)
    lse = (m + torch.log(l_safe))[..., 0] if return_lse else None
    return out, lse


def blockwise_attention_fwd(qkv: torch.Tensor, num_heads: int, head_dim: int,
                            *, return_lse: bool = False,
                            kv_len: Optional[int] = None):
    """Blockwise attention over packed [B, T, 3D] at any T: (out [B, T, D]
    in qkv's dtype, lse [B, H, T] fp32 or None). The kernel reads q, k and
    v straight from the slabs (rows past T as zeros) and writes the
    head-major context, with or without each row's log-sum-exp; keys at and
    past ``kv_len`` (default T) are masked."""
    global LAUNCHES_FLASH, LAUNCHES_FLASH_LSE
    b, t, three_d = qkv.shape
    d = num_heads * head_dim
    kv_len = t if kv_len is None else kv_len
    if three_d != 3 * d:
        raise ValueError(f"qkv last dim {three_d} != 3 * {d}")
    if t and not 1 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    if not qkv.is_cuda:
        return blockwise_attention_fwd_reference(qkv, num_heads, head_dim,
                                                 return_lse=return_lse,
                                                 kv_len=kv_len)
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
    err = _build.launch("vit_flash_attention_fwd", qkv,
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None,
        b, t, kv_len, num_heads, head_dim, _flash_scale(head_dim))
    _build.check_launch(err, "blockwise_attention_fwd")
    if return_lse:
        LAUNCHES_FLASH_LSE += 1
    else:
        LAUNCHES_FLASH += 1
    return out, lse


# ---------------------------------------------------------------------------
# Split heads: the single-pass kernel and flash_attention
# ---------------------------------------------------------------------------


def _single_pass_scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(hd) as ``_head_attention`` applies it (``jnp.asarray(scale,
    q.dtype)``): rounded once to q's dtype."""
    return torch.tensor(float(1.0 / np.sqrt(head_dim)), dtype=torch.float64).to(
        dtype).item()


def single_pass_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, head_dim: int, *,
                                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain version of ``single_pass_attention``: ``_head_attention`` on
    [B, H, T, hd] with the scale of ``head_dim`` and keys at and past
    ``kv_len`` masked; q's dtype out."""
    o = _head_attention(q, k, v, float(1.0 / np.sqrt(head_dim)), kv_len)
    return o.to(q.dtype)


def single_pass_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          head_dim: int, *, kv_len: Optional[int] = None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-shot attention on [B, H, T, hd] views (bf16 or fp32, one dtype),
    the function of ``_single_pass_kernel`` at any T; keys at and past
    ``kv_len`` (default T) are masked. Writes ``out`` (a view of the same
    shape and dtype) if given, else a new tensor."""
    global LAUNCHES_SINGLE
    b, nh, t, hd = q.shape
    kv_len = t if kv_len is None else kv_len
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    if not 1 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    if not q.is_cuda:
        ref = single_pass_attention_reference(q, k, v, head_dim, kv_len=kv_len)
        return ref if out is None else out.copy_(ref)
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(
            f"the single-pass attention kernel takes bf16 or fp32, got {q.dtype}")
    if hd % 8 or hd > 128:
        raise NotImplementedError(
            f"head_dim {hd}: the kernel takes multiples of 8 up to 128")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if tuple(out.shape) != tuple(q.shape):
        raise ValueError(f"out {tuple(out.shape)} != {tuple(q.shape)}")
    for z, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        _build.require_head_view(z, name, device=q.device, dtypes=(q.dtype,))
    _build.refuse_autograd("single_pass_attention", (q, k, v),
                           "packed_fused_attention_trainable")
    if b == 0 or t == 0 or nh == 0:
        return out
    err = _build.launch("vit_single_pass_attention", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], _build.head_strides(q, k, v, out), b, nh,
        t, kv_len, hd, _single_pass_scale(head_dim, q.dtype))
    _build.check_launch(err, "single_pass_attention")
    LAUNCHES_SINGLE += 1
    return out


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, config: ViTConfig, *,
                              block_q: int = DEFAULT_BLOCK_Q,
                              block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Plain version of ``flash_attention``, routed as JAX's: T ≤
    ``SINGLE_PASS_MAX_T`` the one-shot softmax, longer T the blockwise walk
    over key tiles of ``block_k`` (``block_q`` moves no result)."""
    if q.shape[2] <= SINGLE_PASS_MAX_T:
        return single_pass_attention_reference(q, k, v, config.head_dim)
    out, _ = _blockwise_heads_reference(q, k, v, _flash_scale(config.head_dim),
                                        block_k)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    config: ViTConfig, *, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """softmax(QKᵀ / sqrt(hd)) V on split heads: [B, H, T, hd] → [B, H, T,
    hd] in q's dtype, the drop-in for ``models.vit.xla_attention`` (the same
    kernel-table slot). T ≤ ``SINGLE_PASS_MAX_T``: the single-pass kernel
    (bf16 or fp32); longer: the blockwise kernel (bf16, ``block_k`` 128,
    the tile being part of its function). q, k and v may be strided views
    with a contiguous last axis and 16-byte rows."""
    global LAUNCHES_FLASH_SPLIT
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be one [B, H, T, hd] shape")
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, config, block_q=block_q,
                                         block_k=block_k)
    b, nh, t, hd = q.shape
    if t <= SINGLE_PASS_MAX_T:
        return single_pass_attention(q, k, v, config.head_dim)
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA blockwise attention kernel takes bf16, got {q.dtype}")
    if block_k != FLASH_BLOCK_K:
        raise NotImplementedError(
            f"block_k {block_k}: the blockwise kernel's key tile is "
            f"{FLASH_BLOCK_K}, and the tile decides where p is rounded")
    if hd % 8 or hd > 128:
        raise NotImplementedError(
            f"head_dim {hd}: the kernel takes multiples of 8 up to 128")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for z, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        _build.require_head_view(z, name, device=q.device, dtypes=(q.dtype,))
    _build.refuse_autograd("flash_attention", (q, k, v),
                           "packed_fused_attention_trainable")
    if b == 0 or nh == 0:
        return out
    err = _build.launch("vit_flash_attention_fwd_strided", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
        _build.head_strides(q, k, v, out), b, t, nh, hd,
        _flash_scale(config.head_dim))
    _build.check_launch(err, "flash_attention")
    LAUNCHES_FLASH_SPLIT += 1
    return out


# ---------------------------------------------------------------------------
# The ring-attention local step: blockwise with carried statistics
# ---------------------------------------------------------------------------


def _ring_step_checks(qf, kf, vf, kv_bias, m, l, acc, block_q: int,
                      block_k: int) -> None:
    n, t_loc, hd = qf.shape
    shapes = {"kf": (kf, (n, t_loc, hd)), "vf": (vf, (n, t_loc, hd)),
              "kv_bias": (kv_bias, (1, t_loc)), "m": (m, (n, t_loc)),
              "l": (l, (n, t_loc)), "acc": (acc, (n, t_loc, hd))}
    for name, (z, shape) in shapes.items():
        if tuple(z.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(z.shape)}, expected {shape}")
    if block_q <= 0 or block_k <= 0 or t_loc % block_q or t_loc % block_k:
        raise ValueError(f"block_q {block_q} and block_k {block_k} must divide "
                         f"t_loc {t_loc}")


def blockwise_ring_step_reference(qf: torch.Tensor, kf: torch.Tensor,
                                  vf: torch.Tensor, kv_bias: torch.Tensor,
                                  m: torch.Tensor, l: torch.Tensor,
                                  acc: torch.Tensor, *, scale: float,
                                  block_q: int, block_k: int):
    """Plain version of ``blockwise_ring_step`` with ``_flash_carry_kernel``'s
    arithmetic: over key blocks of ``block_k`` in order, ``s = fp32(q·kᵀ) ·
    scale + bias`` (the fp32 scale multiplies the fp32 scores), ``m' =
    max(m, rowmax(s))``, ``α = exp(m − m')``, ``p = exp(s − m')``, ``l' =
    α·l + rowsum(p)`` on the fp32 p, ``acc' = α·acc + dtype(p)·v`` with fp32
    sums. ``block_q`` moves no result; it must divide t_loc, as JAX's
    asserts. Returns the un-normalised (m, l, acc), fp32."""
    _ring_step_checks(qf, kf, vf, kv_bias, m, l, acc, block_q, block_k)
    scale = float(np.float32(scale))
    qf32 = qf.float()
    m, l = m[..., None], l[..., None]
    for k0 in range(0, qf.shape[1], block_k):
        kt = kf[:, k0:k0 + block_k].float()
        s = (qf32 @ kt.transpose(-1, -2)) * scale + kv_bias[0, k0:k0 + block_k]
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(-1, keepdim=True)
        vt = vf[:, k0:k0 + block_k]
        acc = acc * alpha + p.to(vt.dtype).float() @ vt.float()
        m = m_next
    return m[..., 0], l[..., 0], acc


def blockwise_ring_step(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                        kv_bias: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        acc: torch.Tensor, *, scale: float, block_q: int,
                        block_k: int):
    """One ring rotation's local attention, blockwise with carried stats.

    qf, kf, vf: [n, t_loc, hd] (bf16 or fp32, one dtype); kv_bias: [1,
    t_loc] fp32 additive key mask; m, l: [n, t_loc] fp32; acc: [n, t_loc,
    hd] fp32. Returns new (m, l, acc), un-normalised: divide acc by l after
    the last rotation. ``block_k`` (any divisor of t_loc, a ragged whole
    shard too) is part of the function; ``block_q`` must divide t_loc and
    moves nothing. The kernel takes head dims that are multiples of 8 up to
    128."""
    global LAUNCHES_RING
    if qf.dim() != 3:
        raise ValueError(f"qf must be [n, t_loc, hd], got {tuple(qf.shape)}")
    _ring_step_checks(qf, kf, vf, kv_bias, m, l, acc, block_q, block_k)
    if not qf.is_cuda:
        return blockwise_ring_step_reference(qf, kf, vf, kv_bias, m, l, acc,
                                             scale=scale, block_q=block_q,
                                             block_k=block_k)
    n, t_loc, hd = qf.shape
    if qf.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(
            f"the ring step kernel takes bf16 or fp32, got {qf.dtype}")
    if hd % 8 or hd > 128:
        raise NotImplementedError(
            f"head_dim {hd}: the kernel takes multiples of 8 up to 128")
    dev = qf.device
    for z, name in ((qf, "qf"), (kf, "kf"), (vf, "vf")):
        _build.require(z, name, device=dev, dtypes=(qf.dtype,))
    for z, name in ((kv_bias, "kv_bias"), (m, "m"), (l, "l"), (acc, "acc")):
        _build.require(z, name, device=dev, dtypes=(torch.float32,))
    _build.refuse_autograd("blockwise_ring_step", (qf, kf, vf, m, l, acc),
                           "the einsum ring step (impl='einsum')")
    m_out, l_out, acc_out = (torch.empty_like(z) for z in (m, l, acc))
    if n == 0:
        return m_out, l_out, acc_out
    err = _build.launch("vit_ring_step", qf,
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), kv_bias.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), m_out.data_ptr(),
        l_out.data_ptr(), acc_out.data_ptr(), _build.DTYPE_CODES[qf.dtype], n,
        t_loc, hd, block_k, float(np.float32(scale)))
    _build.check_launch(err, "blockwise_ring_step")
    LAUNCHES_RING += 1
    return m_out, l_out, acc_out


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
    err = _build.launch("vit_flash_attention_bwd", qkv,
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dqkv.data_ptr(), dvec.data_ptr(), b, t, num_heads, head_dim,
        _flash_scale(head_dim))
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
    kernels (csrc/attention_bwd.cu ``dq_smem_bytes``, ``dkv_smem_bytes``):
    the dq kernel's ring of 4 K/V tile pairs; the dK/dV kernel's K, V and
    scaled-q tiles of its two consumers and a ring of q and dO tiles with
    their rows' statistics (4 stages, 3 past hd 64). It does not depend on
    T: the kernels stream their tiles."""
    tile = _tile_bytes(head_dim)
    stages = 4 if head_dim <= 64 else 3
    dq = _ALIGN_BYTES + 4 * 2 * tile + 2 * 4 * 8
    dkv = (_ALIGN_BYTES + 3 * KERNEL_CONSUMERS * tile
           + stages * (2 * tile + KERNEL_ROWS * 16) + (1 + 2 * stages) * 8)
    return max(dq, dkv)


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
    stats = torch.empty((b, num_heads, _stats_rows(t), 4), dtype=torch.float32,
                        device=qkv.device)
    q_scale = _single_pass_scale(head_dim, torch.bfloat16)
    ds_scale = float(np.float32(1.0 / np.sqrt(head_dim)))
    err = _build.launch("vit_packed_attention_bwd", qkv,
        qkv.data_ptr(), do.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[out_dtype], stats.data_ptr(), b, t, num_heads,
        head_dim, q_scale, ds_scale)
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

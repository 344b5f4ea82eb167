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
softmax whose running max moves once every ``block_k`` keys (JAX's key
tile, part of the function: an instance each for 128, its default, and
256 and 512, the key tiles of its autotune sweep), and optionally writes
each row's log-sum-exp; its plain version is
``blockwise_attention_fwd_reference``. ``packed_fused_attention_reference``
routes the same way, so the chains' plain links compare like with like.

``flash_attention`` (the kernel layer's public op, JAX's
``flash_attention``) takes split heads, [B, H, T, hd] → [B, H, T, hd], and
routes as JAX's: T ≤ ``SINGLE_PASS_MAX_T`` to ``single_pass_attention``,
which replaces ``_single_pass_kernel`` (the one-shot softmax of
``_head_attention``: in bf16 the packed kernel's Hopper body, whose
function it is, on strided views with a key count; in fp32 the
register-tiled CUDA-core body of ``csrc/attention_f32.cuh``, which the
ring step's fp32 form shares), longer T to the blockwise kernel
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
both count under ``LAUNCHES``. The packed kernel takes bf16. fp32 slab
packing over every key takes the fp32 slab entry
(``vit_packed_attention_f32``, ``csrc/attention_single.cu``: the
register-tiled CUDA-core body of ``csrc/attention_f32.cuh`` on the slabs'
head views; its own count, ``LAUNCHES_PACKED_F32``); fp32 inputs with
per-head packing or a key count take the single-pass attention's fp32 form
on strided views of the packed buffer (``LAUNCHES_SINGLE``).

``blockwise_ring_step`` replaces ``_flash_carry_kernel``, the local step of
ring attention (``ops/ring_attention.py``): one rotation's blockwise
attention whose (m, l, acc) come in from the previous rotation and go out
un-normalised, through ``csrc/attention_ring.cu``: bf16 on the Hopper parts
(TMA-staged K/V tiles that a row group's query tiles share, ``wgmma``
products), fp32 on the register-tiled body of ``csrc/attention_f32.cuh``;
its plain version is ``blockwise_ring_step_reference``.

Past padded T = 1024 fp32 inputs take the blockwise kernels' fp32 forms:
the forward (slabs, with or without the LSE, and split heads) is the
blockwise form of the register-tiled fp32 body of ``csrc/attention_f32.cuh``
(``csrc/attention_flash_f32.cu``: ``LAUNCHES_FLASH_F32``,
``LAUNCHES_FLASH_LSE_F32``, ``LAUNCHES_FLASH_SPLIT_F32``), the backward the
dq and dK/dV kernels of ``csrc/attention_bwd_f32.cu`` in their form with the
statistics given (``LAUNCHES_FLASH_BWD_F32``); plain FMA on the CUDA cores,
no TF32.

Every wrapper launches a kernel for a CUDA tensor and computes its plain
version for a CPU tensor; there is no other fallback. A blockwise key tile
other than 128, 256 and 512 raises ``NotImplementedError`` on the card, in
either dtype, and so do mixed dtypes.

The backward, ``packed_attention_bwd``, replaces ``_packed_bwd_kernel``
with the two kernels of ``csrc/attention_bwd.cu`` for bf16 qkv and dO, and
with the two of ``csrc/attention_bwd_f32.cu`` (the register-tiled fp32 body:
a dq kernel and a dK/dV kernel, no TF32, ``LAUNCHES_BWD_F32``) for fp32
ones (plain version ``packed_attention_bwd_reference``), which stream
their tiles and so take any T; ``blockwise_attention_bwd`` replaces ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` (JAX's ``blockwise_attention_bwd``) with the dq and
dK/dV kernels of ``csrc/attention_flash.cu`` (TMA and wgmma: the dq kernel
walks each head's K/V tiles once, the dK/dV kernel streams q and dO past
resident K/V), which rebuild p from the forward's log-sum-exp (plain version
``blockwise_attention_bwd_reference``).
``packed_fused_attention_trainable`` is the differentiable form that
training's ``flash`` route uses, routed by ``_is_long_seq`` as JAX's. The
forward wrappers refuse to run under autograd on the card (their results
would carry no graph); the trainable form is the way to train through them.

Under the attribution probe's ``softmax_identity`` substitution
(``ops/substitutions``) ``_head_attention`` is JAX's ``fake_head``
(``_const_scale_head``): the same two products with a constant weight
``float32(1/T)`` in place of the softmax, and no mask (JAX's stand-in takes
none). Every plain version that reaches ``_head_attention`` follows it
(rows 4, 8 and, through p = s, 11), and so does the slab entry of the
packed kernel, by its constant-scale form (``vit_packed_attention_const``,
head dims 64 and 80). The card routes with no stand-in (the packed
kernel's entry with a key count or per-head packing, rows 8 and 11) raise
``NotImplementedError``; the blockwise route past T = 1024 keeps its real
softmax, as JAX's ``_flash_kernel`` does (so a softmax share measured there
is about 0 by construction). JAX's kernels pad T where the port's do not
(its single-pass kernel to a multiple of 128, its whole-encoder stack to
16, its padded packed route to 128), and its ``fake_head`` divides by that
padded T and, in the stack, averages over the padded rows too; the port's
stand-in is over the tensor's T keys.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ViTConfig
from . import _build, substitutions

# Kernel launches since the counts were last set to 0 (chip_smoke.py reads
# them): the packed forward, and its backward (one per call: its two
# kernels); the single-pass forward (split heads or slabs); the blockwise
# forward on the slabs without and with the log-sum-exp, on split heads, and
# the blockwise backward (one per call: its two kernels); the ring step.
# And the blockwise forward's launches by key tile (its three forms
# together, in either dtype), so that a run shows which instance it ran.
LAUNCHES = 0
LAUNCHES_BWD = 0
LAUNCHES_SINGLE = 0
# The fp32 slab entry of the packed forward and the fp32 backward (one per
# call: its two kernels).
LAUNCHES_PACKED_F32 = 0
LAUNCHES_BWD_F32 = 0
LAUNCHES_FLASH = 0
LAUNCHES_FLASH_LSE = 0
LAUNCHES_FLASH_SPLIT = 0
LAUNCHES_FLASH_BWD = 0
# The blockwise forward's and backward's fp32 forms (csrc/attention_flash_f32.cu,
# csrc/attention_bwd_f32.cu), counted as the bf16 ones.
LAUNCHES_FLASH_F32 = 0
LAUNCHES_FLASH_LSE_F32 = 0
LAUNCHES_FLASH_SPLIT_F32 = 0
LAUNCHES_FLASH_BWD_F32 = 0
LAUNCHES_RING = 0
LAUNCHES_FLASH_K128 = 0
LAUNCHES_FLASH_K256 = 0
LAUNCHES_FLASH_K512 = 0

# Hopper's largest dynamic shared memory for one block.
MAX_SMEM_BYTES = 227 * 1024
# Padded sequence lengths above this take the JAX package's blockwise
# (flash) route, in inference and in training.
SINGLE_PASS_MAX_T = 1024
# The blockwise route's key tile: the running max moves once a tile, so the
# tile decides where p is rounded (JAX's DEFAULT_BLOCK_K).
FLASH_BLOCK_K = 128
DEFAULT_BLOCK_Q = 128
# The key tiles the blockwise forward kernel is built for: JAX's default and
# the block_k of its sweep's candidates (perf/autotune.py).
FLASH_BLOCK_KS = (128, 256, 512)
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
    Keys at and past ``kv_len`` score MASK_VALUE. Under ``softmax_identity``
    the constant-scale stand-in instead (``_const_scale_head``)."""
    if substitutions.SOFTMAX_IDENTITY:
        return _const_scale_head(q, k, v, scale)
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


def const_scale(t: int) -> float:
    """The stand-in's weight a key, ``1.0 / T`` rounded once to fp32 (JAX
    multiplies the fp32 scores by the Python float ``1.0 / s.shape[1]``)."""
    return float(np.float32(1.0 / t))


def _const_scale_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """The ``softmax_identity`` stand-in (JAX's ``fake_head``): ``qs = q ·
    scale`` in q's dtype, ``s = qs · kᵀ`` in fp32, ``o = v.dtype(s ·
    float32(1/T)) · v`` with fp32 sums over all T keys; fp32 out. No max, no
    exp, no row sum, no 1/l and no mask."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = qs.float() @ k.float().transpose(-1, -2)
    return (s * const_scale(s.shape[-1])).to(v.dtype).float() @ v.float()


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
                                     true_seq_len: Optional[int] = None,
                                     block_q: int = DEFAULT_BLOCK_Q,
                                     block_k: int = FLASH_BLOCK_K
                                     ) -> torch.Tensor:
    """Plain version: packed [B, T, 3D] → head-major [B, T, D], keys at and
    past ``true_seq_len`` masked. Long sequences take the blockwise route
    (slab packing only) at ``block_q``/``block_k``, as the kernel wrapper
    does."""
    b, t, _ = qkv.shape
    seq = _packed_checks(t, packing, true_seq_len)
    _check_blocks(block_q, block_k)
    if _is_long_seq(t):
        return blockwise_attention_fwd_reference(qkv, num_heads, head_dim,
                                                 kv_len=seq, block_q=block_q,
                                                 block_k=block_k)[0]
    q, k, v = _packed_heads(qkv, num_heads, head_dim, packing)
    o = _head_attention(q, k, v, float(1.0 / np.sqrt(head_dim)),
                        None if seq == t else seq)
    return o.permute(0, 2, 1, 3).reshape(b, t, num_heads * head_dim).to(qkv.dtype)


def _packed_route(t: int, packing: str, seq: int, dtype: torch.dtype) -> str:
    """What ``packed_fused_attention`` launches on the card at T = t with
    ``seq`` keys: "blockwise" past padded T = 1024 (JAX's route there);
    below it the packed kernel, by its slab entry ("packed": slab packing,
    every key) or by its entry with a key count and a packing
    ("packed_kv"); for fp32 inputs (the packed kernel takes bf16) the fp32
    slab entry ("packed_f32": slab packing, every key) or the single-pass
    attention's fp32 form ("single_pass": a key count or per-head
    packing)."""
    if _is_long_seq(t):
        return "blockwise"
    bf16 = dtype == torch.bfloat16
    if packing == "slab" and seq == t:
        return "packed" if bf16 else "packed_f32"
    return "packed_kv" if bf16 else "single_pass"


# The head dims (rounded up to 16) at which the packed kernel's
# constant-scale form is compiled: the presets' 64 and ViT-H's 80.
CONST_SCALE_HEAD_DIMS = (64, 80)

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


def blockwise_kernel_geometry(head_dim: int) -> tuple:
    """(ring stages, q slots, consumer warpgroups of 64 queries) of one
    block of the blockwise forward, at every key tile it is built for."""
    return (5, 2, 3) if head_dim <= 64 else (3, 1, 2)


def blockwise_kernel_smem_bytes(head_dim: int,
                                block_k: int = FLASH_BLOCK_K) -> int:
    """Shared memory of one block of the blockwise forward
    (csrc/attention_flash.cu ``fwd_smem_bytes``): a ring of 128-key K/V tile
    pairs (5 up to hd 64, 3 past it), the consumers' q tiles (three
    consumers and two units' tiles up to hd 64, two consumers and one unit's
    past it) and their barriers, at any T. The same at every key tile the
    kernel is built for: a step of 256 or 512 keys takes its 128-key tiles
    through the same ring twice."""
    require_block_k(block_k)
    stages, q_slots, consumers = blockwise_kernel_geometry(head_dim)
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


# The ring step's bf16 kernel (csrc/attention_ring.cu): consumer warpgroups
# of 64 queries a block (three up to hd 64, two past it), a ring of stages
# (a 64-key K tile, its V tile and the tile's key biases padded to 1024
# bytes: 6 up to hd 64, 4 past it) and q slots (two units' up to hd 64, one
# past it).
# The card tests hold these copies, and the fp32 body's below, against the
# kernels' own (``vit_ring_step_geometry``).
RING_STAGE_BIAS_BYTES = 1024


def _ring_geometry(head_dim: int) -> tuple:
    """(consumers, stages, q slots) of the bf16 ring step kernel."""
    return (3, 6, 2) if head_dim <= 64 else (2, 4, 1)


def ring_kernel_smem_bytes(head_dim: int) -> int:
    """Shared memory of one block of the bf16 ring step kernel
    (csrc/attention_ring.cu ``smem_bytes``): its ring of stages, the
    consumers' q tiles and their barriers, at any t_loc and block_k."""
    consumers, stages, q_slots = _ring_geometry(head_dim)
    tile = _tile_bytes(head_dim)
    return (_ALIGN_BYTES + stages * (2 * tile + RING_STAGE_BIAS_BYTES)
            + q_slots * consumers * tile + 2 * (stages + q_slots) * 8)


def ring_kernel_units(n: int, t_loc: int, head_dim: int) -> int:
    """Work units of the bf16 ring step kernel: each row group's queries in
    units of one 64-query tile a consumer, all sharing the unit's K/V."""
    consumers = _ring_geometry(head_dim)[0]
    return n * -(-t_loc // (consumers * KERNEL_ROWS))


# The fp32 attention body (csrc/attention_f32.cuh), shared by the
# single-pass attention's, the ring step's and the blockwise forward's fp32
# forms: blocks of 64 queries, 64-key tiles; q, K and V row-major in rows of
# hd + 4 floats, p [query][key] in rows of 64 + 16, K, V and the keys' bias
# double buffered.
F32_ROWS = 64
F32_P_PITCH = F32_ROWS + 16


def f32_attention_smem_bytes(head_dim: int) -> int:
    """Shared memory of one block of the fp32 body (``f32attn::smem_bytes``):
    q, two K and two V tiles, p and two bias tiles, at the head dim padded
    to a multiple of 16; any T, kv_len and block_k."""
    hdp = -(-head_dim // 16) * 16
    floats = 5 * F32_ROWS * (hdp + 4) + F32_ROWS * F32_P_PITCH + 2 * F32_ROWS
    return 4 * floats


def f32_flash_bwd_smem_bytes(head_dim: int) -> tuple:
    """Shared memory of one block of each of the blockwise backward's fp32
    kernels (csrc/attention_bwd_f32.cu in its form with the statistics
    given: ``Smem::kDq``, ``Smem::kDkvGiven``): the dq kernel's q, dO, two K
    and two V tiles and its ds; the dK/dV kernel's K, V, two q and two dO
    tiles, its p and two tiles' rows of (lse, dvec); at the head dim padded
    to a multiple of 16, any T. Returns (dq, dK/dV) bytes."""
    hdp = -(-head_dim // 16) * 16
    dq = 4 * (6 * F32_ROWS * (hdp + 4) + F32_ROWS * F32_P_PITCH)
    return dq, dq + 4 * 2 * F32_ROWS * 2


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
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = FLASH_BLOCK_K,
) -> torch.Tensor:
    """Fused attention over packed QKV: [B, T, 3D] → [B, T, D].

    ``packing``: "slab" (q|k|v slabs of D) or "per_head" (head-major
    q|k|v triples, the TP layout). ``true_seq_len``: keys at and past it
    are masked (the token axis is already padded); padded query rows get
    values in their own rows only. ``block_q``/``block_k``: JAX's tiles of
    the blockwise route past padded T = 1024 (``blockwise_attention_fwd``;
    ``block_k`` is part of the function there, ``block_q`` moves nothing),
    unused below it, as in JAX."""
    global LAUNCHES
    b, t, three_d = qkv.shape
    nh = num_heads if num_heads is not None else config.num_heads
    hd = head_dim if head_dim is not None else config.head_dim
    d = nh * hd
    if three_d != 3 * d:
        raise ValueError(f"qkv last dim {three_d} != 3 * {d}")
    seq = _packed_checks(t, packing, true_seq_len)
    _check_blocks(block_q, block_k)
    if not qkv.is_cuda:
        return packed_fused_attention_reference(qkv, nh, hd, packing=packing,
                                                true_seq_len=true_seq_len,
                                                block_q=block_q, block_k=block_k)
    route = _packed_route(t, packing, seq, qkv.dtype)
    if route == "blockwise":
        return blockwise_attention_fwd(qkv, nh, hd, kv_len=seq,
                                       block_q=block_q, block_k=block_k)[0]
    const = substitutions.SOFTMAX_IDENTITY
    if const and route != "packed":
        substitutions.refuse(f"packed_fused_attention ({route} route: per-head "
                             "packing, a key count or fp32)", "softmax_identity")
    if route == "single_pass":
        # fp32: the same function through the single-pass attention's fp32
        # kernel, on strided views with kv_len.
        out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
        q, k, v = _packed_heads(qkv, nh, hd, packing)
        single_pass_attention(q, k, v, hd, kv_len=seq,
                              out=out.view(b, t, nh, hd).permute(0, 2, 1, 3))
        return out
    if route == "packed_f32":
        return _packed_attention_f32(qkv, nh, hd)
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
    if const:
        if -(-hd // 16) * 16 not in CONST_SCALE_HEAD_DIMS:
            substitutions.refuse(f"packed_fused_attention at head_dim {hd} (the "
                                 f"stand-in is built for {CONST_SCALE_HEAD_DIMS})",
                                 "softmax_identity")
        substitutions.check_launch("packed_fused_attention")
        err = _build.launch("vit_packed_attention_const", qkv,
            qkv.data_ptr(), out.data_ptr(), b, t, nh, hd, scale, const_scale(t))
    elif route == "packed":
        err = _build.launch("vit_packed_attention_bf16", qkv,
            qkv.data_ptr(), out.data_ptr(), b, t, nh, hd, scale)
    else:
        err = _build.launch("vit_packed_attention_kv", qkv,
            qkv.data_ptr(), out.data_ptr(), b, t, seq, nh, hd,
            int(packing == "per_head"), scale)
    _build.check_launch(err, "packed_fused_attention")
    LAUNCHES += 1
    return out


def _packed_attention_f32(qkv: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    """The fp32 slab route of ``packed_fused_attention`` (every key)."""
    global LAUNCHES_PACKED_F32
    if qkv.dtype != torch.float32:
        raise NotImplementedError(
            f"the fp32 packed attention takes fp32 qkv, got {qkv.dtype}")
    if hd % 8 or hd > 128:
        raise NotImplementedError(
            f"head_dim {hd}: the kernel takes multiples of 8 up to 128")
    _build.refuse_autograd("packed_fused_attention", (qkv,),
                           "packed_fused_attention_trainable")
    _build.require(qkv, "qkv", device=qkv.device, dtypes=(torch.float32,))
    b, t, _ = qkv.shape
    out = torch.empty((b, t, nh * hd), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or t == 0:
        return out
    err = _build.launch("vit_packed_attention_f32", qkv, qkv.data_ptr(),
                        out.data_ptr(), b, t, nh, hd,
                        _single_pass_scale(hd, torch.float32))
    _build.check_launch(err, "packed_fused_attention (fp32)")
    LAUNCHES_PACKED_F32 += 1
    return out


# ---------------------------------------------------------------------------
# Blockwise (long-sequence) attention: forward, log-sum-exp and backward
# ---------------------------------------------------------------------------


def _flash_scale(head_dim: int) -> float:
    """1/sqrt(hd) as JAX's kernels apply it: a Python float multiplying
    fp32 scores, so rounded once to fp32."""
    return float(np.float32(1.0 / np.sqrt(head_dim)))


def _check_blocks(block_q: int, block_k: int) -> None:
    """JAX's tiles of the blockwise route must be positive (it pads T to a
    multiple of both)."""
    if int(block_q) < 1 or int(block_k) < 1:
        raise ValueError(f"block_q {block_q} and block_k {block_k} must be >= 1")


def require_block_k(block_k: int) -> None:
    """Raise ``NotImplementedError`` for a key tile that the blockwise
    forward kernel has no instance for: the tile is part of the function,
    so no other runs in its place."""
    if block_k not in FLASH_BLOCK_KS:
        raise NotImplementedError(
            f"block_k {block_k}: the blockwise forward kernel is built for key "
            f"tiles {FLASH_BLOCK_KS} only, and the tile decides where p is "
            f"rounded")


def _count_block_k(block_k: int) -> None:
    globals()[f"LAUNCHES_FLASH_K{block_k}"] += 1


def blockwise_attention_fwd_reference(qkv: torch.Tensor, num_heads: int,
                                      head_dim: int, *, return_lse: bool = False,
                                      kv_len: Optional[int] = None,
                                      block_q: int = DEFAULT_BLOCK_Q,
                                      block_k: int = FLASH_BLOCK_K):
    """Plain version of ``blockwise_attention_fwd`` with ``_flash_kernel``'s
    arithmetic: fp32 scores times the fp32 scale, keys at and past
    ``kv_len`` (default T) masked to MASK_VALUE, and a walk over key tiles
    of ``block_k`` (any positive size) in order with
    the running max moved once a tile: ``p = exp(s − m_next)`` (rounded to
    v's dtype for the PV product, fp32 in the row sum), ``acc = acc·α + pv``.
    ``block_q`` moves no result (JAX pads T to a multiple of it; padded
    query rows are dropped). Returns (out [B, T, D] in qkv's dtype, acc ·
    (1/l) with l == 0 → 1; lse [B, H, T] fp32, m + log(l), or None)."""
    _check_blocks(block_q, block_k)
    b, t, _ = qkv.shape
    q, k, v = _split_heads(qkv, 3, num_heads, head_dim)
    out, lse = _blockwise_heads_reference(q, k, v, _flash_scale(head_dim),
                                          block_k, return_lse, kv_len)
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
                            kv_len: Optional[int] = None,
                            block_q: int = DEFAULT_BLOCK_Q,
                            block_k: int = FLASH_BLOCK_K):
    """Blockwise attention over packed [B, T, 3D] at any T: (out [B, T, D]
    in qkv's dtype, lse [B, H, T] fp32 or None). The kernel reads q, k and
    v straight from the slabs (rows past T as zeros) and writes the
    head-major context, with or without each row's log-sum-exp; keys at and
    past ``kv_len`` (default T) are masked. ``block_k``, JAX's key tile, is
    the running max's step and part of the function: the kernel has an
    instance for each of ``FLASH_BLOCK_KS`` and raises
    ``NotImplementedError`` for any other. ``block_q`` is range-checked and
    moves no result, on the card or in JAX (it only sets JAX's padding).
    bf16 qkv launches ``csrc/attention_flash.cu``'s kernel, fp32 the
    blockwise form of the fp32 body (``csrc/attention_flash_f32.cu``; its
    own counts, ``LAUNCHES_FLASH_F32`` and ``LAUNCHES_FLASH_LSE_F32``). In
    fp32 p is not rounded for the PV product, so the tile sets only where
    the running max moves and the order of fp32 sums; the kernel takes the
    same three tiles."""
    b, t, three_d = qkv.shape
    d = num_heads * head_dim
    kv_len = t if kv_len is None else kv_len
    if three_d != 3 * d:
        raise ValueError(f"qkv last dim {three_d} != 3 * {d}")
    if t and not 1 <= kv_len <= t:
        raise ValueError(f"kv_len {kv_len} outside [1, {t}]")
    _check_blocks(block_q, block_k)
    if not qkv.is_cuda:
        return blockwise_attention_fwd_reference(qkv, num_heads, head_dim,
                                                 return_lse=return_lse,
                                                 kv_len=kv_len, block_q=block_q,
                                                 block_k=block_k)
    require_block_k(block_k)
    if qkv.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(
            f"the CUDA blockwise attention kernel takes bf16 or fp32 qkv, got "
            f"{qkv.dtype}")
    if head_dim % 8 or head_dim > 128:
        raise NotImplementedError(
            f"head_dim {head_dim}: the kernel takes multiples of 8 up to 128")
    _build.refuse_autograd("blockwise_attention_fwd", (qkv,),
                           "packed_fused_attention_trainable")
    _build.require(qkv, "qkv", device=qkv.device, dtypes=(qkv.dtype,))
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, num_heads, t), dtype=torch.float32, device=qkv.device)
           if return_lse else None)
    if b == 0 or t == 0:
        return out, lse
    f32 = qkv.dtype == torch.float32
    err = _build.launch("vit_flash_attention_fwd_f32" if f32 else "vit_flash_attention_fwd",
        qkv, qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None,
        b, t, kv_len, num_heads, head_dim, int(block_k), _flash_scale(head_dim))
    _build.check_launch(err, "blockwise_attention_fwd" + (" (fp32)" if f32 else ""))
    name = "LAUNCHES_FLASH" + ("_LSE" if return_lse else "") + ("_F32" if f32 else "")
    globals()[name] += 1
    _count_block_k(block_k)
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
    if substitutions.SOFTMAX_IDENTITY:
        substitutions.refuse("single_pass_attention", "softmax_identity")
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
    _check_blocks(block_q, block_k)
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
    (bf16 or fp32); longer: the blockwise kernel (bf16, or its fp32 form,
    ``LAUNCHES_FLASH_SPLIT_F32``; at ``block_k`` 128, 256 or 512, the tile
    being part of its function; ``block_q`` moves nothing). q, k and v may
    be strided views with a contiguous last axis and 16-byte rows."""
    global LAUNCHES_FLASH_SPLIT, LAUNCHES_FLASH_SPLIT_F32
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be one [B, H, T, hd] shape")
    _check_blocks(block_q, block_k)
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, config, block_q=block_q,
                                         block_k=block_k)
    b, nh, t, hd = q.shape
    if t <= SINGLE_PASS_MAX_T:
        return single_pass_attention(q, k, v, config.head_dim)
    if q.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(
            f"the CUDA blockwise attention kernel takes bf16 or fp32, got {q.dtype}")
    require_block_k(block_k)
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
    strides, scale = _build.head_strides(q, k, v, out), _flash_scale(config.head_dim)
    if q.dtype == torch.float32:
        err = _build.launch("vit_flash_attention_fwd_strided_f32", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, strides,
            b, t, t, nh, hd, int(block_k), scale)
        _build.check_launch(err, "flash_attention (fp32)")
        LAUNCHES_FLASH_SPLIT_F32 += 1
    else:
        err = _build.launch("vit_flash_attention_fwd_strided", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, strides,
            b, t, nh, hd, int(block_k), scale)
        _build.check_launch(err, "flash_attention")
        LAUNCHES_FLASH_SPLIT += 1
    _count_block_k(block_k)
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
                                      num_heads: int, head_dim: int, *,
                                      block_q: int = DEFAULT_BLOCK_Q,
                                      block_k: int = FLASH_BLOCK_K
                                      ) -> torch.Tensor:
    """Plain version of ``blockwise_attention_bwd`` with the arithmetic of
    ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``: ``dvec =
    rowsum(fp32(dO) ⊙ fp32(O))`` from the forward's rounded output, ``p =
    exp(s − lse)`` with s as the forward's, ``dp = dO · vᵀ``, ``ds =
    dtype((p ⊙ (dp − dvec)) · scale)``, ``dq = ds · k``, ``dk = dsᵀ · q``
    (the unscaled q), ``dv = dtype(p)ᵀ · dO``, fp32 sums; dqkv in qkv's
    dtype. Every key is below T here, so no column is masked. JAX's
    ``block_q``/``block_k`` are accepted and move no result: p is rebuilt
    elementwise from the LSE, so a tile sets only the order of fp32 sums."""
    _check_blocks(block_q, block_k)
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
                            num_heads: int, head_dim: int, *,
                            block_q: int = DEFAULT_BLOCK_Q,
                            block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Blockwise backward: (qkv [B, T, 3D], the forward's out [B, T, D] and
    lse [B, H, T], dO [B, T, D]) → dqkv [B, T, 3D] in qkv's dtype, at any
    T. The dq kernel also computes dvec = rowsum(dO ⊙ O) for its rows, and
    the dK/dV kernel reads it. JAX's ``block_q``/``block_k`` are accepted
    (any positive sizes) and the kernels keep their own tiles: p is rebuilt
    elementwise from the forward's LSE, so JAX's tiles set only the order
    of its fp32 sums, not a rounding point. bf16 launches
    ``csrc/attention_flash.cu``'s kernels, fp32 (qkv, out and dO all fp32)
    the two of ``csrc/attention_bwd_f32.cu`` in their form with the
    statistics given (``LAUNCHES_FLASH_BWD_F32``)."""
    global LAUNCHES_FLASH_BWD, LAUNCHES_FLASH_BWD_F32
    b, t, three_d = qkv.shape
    d = num_heads * head_dim
    if (three_d != 3 * d or tuple(do.shape) != (b, t, d)
            or tuple(out.shape) != (b, t, d)
            or tuple(lse.shape) != (b, num_heads, t)):
        raise ValueError(
            f"qkv {tuple(qkv.shape)}, out {tuple(out.shape)}, lse "
            f"{tuple(lse.shape)} and dO {tuple(do.shape)} do not fit "
            f"{num_heads} heads of {head_dim}")
    _check_blocks(block_q, block_k)
    if not qkv.is_cuda:
        return blockwise_attention_bwd_reference(qkv, out, lse, do, num_heads,
                                                 head_dim)
    if (qkv.dtype not in _build.DTYPE_CODES
            or any(z.dtype != qkv.dtype for z in (out, do))):
        raise NotImplementedError(
            f"the CUDA blockwise attention backward takes bf16 or fp32 qkv, "
            f"out and dO of one dtype, got {qkv.dtype}, {out.dtype} and "
            f"{do.dtype}")
    if head_dim % 8 or head_dim > 128:
        raise NotImplementedError(
            f"head_dim {head_dim}: the kernel takes multiples of 8 up to 128")
    for z, name in ((qkv, "qkv"), (out, "out"), (do, "do")):
        _build.require(z, name, device=qkv.device, dtypes=(qkv.dtype,))
    _build.require(lse, "lse", device=qkv.device, dtypes=(torch.float32,))
    dqkv = torch.empty((b, t, 3 * d), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or t == 0:
        return dqkv
    if qkv.dtype == torch.float32:
        # Each row's (lse, dvec), written by the dq kernel for the dK/dV one.
        stats = torch.empty((b, num_heads, _stats_rows(t), 2), dtype=torch.float32,
                            device=qkv.device)
        err = _build.launch("vit_flash_attention_bwd_f32", qkv,
            qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), do.data_ptr(),
            dqkv.data_ptr(), stats.data_ptr(), b, t, num_heads, head_dim,
            _flash_scale(head_dim))
        _build.check_launch(err, "blockwise_attention_bwd (fp32)")
        LAUNCHES_FLASH_BWD_F32 += 1
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
    unscaled q, fp32 products; dqkv in ``out_dtype`` (default qkv's). Under
    ``softmax_identity`` p is the stand-in's second output, the fp32 scores
    s themselves, as JAX's ``fake_head`` returns them."""
    b, t, _ = qkv.shape
    q, k, v = _split_heads(qkv, 3, num_heads, head_dim)
    doh = _split_heads(do, 1, num_heads, head_dim)[0]
    scale = float(1.0 / np.sqrt(head_dim))
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = qs.float() @ k.float().transpose(-1, -2)
    if substitutions.SOFTMAX_IDENTITY:
        p = s
    else:
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
    (as the JAX function: the kernels stream q, k, v and dO tiles). qkv and
    dO both bf16 (``csrc/attention_bwd.cu``) or both fp32
    (``csrc/attention_bwd_f32.cu``, ``LAUNCHES_BWD_F32``)."""
    global LAUNCHES_BWD, LAUNCHES_BWD_F32
    b, t, three_d = qkv.shape
    d = num_heads * head_dim
    if three_d != 3 * d or tuple(do.shape) != (b, t, d):
        raise ValueError(f"qkv {tuple(qkv.shape)} and dO {tuple(do.shape)} do "
                         f"not fit {num_heads} heads of {head_dim}")
    out_dtype = out_dtype or qkv.dtype
    if not qkv.is_cuda:
        return packed_attention_bwd_reference(qkv, do, num_heads, head_dim,
                                              out_dtype=out_dtype)
    if substitutions.SOFTMAX_IDENTITY:
        substitutions.refuse("packed_attention_bwd", "softmax_identity")
    if qkv.dtype != do.dtype or qkv.dtype not in _build.DTYPE_CODES:
        raise NotImplementedError(
            f"the CUDA attention backward takes bf16 or fp32 qkv and dO of one "
            f"dtype, got {qkv.dtype} and {do.dtype}")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in "
                        f"{tuple(_build.DTYPE_CODES)}")
    if head_dim % 8 or head_dim > 128:
        raise NotImplementedError(
            f"head_dim {head_dim}: the kernel takes multiples of 8 up to 128")
    _build.require(qkv, "qkv", device=qkv.device, dtypes=(qkv.dtype,))
    _build.require(do, "do", device=qkv.device, dtypes=(qkv.dtype,))
    out = torch.empty((b, t, 3 * d), dtype=out_dtype, device=qkv.device)
    if b == 0 or t == 0:
        return out
    stats = torch.empty((b, num_heads, _stats_rows(t), 4), dtype=torch.float32,
                        device=qkv.device)
    ds_scale = float(np.float32(1.0 / np.sqrt(head_dim)))
    if qkv.dtype == torch.float32:
        # In fp32 the q scale and the ds scale are the same float32 value.
        err = _build.launch("vit_packed_attention_bwd_f32", qkv,
            qkv.data_ptr(), do.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[out_dtype], stats.data_ptr(), b, t, num_heads,
            head_dim, ds_scale)
        _build.check_launch(err, "packed_attention_bwd (fp32)")
        LAUNCHES_BWD_F32 += 1
        return out
    q_scale = _single_pass_scale(head_dim, torch.bfloat16)
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

"""Ring attention: context parallelism with K/V rotating around the shards.

Counterpart of ``vit_with_opencl_tpu/ops/ring_attention.py``. Each shard of
the sequence holds its queries and, in turn, every shard's K/V block: at
each of n steps it attends to the block it holds, carrying online-softmax
statistics (running max m, running sum l, the rescaled accumulator), then
passes the block to its ring neighbour (``parallel/collectives.ppermute``).
After n steps every query has seen every key; the bytes moved equal one
all-gather, as neighbour transfers.

The JAX body runs per shard under ``shard_map``; here one process runs it
as a loop over the shards, each shard's tensors on its own device of the
mesh axis (``parallel/mesh.py``). The local step is either the einsum form
(scores materialised; padded keys REPLACED by MASK_VALUE) or the blockwise
kernel ``ops/attention.blockwise_ring_step`` (``csrc/attention_ring.cu``:
nothing [t_loc, t_loc]-shaped reaches device memory; padded keys get an
ADDED MASK_VALUE bias), both as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ViTConfig
from ..parallel import collectives
from . import attention

MASK_VALUE = attention.MASK_VALUE


def _pick_block(t_loc: int) -> int:
    """Largest standard flash block dividing the shard, else the whole shard
    as one (possibly ragged) block — small shards are one tile anyway."""
    for cand in (512, 256, 128):
        if t_loc % cand == 0:
            return cand
    return t_loc


def ring_attention_shard(
    q: Sequence[torch.Tensor],
    k: Sequence[torch.Tensor],
    v: Sequence[torch.Tensor],
    *,
    devices: Sequence[torch.device],
    scale: float,
    seq_len: Optional[int] = None,
    shard_tokens: Optional[int] = None,
    impl: str = "auto",
) -> list:
    """The ring body over the shards of one mesh axis.

    q, k, v: one [B, H, T_loc, hd] tensor per shard, shard j on
    ``devices[j]`` (JAX's body sees shard j's alone under ``axis_name``).
    ``seq_len`` masks global positions >= seq_len (padding added to make T
    divide the ring). Returns the attention output of each shard's queries.

    ``impl``: "blockwise" (each step's local attention through the carried
    kernel), "einsum" (scores materialised per step) or "auto" (blockwise
    for shards of >= 128 tokens, einsum below)."""
    n = len(devices)
    b, h, t_loc, hd = q[0].shape
    if shard_tokens is None:
        shard_tokens = t_loc
    if impl == "auto":
        impl = "blockwise" if t_loc >= 128 else "einsum"
    if impl not in ("blockwise", "einsum"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    scale = float(np.float32(scale))  # it multiplies fp32 scores
    if impl == "blockwise":
        return _ring_blockwise(q, k, v, devices=devices, scale=scale,
                               seq_len=seq_len, shard_tokens=shard_tokens)

    f32 = torch.float32
    m = [torch.full((b, h, t_loc, 1), -float("inf"), dtype=f32, device=d)
         for d in devices]
    l = [torch.zeros((b, h, t_loc, 1), dtype=f32, device=d) for d in devices]
    acc = [torch.zeros((b, h, t_loc, hd), dtype=f32, device=d) for d in devices]
    k_blk, v_blk = list(k), list(v)
    for step in range(n):
        for j in range(n):
            # Which shard this KV block came from (global position mask).
            src = (j - step) % n
            s = (q[j].float() @ k_blk[j].float().transpose(-1, -2)) * scale
            if seq_len is not None:
                kv_pos = (torch.arange(t_loc, device=s.device)
                          + src * shard_tokens)
                s = torch.where(kv_pos < seq_len, s, MASK_VALUE)
            m_next = torch.maximum(m[j], s.amax(-1, keepdim=True))
            alpha = torch.exp(m[j] - m_next)
            p = torch.exp(s - m_next)
            l[j] = alpha * l[j] + p.sum(-1, keepdim=True)
            acc[j] = acc[j] * alpha + (p.to(v_blk[j].dtype).float()
                                       @ v_blk[j].float())
            m[j] = m_next
        if step + 1 < n:  # the n-th rotation brings each block home: unused
            k_blk = collectives.ppermute(k_blk, devices)
            v_blk = collectives.ppermute(v_blk, devices)
    return [(a / torch.where(s == 0.0, 1.0, s)).to(q[0].dtype)
            for a, s in zip(acc, l)]


def _ring_blockwise(q, k, v, *, devices, scale, seq_len, shard_tokens) -> list:
    """The ring body with the blockwise local step (carried statistics)."""
    n = len(devices)
    b, h, t_loc, hd = q[0].shape
    nf = b * h
    block = _pick_block(t_loc)

    def flat(x):  # the kernel reads contiguous [n, t_loc, hd]
        return x.reshape(nf, t_loc, hd).contiguous()

    qf = [flat(x) for x in q]
    k_blk = [flat(x) for x in k]
    v_blk = [flat(x) for x in v]
    f32 = torch.float32
    m = [torch.full((nf, t_loc), -float("inf"), dtype=f32, device=d)
         for d in devices]
    l = [torch.zeros((nf, t_loc), dtype=f32, device=d) for d in devices]
    acc = [torch.zeros((nf, t_loc, hd), dtype=f32, device=d) for d in devices]
    for step in range(n):
        for j, dev in enumerate(devices):
            src = (j - step) % n
            bias = torch.zeros((1, t_loc), dtype=f32, device=dev)
            if seq_len is not None:
                # Live positions of the SOURCE shard: its global slice is
                # [src*shard_tokens, (src+1)*shard_tokens); ring padding sits
                # at the global tail, so validity is a per-shard prefix.
                valid = seq_len - src * shard_tokens
                bias[:, max(valid, 0):] = MASK_VALUE
            m[j], l[j], acc[j] = attention.blockwise_ring_step(
                qf[j], k_blk[j], v_blk[j], bias, m[j], l[j], acc[j],
                scale=scale, block_q=block, block_k=block)
        if step + 1 < n:
            k_blk = collectives.ppermute(k_blk, devices)
            v_blk = collectives.ppermute(v_blk, devices)
    out = []
    for a, s in zip(acc, l):
        s = torch.where(s == 0.0, 1.0, s)
        out.append((a / s[..., None]).reshape(b, h, t_loc, hd).to(q[0].dtype))
    return out


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    config: ViTConfig,
    mesh,
    *,
    axis_name: str = "model",
    impl: str = "auto",
) -> torch.Tensor:
    """Full [B, H, T, hd] in, ring-sharded compute over the devices along
    ``axis_name`` of ``mesh`` (index 0 on any other axis), the output
    gathered on the first of them.

    Pads T to divide the ring, shards the sequence axis, runs the ring and
    slices the padding off. For long-context use keep activations sharded
    and call ``ring_attention_shard`` instead."""
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    b, h, t, hd = q.shape
    t_pad = -(-t // n) * n
    if t_pad != t:
        pad = (0, 0, 0, t_pad - t)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    t_loc = t_pad // n

    def shards(x):
        return [x[:, :, j * t_loc:(j + 1) * t_loc].to(dev)
                for j, dev in enumerate(devices)]

    out = ring_attention_shard(
        shards(q), shards(k), shards(v), devices=devices,
        scale=float(1.0 / np.sqrt(config.head_dim)), seq_len=t,
        shard_tokens=t_loc, impl=impl)
    full = torch.cat([o.to(devices[0]) for o in out], dim=2)
    return full[:, :, :t] if t_pad != t else full

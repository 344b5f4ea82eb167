"""The Hopper attention kernels' host-side geometry (shared memory, the
backward's statistics buffer, the packed route's decision), and the plain versions
they are held to on the card against the JAX package at their tile edges:
T about the 64-row tiles and the 256-key single pass, head dims below one
64-column box and across two; the single-pass attention's key count about
the one-pass limit (256 and 257 keys of 264) on slab and per-head packing,
and the blockwise forward at T = 1153 (one key past 9 whole 128-key tiles)
and hd 80, with and without a key count that leaves whole tiles masked.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu.ops import attention as jattn
from vit_with_opencl_tpu_torch import config as tconfig
from vit_with_opencl_tpu_torch.ops import attention

# bf16: the same rounding points on both sides, most outputs bit-identical
# (the thresholds of tests/test_torch_train_ops.py and test_torch_ops.py).
BF16_REL = 2e-2
MIN_SAME = 0.99
MIN_SAME_ATTN_BWD = 0.9
EDGE_TS = (1, 16, 17, 63, 64, 65, 197, 255, 256, 257, 577, 848, 1025)


def _pair(shape, seed, std=1.0):
    a = np.random.default_rng(seed).normal(0, std, shape).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)


def _close(got, want, min_same):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(g - w).max()) <= BF16_REL * scale
    assert float((g == w).mean()) >= min_same


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_kernels_shared_memory_fits_a_block_at_every_head_dim(hd):
    """Both kernels stream their K/V (or q/dO) tiles, so their shared memory
    depends on the head dim alone, and fits one block at every head dim the
    route sends them (multiples of 8 up to 128)."""
    assert attention.packed_kernel_smem_bytes(hd) <= attention.MAX_SMEM_BYTES
    assert attention.kernel_bwd_smem_bytes(hd) <= attention.MAX_SMEM_BYTES
    for cfg in tconfig.PRESETS.values():
        assert attention.packed_kernel_smem_bytes(cfg.head_dim) <= attention.MAX_SMEM_BYTES


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_blockwise_kernel_shared_memory_fits_a_block_at_every_head_dim(hd):
    """The blockwise forward's ring of 128-key K/V tile pairs depends on the
    head dim alone and fits one block at every head dim it takes."""
    assert attention.blockwise_kernel_smem_bytes(hd) <= attention.MAX_SMEM_BYTES
    # Six stages up to one 64-column box, three past it: at least three.
    assert attention.blockwise_kernel_smem_bytes(hd) >= 3 * 2 * 2 * 8192


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_blockwise_bwd_kernels_shared_memory_fits_a_block_at_every_head_dim(hd):
    """The blockwise backward's dq kernel (a ring of K/V tile pairs) and its
    dK/dV kernel (resident K/V tiles, a ring of q/dO tile pairs with their
    rows' lse and dvec) depend on the head dim alone and fit one block at
    every head dim they take."""
    smem = attention.blockwise_bwd_kernel_smem_bytes(hd)
    assert smem <= attention.MAX_SMEM_BYTES
    # Four stages of two tiles and the consumers' K and V at least.
    assert smem >= 1024 + 4 * 2 * attention._tile_bytes(hd) + 4 * attention._tile_bytes(hd)


def test_route_boundary_is_unchanged():
    """The packed route ends where JAX's one-shot route does, at padded T =
    1024: the packed kernel (slab entry) takes every T up to it at every head
    dim, the 849-1024 window of its first form included, and the blockwise
    kernel every T past it."""
    bf = torch.bfloat16
    for hd in (64, 128):
        for t in (1, 432, 433, 848, 849, 900, 1024):
            assert attention._packed_route(t, "slab", t, bf) == "packed"
        assert attention._packed_route(1025, "slab", 1025, bf) == "blockwise"


# (T, packing, true_seq_len, route on the card for bf16 and for fp32).
ROUTES = [
    (197, "slab", None, "packed", "packed"),
    (900, "slab", None, "packed", "packed"),
    (1024, "slab", None, "packed", "packed"),
    (1000, "slab", 1000, "packed", "packed"),
    (200, "slab", 197, "packed_kv", "single_pass"),
    (1024, "slab", 1001, "packed_kv", "single_pass"),
    (197, "per_head", None, "packed_kv", "single_pass"),
    (200, "per_head", 197, "packed_kv", "single_pass"),
    (1024, "per_head", None, "packed_kv", "single_pass"),
    (1025, "slab", None, "blockwise", "blockwise"),
    (1028, "slab", 1025, "blockwise", "blockwise"),
]


@pytest.mark.parametrize("t,packing,seq,bf16_route,f32_route", ROUTES)
def test_packed_route_decision(t, packing, seq, bf16_route, f32_route):
    """``packed_fused_attention``'s route as JAX's ``_packed_kernel`` draws
    it: up to padded T = 1024 the packed kernel, by its slab entry over every
    key and by its key-count entry for per-head packing or
    ``true_seq_len``; past it the blockwise kernel. The packed kernel takes
    bf16, so fp32 with a key count or per-head packing takes the
    single-pass attention's fp32 kernel."""
    keys = attention._packed_checks(t, packing, seq)
    assert keys == (t if seq is None else seq)
    assert attention._packed_route(t, packing, keys, torch.bfloat16) == bf16_route
    assert attention._packed_route(t, packing, keys, torch.float32) == f32_route


@pytest.mark.parametrize("t", EDGE_TS)
def test_stats_rows_are_whole_tiles(t):
    """The dK/dV kernel copies each 64-query tile's statistics whole (16
    bytes a row), so every (image, head) block of the buffer covers T in
    whole tiles, and no more than one tile past T."""
    rows = attention._stats_rows(t)
    assert rows % attention.KERNEL_ROWS == 0 and t <= rows < t + attention.KERNEL_ROWS


@pytest.mark.parametrize("t,hd", [(1, 16), (65, 80), (257, 104), (256, 128)])
def test_packed_attention_plain_matches_jax_at_tile_edges(t, hd):
    nh = 2
    tq, jq = _pair((1, t, 3 * nh * hd), t)
    want = jattn.packed_fused_attention(jq, num_heads=nh, head_dim=hd, interpret=True)
    got = attention.packed_fused_attention(tq, num_heads=nh, head_dim=hd)
    _close(got, want, MIN_SAME)


@pytest.mark.parametrize("t,hd", [(1, 16), (65, 80), (257, 104)])
def test_packed_attention_bwd_plain_matches_jax_at_tile_edges(t, hd):
    nh = 2
    tq, jq = _pair((1, t, 3 * nh * hd), t + 1)
    td, jd = _pair((1, t, nh * hd), t + 2)
    want = jattn.packed_attention_bwd(jq, jd, nh, hd)
    got = attention.packed_attention_bwd(tq, td, nh, hd)
    _close(got, want, MIN_SAME_ATTN_BWD)


@pytest.mark.parametrize("packing", ["slab", "per_head"])
@pytest.mark.parametrize("kv_len,hd", [(256, 64), (257, 64), (257, 80)])
def test_single_pass_plain_matches_jax_about_the_one_pass_limit(packing, kv_len, hd):
    """``single_pass_attention_reference`` with a key count at the kernel's
    one-pass limit (256 keys) and one past it (two passes), on strided views
    of the packed slabs, against JAX's ``_packed_kernel`` with
    ``true_seq_len``; the port's packed route gives the same values."""
    nh, t = 2, 264
    tq, jq = _pair((1, t, 3 * nh * hd), kv_len + hd)
    want = jattn.packed_fused_attention(jq, num_heads=nh, head_dim=hd, packing=packing,
                                        true_seq_len=kv_len, interpret=True)
    q, k, v = attention._packed_heads(tq, nh, hd, packing)
    got = attention.single_pass_attention_reference(q, k, v, hd, kv_len=kv_len)
    _close(got.permute(0, 2, 1, 3).reshape(1, t, nh * hd), want, MIN_SAME)
    packed = attention.packed_fused_attention(tq, num_heads=nh, head_dim=hd,
                                              packing=packing, true_seq_len=kv_len)
    assert torch.equal(packed, got.permute(0, 2, 1, 3).reshape(1, t, nh * hd))


@pytest.mark.parametrize("kv_len", [1153, 700])
def test_blockwise_plain_matches_jax_at_t_1153_hd_80(kv_len):
    """``blockwise_attention_fwd_reference`` at T = 1153 (a last 128-key
    tile of one key) and ViT-H/14's hd 80 (a second column box of 16), with
    and without a key count that masks whole tiles, against JAX's
    ``_blockwise_fwd_flat`` (the route JAX's packed and trainable attention
    take there): the output and each row's log-sum-exp."""
    nh, hd, t = 2, 80, 1153
    tq, jq = _pair((1, t, 3 * nh * hd), kv_len)
    t_pad = -(-t // 128) * 128
    pad = ((0, 0), (0, t_pad - t), (0, 0))
    qf, kf, vf = (jnp.pad(x, pad) for x in jattn._packed_split(jq, nh, hd))
    of, lse = jattn._blockwise_fwd_flat(
        qf, kf, vf, scale=float(1.0 / np.sqrt(hd)), seq_len=kv_len, block_q=128,
        block_k=128, interpret=True, return_lse=True)
    want = jattn._packed_merge(of[:, :t], 1, nh, hd)
    got, got_lse = attention.blockwise_attention_fwd_reference(
        tq, nh, hd, return_lse=True, kv_len=kv_len)
    _close(got, want, MIN_SAME)
    want_lse = np.asarray(lse).reshape(1, nh, t_pad)[:, :, :t]
    scale = float(np.abs(want_lse).max())
    assert float(np.abs(got_lse.numpy() - want_lse).max()) <= 1e-5 * scale

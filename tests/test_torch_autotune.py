"""The port's autotune slice against the JAX package's, on the CPU.

The blockwise forward's key tile (``block_k``) is the port's one tunable
knob: its plain version (slabs and split heads, with and without the
log-sum-exp) against JAX's ``_blockwise_fwd_flat`` in interpret mode at
JAX's ``(block_q, block_k)`` sweep pairs past T = 1024, through
``packed_fused_attention`` and ``flash_attention``; the backward with JAX's
tiles; a chain at ``block_k`` 256 against its plain chain and against the
chain at 128. Then ``perf/autotune`` mirrors JAX's tests/test_perf.py
(sweep mechanics, the cache round trip, engines and the Trainer consuming a
saved entry, overrides, another device and a bad cache, the quant key and
its tagged fallback, points budgets, write-through), JAX's ``tuning_key``
strings, the contract of tests/test_perf.py:288 (which JAX's own
``tune_and_save`` fails: a default sweep here replaces a stale entry), and
JAX's grid knobs refused by name.

On the CPU every wrapper computes its plain version and the sweeps time
those (or a stub timer's numbers); no kernel launches.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu import config as jconfig
from vit_with_opencl_tpu.ops import attention as jattn
from vit_with_opencl_tpu.perf import autotune as jautotune
from vit_with_opencl_tpu_torch import ViTConfig, data, get_config
from vit_with_opencl_tpu_torch.engine import InferenceEngine
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.models import golden, vit
from vit_with_opencl_tpu_torch.ops import attention, fused_block
from vit_with_opencl_tpu_torch.parallel import spmd
from vit_with_opencl_tpu_torch.perf import autotune
from vit_with_opencl_tpu_torch.train import Trainer

NH, HD = 2, 64
T = 1025  # ViT-L/16@512's token count, past SINGLE_PASS_MAX_T
# JAX's sweep pairs whose block_k is not its default (autotune.py:315-318).
BLOCK_PAIRS = [(128, 256), (256, 256), (128, 512), (512, 256)]
# fp32 on both sides: the same arithmetic summed in another order.
F32_ATOL = 1e-5
# bf16 outputs round at the same points as JAX's (tests/test_torch_public_ops.py
# and test_torch_long_seq.py): a flipped rounding moves an element by one
# bf16 ulp at the output's scale.
BF16_REL = 2.0 ** -8
MIN_SAME = 0.99
LSE_REL = 1e-5
# The backward: fp32 sums of the same products in another order.
GRAD_REL = 1e-5

# A narrow config past 1024 tokens (128-pixel images at patch 4: 1025
# tokens; 2 heads of 8, depth 1), for the sweeps and the engine.
LONG = ViTConfig(name="tune_long", img_size=128, patch_size=4, embed_dim=16,
                 depth=1, num_heads=2, num_classes=5)
# And one at 17 tokens, where the blockwise knob is not swept.
SHORT = ViTConfig(name="tune_short", img_size=32, patch_size=8, embed_dim=32,
                  depth=1, num_heads=2, num_classes=5)
JSHORT = jconfig.ViTConfig(name="tune_short", img_size=32, patch_size=8,
                           embed_dim=32, depth=1, num_heads=2, num_classes=5)


def _rand(shape, seed, std=1.0):
    return np.random.default_rng(seed).normal(0, std, shape).astype(np.float32)


def _np(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _close(got, want, rel, min_same=None, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.abs(g - w).max())
    scale = max(float(np.abs(w).max()), 1e-30)
    same = float((g == w).mean())
    print(f"{what}: max abs err {err:.3e} (|want| up to {scale:.3e}), "
          f"{same:.2%} bit-identical")
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"
    if min_same is not None:
        assert same >= min_same, f"{what}: {same:.4f} < {min_same}"


def _jax_blockwise(a, jdt, bq, bk, return_lse):
    """JAX's packed long route at (bq, bk): split, padded to lcm(bq, bk),
    ``_blockwise_fwd_flat`` → (out [B, T, D], lse [B, H, T] or None)."""
    b, t = a.shape[:2]
    lcm = bq * bk // np.gcd(bq, bk)
    t_pad = -(-t // lcm) * lcm
    pad = ((0, 0), (0, t_pad - t), (0, 0))
    qf, kf, vf = (jnp.pad(x, pad) for x in
                  jattn._packed_split(jnp.asarray(a, jdt), NH, HD))
    of, lse = jattn._blockwise_fwd_flat(
        qf, kf, vf, scale=float(1.0 / np.sqrt(HD)), seq_len=t, block_q=bq,
        block_k=bk, interpret=True, return_lse=return_lse)
    out = jattn._packed_merge(of[:, :t], b, NH, HD)
    return out, (None if lse is None else lse.reshape(b, NH, t_pad)[:, :, :t])


# -- the blockwise forward at JAX's key tiles --------------------------------


@pytest.mark.parametrize("bq,bk", BLOCK_PAIRS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blockwise_forward_key_tiles_match_jax(bq, bk, dtype):
    """The slabs with and without the LSE, and ``packed_fused_attention``
    at (block_q, block_k), against ``_blockwise_fwd_flat`` at the same pair;
    and ``block_q`` moves nothing."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    a = _rand((1, T, 3 * NH * HD), bq + bk)
    jout, jlse = _jax_blockwise(a, jdt, bq, bk, True)
    tq = torch.from_numpy(a).to(tdt)
    out, lse = attention.blockwise_attention_fwd(tq, NH, HD, return_lse=True,
                                                 block_q=bq, block_k=bk)
    if dtype == "f32":
        np.testing.assert_allclose(_np(out), _np(jout), rtol=0, atol=F32_ATOL)
    else:
        _close(out, jout, BF16_REL, MIN_SAME, f"({bq}, {bk}) out")
    _close(lse, jlse, LSE_REL, what=f"({bq}, {bk}) lse")
    plain, none = attention.blockwise_attention_fwd(tq, NH, HD, block_k=bk)
    assert none is None and torch.equal(plain, out)
    packed = attention.packed_fused_attention(tq, num_heads=NH, head_dim=HD,
                                              block_q=bq, block_k=bk)
    assert torch.equal(packed, out)
    assert torch.equal(attention.packed_fused_attention_reference(
        tq, NH, HD, block_q=attention.DEFAULT_BLOCK_Q, block_k=bk), out)


@pytest.mark.parametrize("bq,bk", BLOCK_PAIRS)
def test_flash_attention_key_tiles_match_jax(bq, bk):
    """Split heads past T = 1024: ``flash_attention`` at (block_q, block_k)
    against JAX's ``flash_attention`` in interpret mode (its
    ``_blockwise_attention``), bf16."""
    from vit_with_opencl_tpu import ops as jops

    cfg = ViTConfig(name="h", img_size=32, patch_size=8, embed_dim=NH * HD,
                    depth=1, num_heads=NH)
    jcfg = jconfig.ViTConfig(name="h", img_size=32, patch_size=8,
                             embed_dim=NH * HD, depth=1, num_heads=NH)
    arrays = [_rand((1, NH, T, HD), 20 + i) for i in range(3)]
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in arrays)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in arrays)
    want = jops.flash_attention(jq, jk, jv, jcfg, block_q=bq, block_k=bk,
                                interpret=True)
    got = attention.flash_attention(q, k, v, cfg, block_q=bq, block_k=bk)
    _close(got, want, BF16_REL, MIN_SAME, f"flash_attention ({bq}, {bk})")
    before = attention.LAUNCHES_FLASH_SPLIT
    assert torch.equal(got, attention.flash_attention_reference(
        q, k, v, cfg, block_k=bk))
    assert attention.LAUNCHES_FLASH_SPLIT == before


def test_key_tile_is_part_of_the_function():
    """At T = 1025 the 256- and 512-key walks round p at other values than
    the 128-key one: the tile changes bf16 results (and so is a knob of the
    function, not only of speed), and block_q changes nothing."""
    a = torch.from_numpy(_rand((1, T, 3 * NH * HD), 9)).to(torch.bfloat16)
    outs = {bk: attention.blockwise_attention_fwd(a, NH, HD, block_k=bk)[0]
            for bk in attention.FLASH_BLOCK_KS}
    assert not torch.equal(outs[128], outs[256])
    assert not torch.equal(outs[256], outs[512])
    for bq in (64, 256, 512):
        assert torch.equal(attention.blockwise_attention_fwd(
            a, NH, HD, block_q=bq, block_k=256)[0], outs[256])
    with pytest.raises(ValueError, match="block_q"):
        attention.blockwise_attention_fwd(a, NH, HD, block_q=0)


@pytest.mark.parametrize("bk", [256, 512])
def test_blockwise_backward_with_jax_tiles_matches_jax(bk):
    """JAX's ``blockwise_attention_bwd`` at block_k 256 and 512 (fp32)
    against the port's backward, which accepts the tiles and keeps its own:
    p is rebuilt elementwise from the LSE, so a tile sets only the order of
    fp32 sums."""
    b = 1
    a = _rand((b, T, 3 * NH * HD), 30 + bk)
    do = _rand((b, T, NH * HD), 31 + bk)
    jout, _ = _jax_blockwise(a, jnp.float32, 128, bk, False)
    lcm = bk
    t_pad = -(-T // lcm) * lcm
    pad = ((0, 0), (0, t_pad - T), (0, 0))
    qf, kf, vf = (jnp.pad(x, pad) for x in
                  jattn._packed_split(jnp.asarray(a), NH, HD))
    of, lse_flat = jattn._blockwise_fwd_flat(
        qf, kf, vf, scale=float(1.0 / np.sqrt(HD)), seq_len=T, block_q=128,
        block_k=bk, interpret=True, return_lse=True)
    dof = jnp.pad(jnp.asarray(do).reshape(b, T, NH, HD).transpose(0, 2, 1, 3)
                  .reshape(b * NH, T, HD), pad)
    dq, dk, dv = jattn.blockwise_attention_bwd(
        qf, kf, vf, of, lse_flat, dof, scale=float(1.0 / np.sqrt(HD)),
        seq_len=T, block_q=128, block_k=bk, interpret=True)
    want = jnp.concatenate([jattn._packed_merge(x[:, :T], b, NH, HD)
                            for x in (dq, dk, dv)], axis=-1)
    tout = torch.from_numpy(_np(jout).copy())
    tlse = torch.from_numpy(_np(lse_flat.reshape(b, NH, t_pad)[:, :, :T]).copy())
    got = attention.blockwise_attention_bwd(torch.from_numpy(a), tout, tlse,
                                            torch.from_numpy(do), NH, HD,
                                            block_q=128, block_k=bk)
    _close(got, want, GRAD_REL, what=f"dqkv at block_k {bk}")
    assert torch.equal(got, attention.blockwise_attention_bwd(
        torch.from_numpy(a), tout, tlse, torch.from_numpy(do), NH, HD))


def test_chain_at_key_tile_256_matches_its_plain_chain():
    """``fused_encoder_layer`` and ``fused_encoder_stack`` at block_k 256
    on a bf16 layer at T = 1025 against their plain versions at 256 (the
    same links on the CPU, so the same bits), and against the chain at 128,
    which rounds p elsewhere."""
    cfg = ViTConfig(name="chain", img_size=128, patch_size=4, embed_dim=NH * HD,
                    depth=1, num_heads=NH, num_classes=5)
    named = fixtures.random_params(cfg, seed=5, scale=0.05)
    params = vit.stack_params(named, cfg, param_dtype=torch.bfloat16, device="cpu")
    lp = vit._layer(params, 0)
    x = torch.from_numpy(_rand((1, T, cfg.embed_dim), 6)).to(torch.bfloat16)
    got = fused_block.fused_encoder_layer(x, lp, cfg, block_k=256)
    assert torch.equal(got, fused_block.fused_encoder_layer_reference(
        x, lp, cfg, block_k=256))
    assert torch.equal(fused_block.fused_encoder_stack(
        x, params["layers"], cfg, block_k=256), fused_block.fused_encoder_stack_reference(
        x, params["layers"], cfg, block_k=256))
    assert torch.equal(fused_block.fused_encoder_group(
        x, params["layers"], cfg, group_size=1, block_k=256), got)
    assert not torch.equal(got, fused_block.fused_encoder_layer(x, lp, cfg))


# -- perf/autotune against JAX's tests/test_perf.py -------------------------


def test_tuning_key_is_jax_string():
    for batch, (tdt, jdt), quant in ((4, (torch.float32, jnp.float32), None),
                                     (16, (torch.bfloat16, jnp.bfloat16), None),
                                     (256, (torch.bfloat16, jnp.bfloat16), "int8-w8a8"),
                                     (8, (torch.float32, jnp.float32), "train")):
        assert (autotune.tuning_key(SHORT, batch, tdt, quant)
                == jautotune.tuning_key(JSHORT, batch, jdt, quant))
    assert autotune.tuning_key(SHORT, 4, "bfloat16") == "tune_short|b4|bfloat16"


def test_autotune_sweep_mechanics(capsys):
    """tests/test_perf.py:39: candidate 4 wins, candidate 8 fails to build
    and is recorded as inf (and printed)."""
    def build(c):
        if c == 8:
            raise RuntimeError("out of shared memory")
        return lambda x: x * c

    def timer(fn, args, iters):
        return abs(fn(1.0) - 4.0) + 0.1

    best, table = autotune.sweep((1, 2, 4, 8), build, (), timer=timer)
    assert best == 4 and table[8] == float("inf")
    assert "candidate 8 failed" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune.sweep((8,), build, (), timer=timer)


def test_autotune_cache_roundtrip(tmp_path):
    """tests/test_perf.py:75."""
    p = tmp_path / "tune.json"
    autotune.save_tuning(p, "vit_b/256/bf16", {"blockwise_block_k": 256, "ms": 1.9})
    autotune.save_tuning(p, "vit_l/64/bf16", {"blockwise_block_k": 512, "ms": 4.4})
    assert autotune.load_tuning(p, "vit_b/256/bf16") == {"blockwise_block_k": 256,
                                                        "ms": 1.9}
    assert autotune.load_tuning(p, "missing") is None
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tuning_")]


def test_time_fn_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    ms = autotune.time_fn(fn, (torch.zeros(4),), iters=2)
    assert ms >= 0 and len(calls) == 1 + 3 * 2


def _first_wins():
    calls = []

    def timer(fn, args, iters):
        out = fn(*args)
        assert torch.isfinite(out).all()
        calls.append(1)
        return float(len(calls))
    return timer, calls


def test_tune_blockwise_blocks_on_the_cpu():
    """JAX's ``tune_blockwise_blocks`` mechanics (tests/test_perf.py:327):
    the key tiles up to T, the table keyed by block_k, each candidate's
    forward finite; none past a short T."""
    timer, calls = _first_wins()
    bk, table = autotune.tune_blockwise_blocks(
        1025, 8, batch_heads=2, dtype=torch.float32, iters=1, timer=timer,
        device="cpu")
    assert bk == 128 and set(table) == {128, 256, 512} and len(calls) == 3
    bk, table = autotune.tune_blockwise_blocks(
        300, 8, batch_heads=1, dtype=torch.float32, iters=1, timer=timer,
        device="cpu")
    assert set(table) == {128, 256}


def test_seeded_inputs_are_jax_pattern():
    """The sweep's inputs: JAX's ``mk`` pattern, int32 wrap-around included
    (past 44,488 elements the product overflows)."""
    import jax

    n = 50_000
    i = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    want = (((i * 48271 + 3) % 1021).astype(jnp.float32) / 1021.0 - 0.5)
    got = autotune._seeded((n,), 3, torch.float32, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tune_and_save_then_engine_consumes(tmp_path):
    """tests/test_perf.py:85: the sweep saves the winner; the engine looks
    it up at start-up and binds its kernel table to it; its answers are the
    golden model's."""
    path = tmp_path / "tuning.json"
    timer, _ = _first_wins()
    result = autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                                    timer=timer, device="cpu")
    assert result["blockwise_block_k"] == 128 and result["device"] == "cpu"
    assert set(result["blockwise_table_ms"]) == {"128", "256", "512"}
    saved = autotune.lookup(LONG, 1, torch.float32, path=path, device="cpu")
    assert saved["blockwise_block_k"] == 128
    assert autotune.lookup(LONG, 999, torch.float32, path=path, device="cpu") == {}
    # The engine runs the entry's tile, here a hand-set 512.
    autotune.save_tuning(path, autotune.tuning_key(LONG, 1, torch.float32),
                         {**saved, "blockwise_block_k": 512})
    named = fixtures.random_params(LONG, seed=1, scale=0.05)
    images = fixtures.random_images(LONG, n=1, seed=2)
    eng = InferenceEngine(LONG, named, batch_size=1, param_dtype=torch.float32,
                          compute_dtype=torch.float32, attention_impl="flash",
                          device="cpu", tuning_path=str(path))
    assert eng.tuning["blockwise_block_k"] == 512
    assert eng.kernels["blockwise_block_k"] == 512
    ref = golden.golden_forward(images, named, LONG)
    np.testing.assert_allclose(eng.run(images), ref, atol=1e-5)
    # A short config has nothing to sweep: the entry is the device alone.
    short = autotune.tune_and_save(SHORT, 1, dtype=torch.float32, path=path,
                                   timer=timer, device="cpu")
    assert "blockwise_block_k" not in short and short["device"] == "cpu"


def test_resolve_kernels_tuning_override():
    """tests/test_perf.py:126 on the port's knob: blockwise_block_k (and
    blockwise_block_q) bind the attention_packed slot and the chains'; no
    tuning leaves the raw function; bookkeeping keys are ignored."""
    kern = vit.resolve_kernels("flash", tuning={
        "blockwise_block_q": 256, "blockwise_block_k": 512, "device": "cpu",
        "timestamp": "now", "blockwise_table_ms": {"512": 1.0},
        "fallback_from": "x|b1|float32"})
    assert kern["attention_packed"].keywords == {"block_q": 256, "block_k": 512}
    assert kern["blockwise_block_k"] == 512
    default = vit.resolve_kernels("flash", tuning={"device": "cpu"})
    assert not hasattr(default["attention_packed"], "keywords")
    assert "blockwise_block_k" not in default
    assert vit.resolve_kernels("xla", tuning={"blockwise_block_k": 256}).keys() == \
        vit.resolve_kernels("xla").keys()


@pytest.mark.parametrize("knob", vit.GRID_KNOBS)
def test_grid_knobs_are_refused_by_name(knob, tmp_path):
    """JAX's grid knobs mean nothing on the persistent grid: resolve_kernels,
    make_train_step and tune_and_save (its sweeps of them) name them."""
    with pytest.raises(ValueError, match=knob):
        vit.resolve_kernels("flash", tuning={knob: 2})
    with pytest.raises(ValueError, match=knob):
        spmd.make_train_step(SHORT, device="cpu", tuning={knob: 2})
    sweep_name = {"attention_ipc": "attention", "attention_bwd_ipc": "attention_bwd",
                  "attention_ragged": "ragged", "fused_block_ipc": "ipc",
                  "fused_stack_ipc": "ipc"}[knob]
    with pytest.raises(ValueError, match=sweep_name):
        autotune.tune_and_save(SHORT, 1, path=tmp_path / "t.json",
                               knobs=[sweep_name], device="cpu")


def test_lookup_ignores_other_device_and_bad_cache(tmp_path):
    """tests/test_perf.py:185: an entry recorded on another device is
    ignored; an untagged one is honoured; a foreign file never raises."""
    path = tmp_path / "tuning.json"
    key = autotune.tuning_key(SHORT, 4, torch.float32)
    autotune.save_tuning(path, key, {"blockwise_block_k": 256,
                                     "device": "NVIDIA H100 80GB HBM3"})
    assert autotune.lookup(SHORT, 4, torch.float32, path=path, device="cpu") == {}
    autotune.save_tuning(path, key, {"blockwise_block_k": 256})
    assert autotune.lookup(SHORT, 4, torch.float32, path=path,
                           device="cpu")["blockwise_block_k"] == 256
    path.write_text(json.dumps([1, 2, 3]))
    assert autotune.lookup(SHORT, 4, torch.float32, path=path, device="cpu") == {}
    path.write_text("{truncated")
    assert autotune.lookup(SHORT, 4, torch.float32, path=path, device="cpu") == {}


def test_quant_tuning_key_and_fallback(tmp_path):
    """tests/test_perf.py:207: a W8A8 engine has its own key; without an
    entry there, the bf16 entry is its fallback; the unquantized engine
    never sees the quant entry."""
    path = tmp_path / "tuning.json"
    base = autotune.tuning_key(SHORT, 4, torch.float32)
    qkey = autotune.tuning_key(SHORT, 4, torch.float32, quant="int8-w8a8")
    assert qkey != base and qkey.endswith("|int8-w8a8")
    autotune.save_tuning(path, base, {"blockwise_block_k": 256})
    assert autotune.lookup(SHORT, 4, torch.float32, path=path, quant="int8-w8a8",
                           device="cpu")["blockwise_block_k"] == 256
    autotune.save_tuning(path, qkey, {"blockwise_block_k": 512})
    assert autotune.lookup(SHORT, 4, torch.float32, path=path, quant="int8-w8a8",
                           device="cpu")["blockwise_block_k"] == 512
    assert autotune.lookup(SHORT, 4, torch.float32, path=path,
                           device="cpu")["blockwise_block_k"] == 256


def test_lookup_fallback_is_tagged(tmp_path):
    """tests/test_perf.py:506: the fallback carries ``fallback_from``, never
    written back; a real quant entry carries none."""
    path = tmp_path / "tuning.json"
    base = autotune.tuning_key(SHORT, 4, torch.float32)
    autotune.save_tuning(path, base, {"blockwise_block_k": 256})
    got = autotune.lookup(SHORT, 4, torch.float32, path=path, quant="int8-w8a8",
                          device="cpu")
    assert got["fallback_from"] == base
    assert "fallback_from" not in autotune.load_tuning(path, base)
    qkey = autotune.tuning_key(SHORT, 4, torch.float32, quant="int8-w8a8")
    autotune.save_tuning(path, qkey, {"blockwise_block_k": 512})
    got = autotune.lookup(SHORT, 4, torch.float32, path=path, quant="int8-w8a8",
                          device="cpu")
    assert got["blockwise_block_k"] == 512 and "fallback_from" not in got


def test_tune_and_save_default_replaces_and_restricted_merges(tmp_path):
    """The contract of tests/test_perf.py:288, which JAX's own
    ``tune_and_save`` fails (its inference default counts as partial): a
    restricted sweep (no knobs, or a points budget) merges into the saved
    same-device entry; a default sweep replaces it, clearing a stale knob;
    unknown knobs raise."""
    path = tmp_path / "tuning.json"
    timer = lambda fn, args, iters: 1.0  # noqa: E731
    key = autotune.tuning_key(LONG, 1, torch.float32)
    autotune.save_tuning(path, key, {"stale_knob": True, "device": "cpu"})
    merged = autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                                    timer=timer, knobs=[], device="cpu")
    assert merged["stale_knob"] is True and "blockwise_block_k" not in merged
    merged = autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                                    timer=timer, points=5, device="cpu")
    assert merged["stale_knob"] is True and merged["blockwise_block_k"] == 128
    full = autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                                  timer=timer, device="cpu")
    assert "stale_knob" not in full and full["blockwise_block_k"] == 128
    assert "stale_knob" not in autotune.lookup(LONG, 1, torch.float32, path=path,
                                               device="cpu")
    with pytest.raises(ValueError, match="unknown knobs"):
        autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                               timer=timer, knobs=["bogus"], device="cpu")


def test_tune_and_save_points_accumulates(tmp_path):
    """tests/test_perf.py:395: each run measures at most ``points`` new
    candidates and writes the winner only once the table is whole."""
    path = tmp_path / "tuning.json"
    measured = []

    def timer(fn, args, iters):
        measured.append(1)
        return float(len(measured))

    r1 = autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                                timer=timer, points=2, device="cpu")
    assert len(measured) == 2 and "blockwise_block_k" not in r1
    assert len(r1["blockwise_table_ms"]) == 2
    assert "blockwise_block_k" not in autotune.lookup(LONG, 1, torch.float32,
                                                      path=path, device="cpu")
    r2 = autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                                timer=timer, points=2, device="cpu")
    assert len(measured) == 3 and r2["blockwise_block_k"] == 128
    r3 = autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                                timer=timer, points=5, device="cpu")
    assert len(measured) == 3 and r3["blockwise_block_k"] == 128
    with pytest.raises(ValueError, match="points"):
        autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                               timer=timer, points=0, device="cpu")


def test_sweep_write_through_survives_kill(tmp_path):
    """tests/test_perf.py:444: a run killed at its second candidate keeps
    the first on disk, with no winner; a resumed run skips it."""
    path = tmp_path / "tuning.json"
    calls = []

    def dying(fn, args, iters):
        calls.append(1)
        if len(calls) >= 2:
            raise KeyboardInterrupt("killed mid-sweep")
        return 1.0

    with pytest.raises(KeyboardInterrupt):
        autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                               timer=dying, points=3, device="cpu")
    entry = autotune.lookup(LONG, 1, torch.float32, path=path, device="cpu")
    assert len(entry["blockwise_table_ms"]) == 1 and "blockwise_block_k" not in entry
    r = autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                               timer=lambda fn, args, iters: 1.0, points=3,
                               device="cpu")
    assert len(r["blockwise_table_ms"]) == 3 and "blockwise_block_k" in r


def test_tune_and_save_train_entry(tmp_path):
    """tests/test_perf.py:625: the ``train`` key, and a train lookup at
    another batch falls back to the inference entry, tagged."""
    path = tmp_path / "tuning.json"
    timer, _ = _first_wins()
    result = autotune.tune_and_save(LONG, 1, dtype=torch.float32, path=path,
                                    timer=timer, quant="train", device="cpu")
    saved = autotune.lookup(LONG, 1, torch.float32, path=path, quant="train",
                            device="cpu")
    assert saved["blockwise_block_k"] == result["blockwise_block_k"]
    autotune.save_tuning(path, autotune.tuning_key(LONG, 8, torch.float32),
                         {"blockwise_block_k": 256, "device": "cpu"})
    fb = autotune.lookup(LONG, 8, torch.float32, path=path, quant="train",
                         device="cpu")
    assert fb["blockwise_block_k"] == 256 and "fallback_from" in fb


def test_tune_and_save_needs_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.tune_and_save(LONG, 1, path=tmp_path / "t.json")
    with pytest.raises(NotImplementedError, match="128 x 128"):
        autotune.tune_fused_linear_blocks(64, 48, 96)


def test_main_writes_the_entry(tmp_path, capsys):
    """The CLI: a preset at another resolution, the entry under its key."""
    out = tmp_path / "t.json"
    assert autotune.main(["--config", "vit_tiny_16_224", "--batch", "1",
                          "--dtype", "float32", "--out", str(out), "--knobs", "",
                          "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert list(printed) == ["vit_tiny_16_224|b1|float32"]
    resized = autotune._resized(get_config("vit_l_16_384"), 512)
    assert resized.name == "vit_l_16_512" and resized.num_tokens == 1025


def test_trainer_consumes_tuning_cache(tmp_path):
    """tests/test_train.py:484: Trainer(batch_size=) reads the cache's
    ``train`` entry; the training route keeps 128, so the tuned Trainer's
    losses equal the untuned one's."""
    path = str(tmp_path / "tuning.json")
    autotune.save_tuning(path, autotune.tuning_key(SHORT, 8, torch.float32, "train"),
                         {"blockwise_block_k": 256, "device": "cpu"})
    images = fixtures.random_images(SHORT, n=16, seed=5)
    labels = (np.arange(16) * 3) % SHORT.num_classes
    losses = {}
    for name, kw in (("tuned", dict(batch_size=8, tuning_path=path)),
                     ("default", dict(tuning_path=path))):
        tr = Trainer(SHORT, device="cpu", lr=1e-2, optimizer="sgd",
                     compute_dtype=torch.float32, attention_impl="flash",
                     log_every=0, seed=3, **kw)
        assert tr.tuning == ({"blockwise_block_k": 256, "device": "cpu"}
                             if name == "tuned" else {})
        tr.fit(data.memory_dataset(images, labels, 8, epochs=None, seed=4), steps=3)
        losses[name] = tr.last_loss
    assert losses["tuned"] == losses["default"]
